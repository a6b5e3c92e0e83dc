"""Entry: a bin-pack solve through karpenter_tpu_torch's SolverService,
the path the sidecar's Solve takes (`SolverService.solve` on host numpy
operands: queue, the cuda rung's upload and two kernels, one fetch).

`call` hands the service a new BinPackInputs over the client's host
arrays and returns the five outputs as numpy arrays.
"""

from __future__ import annotations

import numpy as np

OUTPUTS = ("assigned", "assigned_count", "nodes_needed", "lp_bound",
           "unschedulable")


class Entry:
    def __init__(self, config: dict, device):
        from karpenter_tpu_torch.ops import binpack
        from karpenter_tpu_torch.solver.service import SolverService

        self._inputs = binpack.BinPackInputs
        self.buckets = int(config["buckets"])
        self.service = SolverService(device=device)

    def call(self, fields: dict) -> dict:
        out = self.service.solve(self._inputs(**fields), buckets=self.buckets)
        return {name: np.asarray(getattr(out, name)) for name in OUTPUTS}

    def counters(self) -> dict:
        """The service's stage timings (p50 / p99 ms over its rings)."""
        return {"stages": self.service.stage_percentiles()}

    def close(self) -> None:
        self.service.close()
