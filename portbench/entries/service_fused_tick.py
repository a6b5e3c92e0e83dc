"""Entry: one HorizontalAutoscaler fleet tick through karpenter_tpu_torch's
SolverService, the path the HA controller's BatchAutoscaler
(`fused_tick_fn=service.fused_tick`) and the sidecar take:
`SolverService.fused_tick` on host numpy operands (the door's series pad,
the tick as one captured CUDA graph, one fetch of every output leaf).

`call` hands the service one tick's operands (nested dicts of numpy
arrays) and returns every output leaf as nested dicts, each float32 leaf
as its int32 bit pattern with every NaN as one pattern (the reference's
`bits`), so the judge compares every bit. On the CPU (the benchmark's own
tests) the service's torch rung runs the same program eagerly.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.fleet_tick import bits


class Entry:
    def __init__(self, config: dict, device):
        import torch

        from karpenter_tpu_torch.solver.service import SolverService

        self.service = SolverService(device=device)
        self.backend = None if torch.device(device).type == "cuda" else "torch"

    def call(self, fields: dict) -> dict:
        out = self.service.fused_tick(fields, backend=self.backend)
        return {stage: {name: bits(x) if x.dtype == np.float32 else x
                        for name, x in leaves.items()}
                for stage, leaves in out.to_numpy().items()
                if leaves is not None}

    def counters(self) -> dict:
        """The service's stage timings (p50 / p99 ms over its rings), the
        fused tick's device spans in ms (the ring, oldest first) where the
        service keeps them, and the program's graph captures and
        replays."""
        service = self.service
        program = service.fused_program()
        out = {"stages": service.stage_percentiles(),
               "captures": program.captures, "replays": program.replays}
        samples = getattr(service, "stage_samples", None)
        if samples is not None:
            out["fused_device_ms"] = samples("fused_device")
        return out

    def close(self) -> None:
        self.service.close()
