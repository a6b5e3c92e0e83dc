"""The single-card fleet step (counterpart of the single-device half of
karpenter_tpu/parallel/mesh.py).

`fleet_step` is one tick of the whole control plane's device math: every
autoscaler's decision plus the global pending-pods bin-pack. On the card
the bin-pack half goes through `solve`, so the two CUDA kernels of
ops/fused_assign.py run on this path. The sharded half (a mesh over
several cards) is not ported yet.

`example_binpack_inputs` and `example_decision_inputs` draw the
reference's tiny seeded shapes (the ones its graft entry compile-checks)
from the same `np.random.default_rng` calls.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops.decision import DecisionInputs, DecisionOutputs, decide
from karpenter_tpu_torch.utils.device import DeviceLike, resolve_device


def fleet_step(
    decision_inputs: DecisionInputs,
    binpack_inputs: TB.BinPackInputs,
    buckets: int = TB.DEFAULT_BUCKETS,
    device: DeviceLike = None,
) -> Tuple[DecisionOutputs, TB.BinPackOutputs]:
    """decide + solve on one device (the card unless device='cpu'; the
    card's bin-pack runs the fused CUDA path)."""
    dev = resolve_device(device)
    return (
        decide(decision_inputs.to(dev)),
        TB.solve(binpack_inputs, buckets=buckets, device=dev),
    )


def example_binpack_inputs(
    P_: int = 32, T: int = 8, R: int = 3, K: int = 8, L: int = 8,
    seed: int = 0, device: DeviceLike = None,
) -> TB.BinPackInputs:
    rng = np.random.default_rng(seed)
    req = rng.uniform(0.1, 4.0, (P_, R)).astype(np.float32)
    alloc = rng.uniform(4.0, 16.0, (T, R)).astype(np.float32)
    intol = rng.random((P_, K)) < 0.2
    taints = rng.random((T, K)) < 0.2
    required = rng.random((P_, L)) < 0.15
    labels = rng.random((T, L)) < 0.7
    return TB.inputs_from_numpy(
        {
            "pod_requests": req,
            "pod_valid": np.ones((P_,), bool),
            "pod_intolerant": intol,
            "pod_required": required,
            "group_allocatable": alloc,
            "group_taints": taints,
            "group_labels": labels,
        },
        device,
    )


def example_decision_inputs(
    N: int = 16, M: int = 4, seed: int = 1, device: DeviceLike = None
) -> DecisionInputs:
    rng = np.random.default_rng(seed)
    fields = {
        "metric_value": rng.uniform(0.0, 100.0, (N, M)).astype(np.float32),
        "target_value": rng.uniform(1.0, 60.0, (N, M)).astype(np.float32),
        "target_type": rng.integers(0, 3, (N, M), dtype=np.int32),
        "metric_valid": rng.random((N, M)) < 0.8,
        "spec_replicas": rng.integers(0, 20, (N,), dtype=np.int32),
        "status_replicas": rng.integers(0, 20, (N,), dtype=np.int32),
        "min_replicas": rng.integers(0, 3, (N,), dtype=np.int32),
        "max_replicas": rng.integers(10, 40, (N,), dtype=np.int32),
        "up_window": np.zeros((N,), np.int32),
        "down_window": np.full((N,), 300, np.int32),
        "up_policy": np.zeros((N,), np.int32),
        "down_policy": np.zeros((N,), np.int32),
        "last_scale_time": rng.uniform(0.0, 100.0, (N,)).astype(np.float32),
        "has_last_scale": rng.random((N,)) < 0.5,
        "now": np.float32(250.0),
        # K = 2 policy slots, mixed Count/Percent, some invalid
        "up_ptype": rng.integers(0, 2, (N, 2), dtype=np.int32),
        "up_pvalue": rng.integers(1, 10, (N, 2), dtype=np.int32),
        "up_pperiod": rng.integers(30, 300, (N, 2), dtype=np.int32),
        "up_pvalid": rng.random((N, 2)) < 0.5,
        "down_ptype": rng.integers(0, 2, (N, 2), dtype=np.int32),
        "down_pvalue": rng.integers(1, 10, (N, 2), dtype=np.int32),
        "down_pperiod": rng.integers(30, 300, (N, 2), dtype=np.int32),
        "down_pvalid": rng.random((N, 2)) < 0.5,
    }
    return DecisionInputs.from_numpy(fields, device)
