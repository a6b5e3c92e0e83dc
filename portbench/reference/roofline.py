"""Operation and byte counts of the port's two bin-pack kernels, and the
card's peaks, frozen: the yardstick of the `<kernel>_roofline` metrics.

Copied from karpenter_tpu_torch/ops/fused_assign.py at commit fa3f937
(`shelf_ops`, `kernel_cost`). Edits: `kernel_cost` takes the operands as
numpy arrays and the packed word counts from K and L (ceil(K / 64), at
least 1, as `pack_bits` packs them) instead of packing them with the
program. The counts are applied to the reference's assignment and
histogram of the same operands (reference/binpack.py), so they read the
same work whatever implements it: each input byte read once, each output
byte written once, and each row's scan stopping at its first fit. As in
the original, a pod_group_forbidden operand's bytes are not counted: a
mix that sends one reads its share of the roofline low, never high.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM and 67 TFLOP/s of
float32 outside the tensor cores (the kernels compare and add in f32 and
int32), at the 700 W power limit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time a launch can take: the larger of its bytes at the
    HBM peak and its operations at the f32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def shelf_ops(hist: np.ndarray, buckets: int) -> int:
    """Integer steps the shelf algorithm takes on this histogram: each
    visit of a remnant slot (a min, a compare, two updates, a subtract) is
    counted as 5 operations, each size's bin opening as 10."""
    steps = 0
    for row in hist:
        bins = np.zeros(buckets + 1, np.int64)
        for k in range(buckets, 0, -1):
            c = int(row[k - 1])
            while c > 0:
                placed = False
                for rem in range(k, buckets + 1):
                    steps += 5
                    m = min(c, int(bins[rem]))
                    if m > 0:
                        bins[rem] -= m
                        bins[rem - k] += m
                        c -= m
                        placed = True
                    if c == 0:
                        break
                if not placed:
                    break
            if c > 0:
                steps += 10
                per_bin = buckets // k
                full, leftover = divmod(c, per_bin)
                bins[buckets - per_bin * k] += full
                if leftover > 0:
                    bins[buckets - leftover * k] += 1
    return steps


def kernel_cost(fields: Dict[str, np.ndarray], buckets: int,
                assigned: np.ndarray, hist: np.ndarray
                ) -> Dict[str, Tuple[int, int]]:
    """The analytic work of one launch of each kernel on these operands:
    {name: (operations, bytes)}, each input read once and each output
    written once. The fused kernel's scan visits a row's groups up to its
    first feasible one (all of them for a row with none; invalid rows
    none), each visit comparing R requests and the K + L mask words; an
    assigned row adds its bucket, histogram and demand updates."""
    pods, n_res = fields["pod_requests"].shape
    groups = fields["group_allocatable"].shape[0]
    kw = max(1, -(-fields["pod_intolerant"].shape[1] // 64))
    lw = max(1, -(-fields["pod_required"].shape[1] // 64))
    valid = np.asarray(fields["pod_valid"], bool)
    pairs = int(np.where(assigned >= 0, assigned + 1, groups)[valid].sum())
    fused_ops = pairs * (n_res + kw + lw) + int((assigned >= 0).sum()) * (
        3 * n_res + 6
    )
    fused_bytes = (
        pods * (4 * n_res + 1 + 8 * (kw + lw) + 4)  # rows in, assigned out
        + groups * (4 * n_res + 8 * (kw + lw))  # groups in
        + groups * (4 * buckets + 4 * n_res)  # hist, demand out
    )
    return {
        "fused_assign": (fused_ops, fused_bytes),
        "shelf_bfd": (shelf_ops(hist, buckets), groups * (4 * buckets + 4)),
    }
