"""The fused assignment stage and the shelf-BFD tail as CUDA kernels
(counterpart of karpenter_tpu/ops/pallas_binpack.py).

`fused_assign` computes, in one pass over the pod rows, what the reference's
Pallas kernel computes per tile: feasibility, the assignment, the assigned
group's quantized bucket and the weighted [T, B] histogram and [T, R]
demand, plus the weighted unschedulable count (csrc/fused_assign.cu: a
block of 512 rows scans, sorts its rows by group and bucket and reduces
the runs; a second launch reduces demand across blocks). Its launch plan
(`fused_assign_plan`) is computed here, from the shapes alone. `shelf_bfd`
runs the shelf best-fit-decreasing node count, one warp per group, and
also returns each group's item count (csrc/shelf_bfd.cu). `binpack_fused`
composes them with the lp_bound tail, the counterpart of binpack_pallas.

Each wrapper launches its kernel for CUDA tensors, counts the launch in
LAUNCHES, and raises on any failure; for CPU tensors, and only for them, it
runs its plain PyTorch version (fused_assign_reference,
shelf_bfd_reference), which is also what the kernels are held against on
the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.ops.binpack import (
    BinPackInputs,
    BinPackOutputs,
    _row_weight,
    _shelf_bfd,
    has_constraint_operands,
    lp_bound_of,
    quantize_share,
    unschedulable_of,
    weighted_demand,
    weighted_histogram,
)

# kernel launches by wrapper; only the wrappers below add to it
LAUNCHES = {"fused_assign": 0, "shelf_bfd": 0}

# the largest dynamic shared memory one block may take on Hopper
_MAX_SHARED_BYTES = 232448
# stand-in for inf, as in the Pallas kernel: there the share is summed as
# member_f * share over the row, and 0 * inf would be NaN
_BIG = 3.4e38


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[N, K] -> int64[N, max(1, ceil(K / 64))]: bit j of word w is
    column 64 w + j (word 0 when K is 0). The sum of distinct powers of
    two is their OR, and no partial sum leaves int64's range."""
    n, k = bits.shape
    words = max(1, -(-k // 64))
    padded = torch.zeros((n, words * 64), dtype=torch.bool, device=bits.device)
    padded[:, :k] = bits
    shifts = torch.arange(64, dtype=torch.int64, device=bits.device)
    return (padded.view(n, words, 64).to(torch.int64) << shifts).sum(dim=2)


# One-slot memo of the packed words, keyed by the identity of the four
# bool tensors (solve's residency memo hands the same tensors back for the
# same snapshot), so a repeated solve packs nothing.
_pack_memo = None


def _packed(inputs: BinPackInputs):
    """(intolerant, required, taints, ~labels) as packed int64 words."""
    global _pack_memo
    key = (
        inputs.pod_intolerant, inputs.pod_required,
        inputs.group_taints, inputs.group_labels,
    )
    memo = _pack_memo
    if memo is not None and all(a is b for a, b in zip(memo[0], key)):
        return memo[1]
    packed = (
        pack_bits(inputs.pod_intolerant),
        pack_bits(inputs.pod_required),
        pack_bits(inputs.group_taints),
        pack_bits(~inputs.group_labels),
    )
    _pack_memo = (key, packed)
    return packed


def _check_operands(inputs: BinPackInputs) -> None:
    """The fused stage knows the score, forbidden and exclusive operands;
    anything else must be routed away (ops/binpack._fold_for_fused), never
    dropped."""
    if has_constraint_operands(inputs):
        raise ValueError("fused_assign has no constraint-plane entry")
    if inputs.pod_priority is not None or inputs.group_tier is not None:
        raise ValueError(
            "fused_assign takes no priority operands: fold the steer into "
            "the score first (ops/binpack._fold_for_fused)"
        )


# csrc/fused_assign.cu's constants (tests pin them against the source)
ROWS_PER_BLOCK = 512
THREADS = 256
MAX_RESOURCES = 8
MAX_WORDS = 8  # K, L <= 512
# the narrow kernel instance: R <= 3 resources, K and L in one word each,
# the group side as 32-byte records in shared memory
_NARROW = (3, 1)
_RECORD_BYTES = 32
# the narrow instance's records take at most this many bytes; past it, and
# for wider shapes, the scan runs the generic instance, which reads the
# group side from global memory
GROUP_SHARED_BUDGET = 64 * 1024


@dataclass(frozen=True)
class FusedPlan:
    """Launch plan of csrc/fused_assign.cu for one problem shape."""

    n_blocks: int  # ceil(P / ROWS_PER_BLOCK): fixed row chunks
    narrow: bool  # the (3 resources, 1 word) record instance, else (8, 8)
    shared_bytes: int  # dynamic shared memory per block (the records)
    key_bits: int  # radix-sort bits of the key group * B + bucket
    partial_bytes: int  # f64 demand partials [n_blocks, T, R]
    unsched_bytes: int  # i32 unschedulable partials [n_blocks]

    @property
    def scratch_bytes(self) -> int:
        return self.partial_bytes + self.unsched_bytes


def fused_assign_plan(
    n_pods: int, n_groups: int, n_res: int, kw: int, lw: int, buckets: int
) -> FusedPlan:
    """The fused kernel's launch plan, from the problem's shape alone (no
    device property enters it, so the blocks' row chunks, and with them
    the order of every float sum, are the same on any card). kw and lw
    are the packed word counts of K and L. Raises ValueError for shapes
    the kernel does not take."""
    if n_res > MAX_RESOURCES:
        raise ValueError(f"fused_assign: at most {MAX_RESOURCES} resources")
    if max(kw, lw) > MAX_WORDS:
        raise ValueError(f"fused_assign: at most {64 * MAX_WORDS} "
                         "taints/labels")
    if buckets < 1:
        raise ValueError("fused_assign: buckets must be >= 1")
    if n_groups * buckets >= 2**31:
        raise ValueError("fused_assign: groups x buckets must stay below 2^31")
    n_blocks = -(-n_pods // ROWS_PER_BLOCK)
    narrow = (
        n_res <= _NARROW[0] and max(kw, lw) <= _NARROW[1]
        and n_groups * _RECORD_BYTES <= GROUP_SHARED_BUDGET
    )
    return FusedPlan(
        n_blocks=n_blocks,
        narrow=narrow,
        shared_bytes=n_groups * _RECORD_BYTES if narrow else 0,
        # the sentinel key T * B (rows with no group) must fit as well
        key_bits=max(1, (n_groups * buckets).bit_length()),
        partial_bytes=8 * n_blocks * n_groups * n_res,
        unsched_bytes=4 * n_blocks,
    )


FusedOutputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fused_assign_reference(inputs: BinPackInputs, buckets: int) -> FusedOutputs:
    """Plain PyTorch version of the fused stage, on the same packed words
    the kernel reads. Returns (assigned i32[P], hist i32[T, B],
    demand f32[T, R], unschedulable i32 scalar)."""
    _check_operands(inputs)
    req = inputs.pod_requests
    alloc = inputs.group_allocatable
    n_pods, n_groups = req.shape[0], alloc.shape[0]
    intol_w, required_w, taint_w, nolabel_w = _packed(inputs)

    fits = torch.ones((n_pods, n_groups), dtype=torch.bool, device=req.device)
    for r in range(req.shape[1]):
        fits &= req[:, r : r + 1] <= alloc[None, :, r]
    fits &= (alloc > 0).any(dim=1)[None, :]
    fits &= ((intol_w[:, None, :] & taint_w[None, :, :]) == 0).all(dim=2)
    fits &= ((required_w[:, None, :] & nolabel_w[None, :, :]) == 0).all(dim=2)
    if inputs.pod_group_forbidden is not None:
        fits &= ~inputs.pod_group_forbidden
    fits &= inputs.pod_valid[:, None]

    # the min feasible index, or the min index among max-score feasible
    if inputs.pod_group_score is not None:
        masked = torch.where(fits, inputs.pod_group_score, -_BIG)
        candidate = fits & (masked == masked.max(dim=1, keepdim=True).values)
    else:
        candidate = fits
    col = torch.arange(n_groups, dtype=torch.int32, device=req.device)
    first = torch.where(candidate, col[None, :], n_groups).min(dim=1).values
    has = first < n_groups
    assigned = torch.where(has, first, -1).to(torch.int32)

    # dominant share of the assigned group only
    a = alloc[first.clamp(max=n_groups - 1).long()]  # [P, R]
    share = torch.zeros(n_pods, dtype=torch.float32, device=req.device)
    for r in range(req.shape[1]):
        s = torch.where(a[:, r] > 0, req[:, r] / a[:, r].clamp_min(1e-30), _BIG)
        s = torch.where((a[:, r] <= 0) & (req[:, r] <= 0), 0.0, s)
        share = torch.maximum(share, s)
    bucket = quantize_share(share, buckets)
    if inputs.pod_exclusive is not None:
        bucket = torch.where(inputs.pod_exclusive, buckets, bucket)
    w_row = _row_weight(inputs, has)
    hist = weighted_histogram(assigned, bucket, w_row, n_groups, buckets)
    demand = weighted_demand(assigned, w_row, req, n_groups)
    unsched = unschedulable_of(assigned, inputs.pod_valid, inputs.pod_weight)
    return assigned, hist, demand, unsched


def _ptr(t):
    return None if t is None else t.data_ptr()


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want {dtype} {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous tensor on {device}")


def fused_assign(inputs: BinPackInputs, buckets: int) -> FusedOutputs:
    """(assigned i32[P], hist i32[T, B], demand f32[T, R], unschedulable
    i32 scalar). CUDA tensors launch csrc/fused_assign.cu; CPU tensors run
    fused_assign_reference."""
    dev = inputs.pod_requests.device
    if dev.type == "cpu":
        return fused_assign_reference(inputs, buckets)
    if dev.type != "cuda":
        raise ValueError(f"fused_assign: unsupported device {dev}")
    _check_operands(inputs)
    req, alloc = inputs.pod_requests, inputs.group_allocatable
    n_pods, n_res = req.shape
    n_groups = alloc.shape[0]
    intol_w, required_w, taint_w, nolabel_w = _packed(inputs)
    kw, lw = intol_w.shape[1], required_w.shape[1]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    _require(req, "pod_requests", f32, (n_pods, n_res), dev)
    _require(inputs.pod_valid, "pod_valid", b8, (n_pods,), dev)
    _require(alloc, "group_allocatable", f32, (n_groups, n_res), dev)
    for name, shape, dtype in (
        ("pod_weight", (n_pods,), i32),
        ("pod_group_forbidden", (n_pods, n_groups), b8),
        ("pod_group_score", (n_pods, n_groups), f32),
        ("pod_exclusive", (n_pods,), b8),
    ):
        if getattr(inputs, name) is not None:
            _require(getattr(inputs, name), name, dtype, shape, dev)

    plan = fused_assign_plan(n_pods, n_groups, n_res, kw, lw, buckets)
    lib = kernels.library("fused_assign")
    assigned = torch.empty(n_pods, dtype=i32, device=dev)
    hist = torch.empty((n_groups, buckets), dtype=i32, device=dev)
    partial = torch.empty(
        max(1, plan.partial_bytes // 8), dtype=torch.float64, device=dev
    )
    unsched_partial = torch.empty(max(1, plan.n_blocks), dtype=i32, device=dev)
    demand = torch.empty((n_groups, n_res), dtype=f32, device=dev)
    unsched = torch.empty((), dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fused_assign_launch(
            _ptr(req), _ptr(inputs.pod_valid), _ptr(intol_w), _ptr(required_w),
            _ptr(inputs.pod_weight), _ptr(alloc), _ptr(taint_w),
            _ptr(nolabel_w), _ptr(inputs.pod_group_forbidden),
            _ptr(inputs.pod_group_score), _ptr(inputs.pod_exclusive),
            n_pods, n_groups, n_res, kw, lw, buckets,
            plan.n_blocks, int(plan.narrow), plan.shared_bytes,
            plan.key_bits,
            _ptr(assigned), _ptr(hist), _ptr(partial), _ptr(unsched_partial),
            _ptr(demand), _ptr(unsched), stream,
        )
    kernels.check("fused_assign", err, "fused_assign launch")
    LAUNCHES["fused_assign"] += 1
    return assigned, hist, demand, unsched


# csrc/shelf_bfd.cu: the largest B whose per-warp row, bins and
# placements (12 B bytes) fit one block's shared memory
SHELF_MAX_BUCKETS = _MAX_SHARED_BYTES // 12


def shelf_bfd_reference(
    histogram: torch.Tensor, buckets: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the shelf kernel: (nodes i32[T],
    assigned_count i32[T]), the shelf-BFD node count and the row sum of an
    i32[T, B] histogram."""
    return _shelf_bfd(histogram, buckets), histogram.sum(dim=1, dtype=torch.int32)


def shelf_bfd(
    histogram: torch.Tensor, buckets: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nodes i32[T], assigned_count i32[T]) of an i32[T, B] histogram.
    CUDA tensors launch csrc/shelf_bfd.cu; CPU tensors run
    shelf_bfd_reference."""
    dev = histogram.device
    if dev.type == "cpu":
        return shelf_bfd_reference(histogram, buckets)
    if dev.type != "cuda":
        raise ValueError(f"shelf_bfd: unsupported device {dev}")
    n_groups = histogram.shape[0]
    _require(histogram, "histogram", torch.int32, (n_groups, buckets), dev)
    if not 1 <= buckets <= SHELF_MAX_BUCKETS:
        raise ValueError(f"shelf_bfd: buckets must be in [1, {SHELF_MAX_BUCKETS}]")
    lib = kernels.library("shelf_bfd")
    nodes = torch.empty(n_groups, dtype=torch.int32, device=dev)
    count = torch.empty(n_groups, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.shelf_bfd_launch(
            _ptr(histogram), n_groups, buckets, _ptr(nodes), _ptr(count),
            stream,
        )
    kernels.check("shelf_bfd", err, "shelf_bfd launch")
    LAUNCHES["shelf_bfd"] += 1
    return nodes, count


def binpack_fused(inputs: BinPackInputs, buckets: int = 32) -> BinPackOutputs:
    """Full bin-pack via the fused stage, the shelf kernel and the
    lp_bound tail; the same contract as ops/binpack.binpack. The kernels
    give assigned_count and unschedulable themselves."""
    assigned, hist, demand, unsched = fused_assign(inputs, buckets)
    nodes, count = shelf_bfd(hist, buckets)
    return BinPackOutputs(
        assigned=assigned,
        assigned_count=count,
        nodes_needed=nodes,
        lp_bound=lp_bound_of(demand, inputs.group_allocatable),
        unschedulable=unsched,
    )


__all__ = [
    "LAUNCHES",
    "FusedPlan",
    "binpack_fused",
    "fused_assign",
    "fused_assign_plan",
    "fused_assign_reference",
    "pack_bits",
    "reset_launch_counts",
    "shelf_bfd",
    "shelf_bfd_reference",
]
