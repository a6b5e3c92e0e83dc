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

The fused stage's host entry also comes in its two halves, for a sharded
solve (parallel/mesh.py): `fused_assign_scan` runs the assignment kernel
into a row slab's views of shared buffers (assigned, hist, the f64 demand
partials per block and the unschedulable partials), and `demand_reduce`
reduces every slab's partials, gathered in global block order, in one
launch.

The fused stage reads the taint and label masks bit-packed: `pack_masks`
packs the four (~labels through an invert flag) in one launch
(csrc/fused_assign.cu's pack_bits_launch); `pack_operands` does that for
a solve's operands, once per solve.

Each wrapper launches its kernel for CUDA tensors, counts the launch in
LAUNCHES, and raises on any failure; for CPU tensors, and only for them, it
runs its plain PyTorch version (fused_assign_reference,
fused_assign_scan_reference, demand_reduce_reference,
shelf_bfd_reference, pack_bits), which is also what the kernels are held
against on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.observability.tracing import default_tracer
from karpenter_tpu_torch.ops.binpack import (
    BinPackInputs,
    BinPackOutputs,
    _row_weight,
    _shelf_bfd,
    has_constraint_operands,
    lp_bound_of,
    on_device,
    quantize_share,
    unschedulable_of,
    weighted_demand,
    weighted_histogram,
)

# kernel launches by wrapper; only the wrappers below add to it. A
# single-device solve's fused launch (the scan and the reduction in one
# host entry) counts under "fused_assign"; a sharded solve counts each row
# slab's scan there and its one reduction under "demand_reduce";
# "pack_bits" counts the launches that pack a solve's four masks, one per
# solve
LAUNCHES = {"fused_assign": 0, "shelf_bfd": 0, "demand_reduce": 0,
            "pack_bits": 0}

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
    two is their OR, and no partial sum leaves int64's range. The plain
    version of pack_masks' kernel."""
    n, k = bits.shape
    words = max(1, -(-k // 64))
    padded = torch.zeros((n, words * 64), dtype=torch.bool, device=bits.device)
    padded[:, :k] = bits
    shifts = torch.arange(64, dtype=torch.int64, device=bits.device)
    return (padded.view(n, words, 64).to(torch.int64) << shifts).sum(dim=2)


# csrc/fused_assign.cu's kPackMaxMasks: the masks one pack launch takes
PACK_MAX_MASKS = 4


def pack_masks(masks, invert) -> Tuple[torch.Tensor, ...]:
    """Each bool[N_i, K_i] mask (its complement where `invert` says so) as
    pack_bits' int64[N_i, max(1, ceil(K_i / 64))] words. CUDA tensors pack
    all of them in one launch of csrc/fused_assign.cu's pack_bits_kernel
    (at most PACK_MAX_MASKS, on one device); CPU tensors run pack_bits."""
    masks, invert = tuple(masks), tuple(bool(i) for i in invert)
    if not masks or len(masks) != len(invert):
        raise ValueError("pack_masks: one invert flag per mask, at least one")
    dev = masks[0].device
    if dev.type == "cpu":
        return tuple(pack_bits(~m if inv else m)
                     for m, inv in zip(masks, invert))
    if dev.type != "cuda":
        raise ValueError(f"pack_masks: unsupported device {dev}")
    if len(masks) > PACK_MAX_MASKS:
        raise ValueError(f"pack_masks: at most {PACK_MAX_MASKS} masks a launch")
    masks = tuple(m.contiguous() for m in masks)
    for i, m in enumerate(masks):
        if m.dim() != 2:
            raise ValueError(f"pack_masks: mask {i} is not 2-d")
        _require(m, f"mask {i}", torch.bool, m.shape, dev)
    words = tuple(
        torch.empty((m.shape[0], max(1, -(-m.shape[1] // 64))),
                    dtype=torch.int64, device=dev)
        for m in masks
    )
    pad = PACK_MAX_MASKS - len(masks)
    lib = kernels.library("fused_assign")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pack_bits_launch(
            *(_ptr(m) for m in masks), *[None] * pad,
            *(_ptr(w) for w in words), *[None] * pad,
            *(m.shape[0] for m in masks), *[0] * pad,
            *(m.shape[1] for m in masks), *[0] * pad,
            sum(1 << i for i, inv in enumerate(invert) if inv), len(masks),
            stream,
        )
    kernels.check("fused_assign", err, "pack_bits launch")
    if any(m.shape[0] for m in masks):  # all empty: nothing launched
        LAUNCHES["pack_bits"] += 1
    return words


def pack_operands(inputs: BinPackInputs) -> Tuple[torch.Tensor, ...]:
    """(intolerant, required, taints, ~labels) as packed int64 words, by
    one pack_masks call."""
    return pack_masks(
        (inputs.pod_intolerant, inputs.pod_required,
         inputs.group_taints, inputs.group_labels),
        invert=(False, False, False, True),
    )


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


def _fused_rows(inputs: BinPackInputs, buckets: int, words=None):
    """The per-row half of the fused stage's plain version, on the packed
    words the kernel reads: (assigned i32[P], bucket i32[P], the row
    weight of each assigned row i32[P])."""
    _check_operands(inputs)
    req = inputs.pod_requests
    alloc = inputs.group_allocatable
    n_pods, n_groups = req.shape[0], alloc.shape[0]
    intol_w, required_w, taint_w, nolabel_w = (
        pack_operands(inputs) if words is None else words
    )

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
    return assigned, bucket, _row_weight(inputs, has)


def fused_assign_reference(inputs: BinPackInputs, buckets: int) -> FusedOutputs:
    """Plain PyTorch version of the fused stage, on the same packed words
    the kernel reads. Returns (assigned i32[P], hist i32[T, B],
    demand f32[T, R], unschedulable i32 scalar)."""
    assigned, bucket, w_row = _fused_rows(inputs, buckets)
    n_groups = inputs.group_allocatable.shape[0]
    hist = weighted_histogram(assigned, bucket, w_row, n_groups, buckets)
    demand = weighted_demand(assigned, w_row, inputs.pod_requests, n_groups)
    unsched = unschedulable_of(assigned, inputs.pod_valid, inputs.pod_weight)
    return assigned, hist, demand, unsched


ScanOutputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fused_assign_scan_reference(
    inputs: BinPackInputs, buckets: int, words=None
) -> ScanOutputs:
    """Plain PyTorch version of the scan half: (assigned i32[P], hist
    i32[T, B], partial f64[n_blocks, T, R], unsched_partial
    i32[n_blocks]), each block's demand and unschedulable sums over its
    ROWS_PER_BLOCK rows (the f64 products are exact; a block's sum is
    taken in row order)."""
    assigned, bucket, w_row = _fused_rows(inputs, buckets, words)
    req = inputs.pod_requests
    n_pods, n_res = req.shape
    n_groups = inputs.group_allocatable.shape[0]
    n_blocks = -(-n_pods // ROWS_PER_BLOCK)
    hist = weighted_histogram(assigned, bucket, w_row, n_groups, buckets)
    block = torch.arange(n_pods, device=req.device) // ROWS_PER_BLOCK
    has = assigned >= 0
    slot = torch.where(has, block * n_groups + assigned.long(), 0)
    partial = torch.zeros(
        (n_blocks * n_groups, n_res), dtype=torch.float64, device=req.device
    )
    partial.index_add_(
        0, slot, w_row.to(torch.float64)[:, None] * req.to(torch.float64)
    )
    unsched_row = ((assigned < 0) & inputs.pod_valid).to(torch.int32)
    if inputs.pod_weight is not None:
        unsched_row = unsched_row * inputs.pod_weight
    unsched_partial = torch.zeros(n_blocks, dtype=torch.int32, device=req.device)
    unsched_partial.index_add_(0, block, unsched_row)
    return (assigned, hist, partial.view(n_blocks, n_groups, n_res),
            unsched_partial)


def demand_reduce_reference(
    partial: torch.Tensor, unsched_partial: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the reduction half: (demand f32[T, R],
    unschedulable i32 scalar) of partial f64[n_blocks, T, R] and
    unsched_partial i32[n_blocks], summed in f64 and rounded once."""
    return (partial.sum(dim=0).to(torch.float32),
            unsched_partial.sum(dtype=torch.int32))


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


def _launch_operands(inputs: BinPackInputs, buckets: int, words):
    """(plan, the 21 operand and shape arguments of a fused launch) for
    CUDA inputs and their packed `words` (pack_operands), after checking
    every operand's dtype, shape, device and layout. The arguments are
    raw pointers: the caller holds `words` until the launch is enqueued,
    or their memory may go to the launch's own outputs."""
    dev = inputs.pod_requests.device
    _check_operands(inputs)
    req, alloc = inputs.pod_requests, inputs.group_allocatable
    n_pods, n_res = req.shape
    n_groups = alloc.shape[0]
    intol_w, required_w, taint_w, nolabel_w = words
    kw, lw = intol_w.shape[1], required_w.shape[1]
    f32, i32, b8, i64 = torch.float32, torch.int32, torch.bool, torch.int64
    _require(req, "pod_requests", f32, (n_pods, n_res), dev)
    _require(inputs.pod_valid, "pod_valid", b8, (n_pods,), dev)
    _require(alloc, "group_allocatable", f32, (n_groups, n_res), dev)
    _require(intol_w, "intolerant words", i64, (n_pods, kw), dev)
    _require(required_w, "required words", i64, (n_pods, lw), dev)
    _require(taint_w, "taint words", i64, (n_groups, kw), dev)
    _require(nolabel_w, "~label words", i64, (n_groups, lw), dev)
    for name, shape, dtype in (
        ("pod_weight", (n_pods,), i32),
        ("pod_group_forbidden", (n_pods, n_groups), b8),
        ("pod_group_score", (n_pods, n_groups), f32),
        ("pod_exclusive", (n_pods,), b8),
    ):
        if getattr(inputs, name) is not None:
            _require(getattr(inputs, name), name, dtype, shape, dev)

    plan = fused_assign_plan(n_pods, n_groups, n_res, kw, lw, buckets)
    args = (
        _ptr(req), _ptr(inputs.pod_valid), _ptr(intol_w), _ptr(required_w),
        _ptr(inputs.pod_weight), _ptr(alloc), _ptr(taint_w),
        _ptr(nolabel_w), _ptr(inputs.pod_group_forbidden),
        _ptr(inputs.pod_group_score), _ptr(inputs.pod_exclusive),
        n_pods, n_groups, n_res, kw, lw, buckets,
        plan.n_blocks, int(plan.narrow), plan.shared_bytes, plan.key_bits,
    )
    return plan, args


def fused_assign(inputs: BinPackInputs, buckets: int) -> FusedOutputs:
    """(assigned i32[P], hist i32[T, B], demand f32[T, R], unschedulable
    i32 scalar). CUDA tensors launch csrc/fused_assign.cu (the scan and
    the reduction through one host entry, one count); CPU tensors run
    fused_assign_reference. On the card the operand checks and bit
    packing are the span solver.pack, the launch solver.assign."""
    dev = inputs.pod_requests.device
    if dev.type == "cpu":
        return fused_assign_reference(inputs, buckets)
    if dev.type != "cuda":
        raise ValueError(f"fused_assign: unsupported device {dev}")
    tracer = default_tracer()
    with tracer.span("solver.pack"):
        words = pack_operands(inputs)  # held past the launch below
        plan, args = _launch_operands(inputs, buckets, words)
    with tracer.span("solver.assign"):
        n_pods, n_res = inputs.pod_requests.shape
        n_groups = inputs.group_allocatable.shape[0]
        i32 = torch.int32
        lib = kernels.library("fused_assign")
        assigned = torch.empty(n_pods, dtype=i32, device=dev)
        hist = torch.empty((n_groups, buckets), dtype=i32, device=dev)
        partial = torch.empty(
            max(1, plan.partial_bytes // 8), dtype=torch.float64, device=dev
        )
        unsched_partial = torch.empty(
            max(1, plan.n_blocks), dtype=i32, device=dev
        )
        demand = torch.empty(
            (n_groups, n_res), dtype=torch.float32, device=dev
        )
        unsched = torch.empty((), dtype=i32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.fused_assign_launch(
                *args, _ptr(assigned), _ptr(hist), _ptr(partial),
                _ptr(unsched_partial), _ptr(demand), _ptr(unsched), stream,
            )
        kernels.check("fused_assign", err, "fused_assign launch")
    LAUNCHES["fused_assign"] += 1
    return assigned, hist, demand, unsched


def scan_buffers(n_pods: int, n_groups: int, n_res: int, buckets: int,
                 device) -> ScanOutputs:
    """Empty (assigned, hist, partial, unsched_partial) buffers for a scan
    of n_pods rows, in the shapes fused_assign_scan writes."""
    n_blocks = -(-n_pods // ROWS_PER_BLOCK)
    return (
        torch.empty(n_pods, dtype=torch.int32, device=device),
        torch.empty((n_groups, buckets), dtype=torch.int32, device=device),
        torch.empty((n_blocks, n_groups, n_res), dtype=torch.float64,
                    device=device),
        torch.empty(n_blocks, dtype=torch.int32, device=device),
    )


def fused_assign_scan(
    inputs: BinPackInputs, buckets: int, words=None, out=None
) -> ScanOutputs:
    """The scan half: (assigned i32[P], hist i32[T, B], partial
    f64[n_blocks, T, R], unsched_partial i32[n_blocks]), written into
    `out` (buffers in those shapes, as scan_buffers makes them; views of
    a sharded solve's global buffers) or into new ones. `words` are the
    packed (intolerant, required, taint, ~label) words, packed here when
    None. CUDA tensors launch csrc/fused_assign.cu's fused_assign_scan;
    CPU tensors run fused_assign_scan_reference."""
    dev = inputs.pod_requests.device
    n_pods, n_res = inputs.pod_requests.shape
    n_groups = inputs.group_allocatable.shape[0]
    if out is None:
        out = scan_buffers(n_pods, n_groups, n_res, buckets, dev)
    n_blocks = -(-n_pods // ROWS_PER_BLOCK)
    for buf, name, dtype, shape in zip(
        out, ("assigned", "hist", "partial", "unsched_partial"),
        (torch.int32, torch.int32, torch.float64, torch.int32),
        ((n_pods,), (n_groups, buckets), (n_blocks, n_groups, n_res),
         (n_blocks,)),
    ):
        _require(buf, name, dtype, shape, dev)
    if dev.type == "cpu":
        for buf, value in zip(
            out, fused_assign_scan_reference(inputs, buckets, words)
        ):
            buf.copy_(value)
        return out
    if dev.type != "cuda":
        raise ValueError(f"fused_assign_scan: unsupported device {dev}")
    if words is None:
        words = pack_operands(inputs)  # held past the launch below
    _, args = _launch_operands(inputs, buckets, words)
    lib = kernels.library("fused_assign")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fused_assign_scan(
            *args, *(_ptr(buf) for buf in out), stream
        )
    kernels.check("fused_assign", err, "fused_assign_scan launch")
    LAUNCHES["fused_assign"] += 1
    return out


def demand_reduce(
    partial: torch.Tensor, unsched_partial: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reduction half: (demand f32[T, R], unschedulable i32 scalar) of
    partial f64[n_blocks, T, R] and unsched_partial i32[n_blocks], on
    their device. CUDA tensors launch csrc/fused_assign.cu's
    fused_assign_reduce (the order of its f64 sums depends on n_blocks
    alone); CPU tensors run demand_reduce_reference."""
    dev = partial.device
    if dev.type == "cpu":
        return demand_reduce_reference(partial, unsched_partial)
    if dev.type != "cuda":
        raise ValueError(f"demand_reduce: unsupported device {dev}")
    n_blocks, n_groups, n_res = partial.shape
    _require(partial, "partial", torch.float64, (n_blocks, n_groups, n_res),
             dev)
    _require(unsched_partial, "unsched_partial", torch.int32, (n_blocks,),
             dev)
    lib = kernels.library("fused_assign")
    demand = torch.empty((n_groups, n_res), dtype=torch.float32, device=dev)
    unsched = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fused_assign_reduce(
            _ptr(partial), _ptr(unsched_partial), n_blocks,
            n_groups * n_res, _ptr(demand), _ptr(unsched), stream,
        )
    kernels.check("fused_assign", err, "demand_reduce launch")
    LAUNCHES["demand_reduce"] += 1
    return demand, unsched


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


def kernel_cost(inputs: BinPackInputs, buckets: int,
                assigned: np.ndarray, hist: np.ndarray) -> dict:
    """The analytic work of one launch of each kernel on these operands:
    {name: (operations, bytes)}, each input read once and each output
    written once. The fused kernel's scan visits a row's groups up to its
    first feasible one (all of them for a row with none; invalid rows
    none), each visit comparing R requests and the K + L mask words; an
    assigned row adds its bucket, histogram and demand updates."""
    pods, n_res = inputs.pod_requests.shape
    groups = inputs.group_allocatable.shape[0]
    # pack_bits' word widths
    kw = max(1, -(-inputs.pod_intolerant.shape[1] // 64))
    lw = max(1, -(-inputs.pod_required.shape[1] // 64))
    valid = inputs.pod_valid.cpu().numpy()
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


def solve_cost(inputs: BinPackInputs, buckets: int) -> dict:
    """The cost analysis of one cuda-rung solve — both kernels'
    kernel_cost summed, as {"flops": operations, "bytes accessed": bytes}
    (the introspection plane's attribution). Computed on the host by the
    plain version, so it launches no kernel."""
    host = on_device(inputs, "cpu")
    assigned, hist, _, _ = fused_assign_reference(host, buckets)
    costs = kernel_cost(host, buckets, assigned.numpy(), hist.numpy())
    return {
        "flops": float(sum(ops for ops, _ in costs.values())),
        "bytes accessed": float(sum(nbytes for _, nbytes in costs.values())),
    }


def binpack_fused(inputs: BinPackInputs, buckets: int = 32) -> BinPackOutputs:
    """Full bin-pack via the fused stage, the shelf kernel and the
    lp_bound tail; the same contract as ops/binpack.binpack. The kernels
    give assigned_count and unschedulable themselves. Spans: fused_assign's
    solver.pack and solver.assign, then solver.shelf and solver.tail."""
    tracer = default_tracer()
    assigned, hist, demand, unsched = fused_assign(inputs, buckets)
    with tracer.span("solver.shelf"):
        nodes, count = shelf_bfd(hist, buckets)
    with tracer.span("solver.tail"):
        lp_bound = lp_bound_of(demand, inputs.group_allocatable)
    return BinPackOutputs(
        assigned=assigned,
        assigned_count=count,
        nodes_needed=nodes,
        lp_bound=lp_bound,
        unschedulable=unsched,
    )


__all__ = [
    "LAUNCHES",
    "FusedPlan",
    "binpack_fused",
    "demand_reduce",
    "demand_reduce_reference",
    "fused_assign",
    "fused_assign_plan",
    "fused_assign_reference",
    "fused_assign_scan",
    "fused_assign_scan_reference",
    "pack_bits",
    "pack_masks",
    "pack_operands",
    "reset_launch_counts",
    "shelf_bfd",
    "shelf_bfd_reference",
]
