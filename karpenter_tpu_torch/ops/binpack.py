"""Pending-pods bin-packing in PyTorch (counterpart of
karpenter_tpu/ops/binpack.py).

The same program as the reference's XLA solve, on tensors:

1. FEASIBILITY [P, T]: resource fit, taints/tolerations and required labels
   (0/1 products, exact), the forbidden mask, validity and the constraint
   plane's mask.
2. ASSIGNMENT [P]: first feasible group, or the lexicographic
   (steer, score) choice with the lowest-index tie-break.
3. PACKING: the assigned group's dominant share, quantized up into B
   buckets, feeds a per-group shelf best-fit-decreasing over the [T, B]
   histogram (one per pack class when classes are present).

`solve` is the entry point. It runs on the CUDA card unless the caller
passes device="cpu", and routes the fused path (ops/fused_assign.py, two
hand-written CUDA kernels) or this module's plain program exactly as the
reference routes Pallas and XLA.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from karpenter_tpu_torch.utils.device import DeviceLike, resolve_device

DEFAULT_BUCKETS = 32


@dataclass
class BinPackInputs:
    """Structure-of-tensors snapshot of the pending-pods problem; fields,
    shapes and meaning as in the reference's BinPackInputs. Rows are pod
    SHAPES (deduplicated pods, `pod_weight` = multiplicity); every optional
    field left None reproduces the solve without it bit for bit."""

    pod_requests: torch.Tensor  # f32[P, R]
    pod_valid: torch.Tensor  # bool[P]
    pod_intolerant: torch.Tensor  # bool[P, K] pod does NOT tolerate taint k
    pod_required: torch.Tensor  # bool[P, L] pod requires label l
    group_allocatable: torch.Tensor  # f32[T, R]
    group_taints: torch.Tensor  # bool[T, K]
    group_labels: torch.Tensor  # bool[T, L]
    pod_weight: Optional[torch.Tensor] = None  # i32[P]
    pod_group_forbidden: Optional[torch.Tensor] = None  # bool[P, T]
    pod_group_score: Optional[torch.Tensor] = None  # f32[P, T]
    pod_priority: Optional[torch.Tensor] = None  # i32[P]
    group_tier: Optional[torch.Tensor] = None  # i32[T]
    pod_exclusive: Optional[torch.Tensor] = None  # bool[P]
    # constraint plane: all six optional, see constraint_mask
    pod_claim: Optional[torch.Tensor] = None  # i32[P]
    group_reservation: Optional[torch.Tensor] = None  # i32[T]
    pod_pack_class: Optional[torch.Tensor] = None  # bool[P, C]
    pod_spread_slot: Optional[torch.Tensor] = None  # i32[P]
    group_domain: Optional[torch.Tensor] = None  # i32[T]
    spread_cap: Optional[torch.Tensor] = None  # i32[S, D]


@dataclass
class BinPackOutputs:
    assigned: torch.Tensor  # i32[P] group per row, -1 if unschedulable
    assigned_count: torch.Tensor  # i32[T] weighted pods routed to each group
    nodes_needed: torch.Tensor  # i32[T] shelf-BFD node count
    lp_bound: torch.Tensor  # i32[T] LP-relaxation lower bound
    unschedulable: torch.Tensor  # i32 scalar: weighted pods with no group


_FIELD_DTYPES = {
    "pod_requests": torch.float32,
    "pod_valid": torch.bool,
    "pod_intolerant": torch.bool,
    "pod_required": torch.bool,
    "group_allocatable": torch.float32,
    "group_taints": torch.bool,
    "group_labels": torch.bool,
    "pod_weight": torch.int32,
    "pod_group_forbidden": torch.bool,
    "pod_group_score": torch.float32,
    "pod_priority": torch.int32,
    "group_tier": torch.int32,
    "pod_exclusive": torch.bool,
    "pod_claim": torch.int32,
    "group_reservation": torch.int32,
    "pod_pack_class": torch.bool,
    "pod_spread_slot": torch.int32,
    "group_domain": torch.int32,
    "spread_cap": torch.int32,
}

_CONSTRAINT_FIELDS = (
    "pod_claim",
    "group_reservation",
    "pod_pack_class",
    "pod_spread_slot",
    "group_domain",
    "spread_cap",
)


def _as_field(name: str, value, device: torch.device) -> Optional[torch.Tensor]:
    if value is None:
        return None
    if isinstance(value, np.ndarray):
        # a copy: the tensor never aliases (or writes to) the caller's array
        value = torch.from_numpy(np.array(value, order="C"))
    return value.to(device=device, dtype=_FIELD_DTYPES[name]).contiguous()


def inputs_from_numpy(
    fields: Mapping[str, np.ndarray], device: DeviceLike = None
) -> BinPackInputs:
    """BinPackInputs on `device` from one numpy array per field (the
    reference's inputs, `np.asarray` field by field). bool stays bool, f32
    f32 and i32 i32; absent or None optional fields stay None."""
    unknown = set(fields) - set(_FIELD_DTYPES)
    if unknown:
        raise ValueError(f"unknown BinPackInputs fields {sorted(unknown)}")
    dev = resolve_device(device)
    return BinPackInputs(
        **{
            name: _as_field(name, value, dev)
            for name, value in fields.items()
            if value is not None
        }
    )


# Priority steering (pod_priority x group_tier) is LEXICOGRAPHIC: best
# steer first, preference score as the tie-break within the winning steer
# level — never an arithmetic composition, so score magnitudes cannot
# reorder it.


def steer_matrix(priority, tier) -> Optional[torch.Tensor]:
    """f32[P, T]: -1 where a positive-priority pod meets a tier>0 group,
    0 elsewhere; None when priority or tier is absent."""
    if priority is None or tier is None:
        return None
    return (
        -((tier > 0)[None, :] & (priority > 0)[:, None]).to(torch.int32)
    ).to(torch.float32)


def _first_max(x: torch.Tensor) -> torch.Tensor:
    """Row argmax keeping the first maximum (torch.argmax refuses bool)."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return torch.argmax(x, dim=1)


def steered_choice(feasible, score, steer) -> torch.Tensor:
    """i64[P]: argmax under lexicographic (steer, score) preference among
    feasible groups, the first maximum breaking the final tie."""
    neg_inf = float("-inf")
    if steer is None:
        return _first_max(torch.where(feasible, score, neg_inf))
    masked_steer = torch.where(feasible, steer, neg_inf)
    if score is None:
        return _first_max(masked_steer)
    best_steer = masked_steer.max(dim=1, keepdim=True).values
    tie = feasible & (masked_steer == best_steer)
    return _first_max(torch.where(tie, score, neg_inf))


def has_constraint_operands(inputs: BinPackInputs) -> bool:
    """True when any constraint-plane operand is present: the fused path
    has no constraint entry, so such inputs route to the plain program."""
    return any(getattr(inputs, f) is not None for f in _CONSTRAINT_FIELDS)


def constraint_mask(claim, reservation, slot, domain, caps, weight, valid):
    """Feasibility mask (broadcastable against [P, T]) for the
    reservation-claim and topology-spread operands, or None when neither
    is present. Reservation: claim[p] == reservation[t], a missing side
    reading as zeros. Spread: rows of slot s >= 1 take an exclusive
    weighted prefix-sum rank over their slot and target the first domain
    whose cumulative cap has room for it; a rank past the total cap is
    infeasible everywhere. Integer arithmetic throughout (int32, as in the
    reference)."""
    mask = None
    if claim is not None or reservation is not None:
        if claim is None:
            res_m = reservation[None, :] == 0
        elif reservation is None:
            res_m = (claim == 0)[:, None]
        else:
            res_m = claim[:, None] == reservation[None, :]
        mask = res_m
    if slot is not None and domain is not None and caps is not None:
        i32 = torch.int32
        n_slots = caps.shape[0]
        valid_i = valid.to(i32)
        w_eff = valid_i if weight is None else weight * valid_i
        onehot = slot[:, None] == torch.arange(
            1, n_slots + 1, dtype=i32, device=slot.device
        )[None, :]
        contrib = w_eff[:, None] * onehot.to(i32)
        rank = torch.cumsum(contrib, dim=0, dtype=i32) - contrib
        rank_p = torch.where(onehot, rank, 0).sum(dim=1, dtype=i32)
        cumcap = torch.cumsum(caps, dim=1, dtype=i32)
        row_caps = cumcap[torch.clamp(slot - 1, 0, n_slots - 1).long()]
        fits_dom = rank_p[:, None] < row_caps
        target = _first_max(fits_dom).to(i32)
        has_dom = fits_dom.any(dim=1)
        sp_m = (slot[:, None] <= 0) | (
            (domain[None, :] == target[:, None]) & has_dom[:, None]
        )
        mask = sp_m if mask is None else mask & sp_m
    return mask


def _feasibility(inputs: BinPackInputs) -> torch.Tensor:
    """bool[P, T]: pod p can run on a node of group t."""
    req = inputs.pod_requests
    alloc = inputs.group_allocatable
    fits = torch.ones(
        (req.shape[0], alloc.shape[0]), dtype=torch.bool, device=req.device
    )
    for r in range(req.shape[1]):  # R is tiny: one [P, T] compare each
        fits &= req[:, r : r + 1] <= alloc[None, :, r]
    # a group with zero allocatable everywhere is empty: nothing fits it
    fits &= (alloc > 0).any(dim=1)[None, :]
    # 0/1 products: exact in f32 (and in TF32) up to 2^24 terms
    taint_violations = (
        inputs.pod_intolerant.to(torch.float32)
        @ inputs.group_taints.to(torch.float32).T
    )
    label_violations = (
        inputs.pod_required.to(torch.float32)
        @ (~inputs.group_labels).to(torch.float32).T
    )
    fits &= taint_violations < 0.5
    fits &= label_violations < 0.5
    if inputs.pod_group_forbidden is not None:
        fits &= ~inputs.pod_group_forbidden
    fits &= inputs.pod_valid[:, None]
    cmask = constraint_mask(
        inputs.pod_claim,
        inputs.group_reservation,
        inputs.pod_spread_slot,
        inputs.group_domain,
        inputs.spread_cap,
        inputs.pod_weight,
        inputs.pod_valid,
    )
    if cmask is not None:
        fits = fits & cmask
    return fits


def _dominant_share(inputs: BinPackInputs) -> torch.Tensor:
    """f32[P, T]: max over resources of req/alloc; inf where a resource
    the pod requests has zero allocatable."""
    req = inputs.pod_requests
    alloc = inputs.group_allocatable
    share = torch.zeros(
        (req.shape[0], alloc.shape[0]), dtype=torch.float32, device=req.device
    )
    for r in range(req.shape[1]):
        a = alloc[None, :, r]
        q = req[:, r : r + 1]
        s = torch.where(a > 0, q / a.clamp_min(1e-30), float("inf"))
        s = torch.where((a <= 0) & (q <= 0), 0.0, s)
        share = torch.maximum(share, s)
    return share


def quantize_share(share: torch.Tensor, buckets: int) -> torch.Tensor:
    """i32: ceil(share * B) clamped to [1, B] IN FLOAT, then cast. torch
    casts inf to int32 as INT_MIN, so clamping after the cast would put
    inf cells in bucket 1; XLA saturates, so clamping first matches it."""
    return torch.clamp(torch.ceil(share * buckets), 1, buckets).to(torch.int32)


def _shelf_bfd(histogram: torch.Tensor, buckets: int) -> torch.Tensor:
    """Vectorized shelf best-fit-decreasing over bucket histograms; the
    node count of the shelf kernel's plain version (csrc/shelf_bfd.cu runs
    the same fill passes, a warp per group).

    histogram: i32[T, B], items of quantized size (b+1)/B per group.
    Returns i32[T] bins needed. State bins[T, B+1] counts open bins by
    integer remaining capacity. Sizes k go descending; items of size k
    first fill existing bins best-fit (smallest sufficient remnant first,
    one item per bin per pass, via an exclusive cumsum), then open new
    bins of floor(B/k) items each.

    Fixed passes, no host sync: a bin still available at pass j+1 took an
    item in each of passes 1..j, so its original remnant was at least
    (j+1)k <= B. Passes past floor(B/k) therefore place nothing, and
    running exactly floor(B/k) of them is bit-exact against the
    reference's early-exit loop capped at B passes."""
    i32 = torch.int32
    dev = histogram.device
    n_groups = histogram.shape[0]
    rem_index = torch.arange(buckets + 1, dtype=i32, device=dev)
    bins = torch.zeros((n_groups, buckets + 1), dtype=i32, device=dev)
    total = torch.zeros((n_groups,), dtype=i32, device=dev)
    for k in range(buckets, 0, -1):
        c = histogram[:, k - 1].to(i32)
        usable = (rem_index >= k)[None, :]
        for _ in range(buckets // k):
            avail = torch.where(usable, bins, 0)
            cum_before = torch.cumsum(avail, dim=1, dtype=i32) - avail
            place = torch.minimum((c[:, None] - cum_before).clamp_min(0), avail)
            bins = bins - place + torch.roll(place, -k, dims=1)
            c = c - place.sum(dim=1, dtype=i32)
        per_bin = buckets // k
        full_bins = c // per_bin
        leftover = c - full_bins * per_bin
        has_partial = (leftover > 0).to(i32)
        total = total + full_bins + has_partial
        full_rem = buckets - per_bin * k
        partial_rem = buckets - leftover * k
        bins[:, full_rem] += full_bins
        bins = bins + (
            (rem_index[None, :] == partial_rem[:, None]).to(i32)
            * has_partial[:, None]
        )
    return total


def weighted_histogram(assigned, bucket, weight_row, n_groups, buckets):
    """i32[T, B]: sum of weight_row over rows with assigned == t and
    bucket == b + 1. Integer scatter: exact and order-free."""
    i32 = torch.int32
    hist = torch.zeros(n_groups * buckets, dtype=i32, device=assigned.device)
    has = assigned >= 0
    index = torch.where(has, assigned.long() * buckets + (bucket.long() - 1), 0)
    hist.scatter_add_(0, index, torch.where(has, weight_row, 0).to(i32))
    return hist.view(n_groups, buckets)


def weighted_demand(assigned, weight_row, requests, n_groups):
    """f32[T, R]: sum of weight_row * requests over rows assigned to t.
    Accumulated in f64 (every product of an i32 weight below 2^24 and an
    f32 request is exact there) and rounded once to f32, so the order of
    summation is invisible in all but the rarest last bit; the reference
    pins the same product at f32 HIGHEST precision."""
    groups = torch.arange(n_groups, dtype=torch.int32, device=assigned.device)
    member_w = (assigned[:, None] == groups[None, :]).to(torch.float64) * (
        weight_row.to(torch.float64)[:, None]
    )
    return (member_w.T @ requests.to(torch.float64)).to(torch.float32)


def lp_bound_of(demand: torch.Tensor, alloc: torch.Tensor) -> torch.Tensor:
    """i32[T]: per resource ceil(demand/alloc - 1e-5), max over resources."""
    per_resource = torch.where(
        alloc > 0, torch.ceil(demand / alloc.clamp_min(1e-30) - 1e-5), 0.0
    )
    return per_resource.max(dim=1).values.to(torch.int32)


def unschedulable_of(assigned, valid, weight) -> torch.Tensor:
    """i32 scalar: weighted valid rows with no feasible group."""
    mask = ((assigned < 0) & valid).to(torch.int32)
    return (mask if weight is None else mask * weight).sum(dtype=torch.int32)


def _row_weight(inputs: BinPackInputs, has: torch.Tensor) -> torch.Tensor:
    """i32[P]: each row's weight where it is assigned, 0 elsewhere."""
    w = inputs.pod_weight
    one = has.to(torch.int32)
    return one if w is None else one * w


def binpack(
    inputs: BinPackInputs, buckets: int = DEFAULT_BUCKETS
) -> BinPackOutputs:
    """The plain PyTorch program: all five outputs, on whatever device the
    inputs live on."""
    feasible = _feasibility(inputs)
    share = _dominant_share(inputs)
    any_feasible = feasible.any(dim=1)
    steer = steer_matrix(inputs.pod_priority, inputs.group_tier)
    if steer is None and inputs.pod_group_score is None:
        choice = _first_max(feasible)
    else:
        choice = steered_choice(feasible, inputs.pod_group_score, steer)
    assigned = torch.where(any_feasible, choice.to(torch.int32), -1)
    n_groups = inputs.group_allocatable.shape[0]
    w_row = _row_weight(inputs, any_feasible)
    col = assigned.clamp_min(0).long()[:, None]
    bucket = quantize_share(share.gather(1, col)[:, 0], buckets)
    if inputs.pod_exclusive is not None:
        # hostname self-anti-affinity: the pod takes a whole node
        bucket = torch.where(inputs.pod_exclusive, buckets, bucket)
    assigned_count = torch.zeros(n_groups, dtype=torch.int32, device=col.device)
    assigned_count.scatter_add_(0, col[:, 0], w_row)

    pc = inputs.pod_pack_class
    if pc is None:
        hist = weighted_histogram(assigned, bucket, w_row, n_groups, buckets)
        nodes_needed = _shelf_bfd(hist, buckets)
    else:
        # isolation classes never share a node: one shelf solve per class,
        # rows with no class bit folding into the shared class 0
        fold0 = pc[:, 0] | ~pc.any(dim=1)
        nodes_needed = torch.zeros_like(assigned_count)
        for c in range(pc.shape[1]):
            cls = fold0 if c == 0 else pc[:, c]
            hist_c = weighted_histogram(
                assigned, bucket, w_row * cls.to(torch.int32), n_groups,
                buckets,
            )
            nodes_needed = nodes_needed + _shelf_bfd(hist_c, buckets)

    demand = weighted_demand(assigned, w_row, inputs.pod_requests, n_groups)
    return BinPackOutputs(
        assigned=assigned,
        assigned_count=assigned_count,
        nodes_needed=nodes_needed,
        lp_bound=lp_bound_of(demand, inputs.group_allocatable),
        unschedulable=unschedulable_of(
            assigned, inputs.pod_valid, inputs.pod_weight
        ),
    )


# Inputs rerouted from the fused path to the plain program, by reason
# (the counterpart of the reference's constraint-reroute stat).
REROUTES = {"constraints": 0, "score_and_steer": 0}


def _fold_for_fused(inputs: BinPackInputs):
    """(inputs, backend) for the fused CUDA path, which knows the score
    operand but not the priority pair. Score-free priority fleets fold the
    steer matrix into the score (with no base score, steer IS the score:
    the same assignment by construction). Score plus steer needs the
    lexicographic choice and routes to the plain program, as does any
    constraint operand (the fused path has no constraint entry, and
    dropping an operand silently would change the answer)."""
    if has_constraint_operands(inputs):
        REROUTES["constraints"] += 1
        return inputs, "torch"
    if inputs.pod_priority is None or inputs.group_tier is None:
        return inputs, "cuda"
    if inputs.pod_group_score is not None:
        REROUTES["score_and_steer"] += 1
        return inputs, "torch"
    return (
        dataclasses.replace(
            inputs,
            pod_group_score=steer_matrix(inputs.pod_priority, inputs.group_tier),
            pod_priority=None,
            group_tier=None,
        ),
        "cuda",
    )


# One-slot identity-keyed residency memo: a caller that passes the SAME
# inputs object again skips the host->device copy. Contract: inputs are
# immutable once passed to solve().
_put_memo = None


def _device_resident(inputs: BinPackInputs, device: torch.device) -> BinPackInputs:
    global _put_memo
    memo = _put_memo
    if memo is not None and memo[0] is inputs and memo[1] == device:
        return memo[2]
    resident = BinPackInputs(
        **{
            f.name: _as_field(f.name, getattr(inputs, f.name), device)
            for f in dataclasses.fields(BinPackInputs)
        }
    )
    _put_memo = (inputs, device, resident)
    return resident


def solve(
    inputs: BinPackInputs,
    buckets: int = DEFAULT_BUCKETS,
    backend: str = "auto",
    device: DeviceLike = None,
) -> BinPackOutputs:
    """Backend dispatcher. 'cuda': the fused assignment kernel plus the
    shelf kernel (ops/fused_assign.py); 'torch': this module's plain
    program; 'auto': 'cuda' on the card, 'torch' on the CPU. The device
    defaults to the CUDA card and raises when there is none; the CPU runs
    only when asked for (device='cpu'), and there only 'torch' exists.
    Fields may be tensors or numpy arrays; they are made resident on the
    device by object identity (see _device_resident)."""
    dev = resolve_device(device)
    if backend == "auto":
        backend = "cuda" if dev.type == "cuda" else "torch"
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown binpack backend {backend!r}")
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError("backend 'cuda' needs a CUDA device")
    inputs = _device_resident(inputs, dev)
    if backend == "cuda":
        inputs, backend = _fold_for_fused(inputs)
    if backend == "torch":
        return binpack(inputs, buckets=buckets)
    from karpenter_tpu_torch.ops.fused_assign import binpack_fused

    return binpack_fused(inputs, buckets=buckets)


# ---------------------------------------------------------------------------
# Scalar oracle (NumPy): the same shelf-BFD algorithm item by item, which
# pins _shelf_bfd and the shelf kernel exactly, plus full-precision FFD.
# ---------------------------------------------------------------------------


def _bfd_fill_existing(bins: np.ndarray, k: int, c: int, buckets: int) -> int:
    """Place up to `c` items of size k into existing bins, best-fit
    (smallest sufficient remnant first), re-scanning as remnants shrink.
    Returns the unplaced count."""
    while c > 0:
        placed = False
        for rem in range(k, buckets + 1):
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
    return c


def oracle_shelf_bfd(histogram: np.ndarray, buckets: int) -> np.ndarray:
    """histogram: i32[T, B] -> i64[T], mirroring _shelf_bfd semantics."""
    n_groups = histogram.shape[0]
    totals = np.zeros(n_groups, np.int64)
    for t in range(n_groups):
        bins = np.zeros(buckets + 1, np.int64)  # count by remaining capacity
        for k in range(buckets, 0, -1):
            c = _bfd_fill_existing(bins, k, int(histogram[t, k - 1]), buckets)
            if c > 0:
                per_bin = buckets // k
                full = c // per_bin
                leftover = c - full * per_bin
                totals[t] += full + (1 if leftover > 0 else 0)
                bins[buckets - per_bin * k] += full
                if leftover > 0:
                    bins[buckets - leftover * k] += 1
    return totals


def oracle_ffd(sizes: np.ndarray) -> int:
    """Classic full-precision first-fit-decreasing on fractional sizes."""
    bins: list = []
    for s in sorted(sizes, reverse=True):
        for i, rem in enumerate(bins):
            if s <= rem + 1e-9:
                bins[i] = rem - s
                break
        else:
            bins.append(1.0 - s)
    return len(bins)
