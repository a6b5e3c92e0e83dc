"""Shape bucketing for the shared solve service.

Every distinct operand shape is a distinct XLA program: a fleet whose
pending-pod count wanders 9,812 → 10,407 → 9,955 across ticks would
recompile the bin-pack on every tick if requests were dispatched at
their natural sizes. The encoder already pads to coarse multiples
(producers/pendingcapacity/constants.py), but other callers — the
sidecar's wire requests, simulate, bench — arrive at arbitrary shapes,
and even encoder-padded shapes step at every +256 pods.

The service therefore rounds every axis UP a power-of-two-ish ladder
(1, 1.5, 2, 3, 4, 6, 8, ... × floor): consecutive rungs are ≤ 1.5×
apart, so padding waste is bounded at 50% (33% amortized) while the
number of distinct compiled shapes for traffic in [floor, N] is
O(log N), not O(N). Steady-state traffic whose sizes jitter inside one
rung hits the same compiled program forever — zero recompiles after
warmup, which is what turns the 20–40 s TPU compile from a per-tick
hazard into a once-per-deployment cost.

Padding is SEMANTICS-PRESERVING by construction (the same argument the
encoder's own padding rests on):

  * extra pod rows: valid=False, weight=0 — excluded from assignment,
    every aggregate they touch adds exact zeros;
  * extra group columns: zero allocatable — `_feasibility` rejects them
    outright, so no pod is ever assigned to a padding group and their
    output rows are sliced off before results scatter back;
  * extra taint/label bits: zero on both sides of the bitset matmuls —
    they contribute nothing to either violation count.

Integer outputs (assigned, counts, node totals, unschedulable) are
therefore EQUAL to the unpadded solve, not merely close; the float
intermediate (the LP-bound einsum) only gains exactly-zero terms.
tests/test_torch_solver_service.py pins service outputs against direct
ops/binpack calls element for element, and the ladder and the padding
byte-equal to the reference's.

The port's copy of karpenter_tpu/solver/bucketing.py: the bin-pack
ladder, the eviction-planning half and the shard route's
mesh_aligned_shape. Padding runs on
the host, in numpy: operands given as tensors are read back first, so a
padded request always holds host arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import torch

from karpenter_tpu_torch.ops.binpack import BinPackInputs

# Axis floors: the smallest bucket on each ladder. Pods/groups mirror the
# encoder's pads (a fleet encoded at POD_PAD multiples lands exactly on a
# rung for small fleets); constraint universes mirror their pad constants.
POD_FLOOR = 256
GROUP_FLOOR = 8
TAINT_FLOOR = 32
LABEL_FLOOR = 64
RESOURCE_FLOOR = 4
# Coalesced batches are padded up this ladder too (1, 2, 3, 4, 6, 8, ...)
# so the number of distinct batched programs stays logarithmic in the
# coalesce cap.
BATCH_FLOOR = 1
# Constraint-plane axes (pack classes C, spread slots S, spread domains
# D) ride their own tiny ladders: real fleets have a handful of
# anti-affinity groups and zones, so a floor of 2 keeps the rung count
# in the low single digits.
CLASS_FLOOR = 2
SLOT_FLOOR = 2
DOMAIN_FLOOR = 2


def bucket_up(n: int, floor: int) -> int:
    """Round `n` up to the next rung of the {1, 1.5} × 2^k ladder above
    `floor` (floor, 1.5·floor, 2·floor, 3·floor, 4·floor, ...)."""
    if n <= floor:
        return floor
    rung = floor
    while True:
        if n <= rung:
            return rung
        if n <= rung + rung // 2:
            return rung + rung // 2
        rung *= 2


def bucket_shape(inputs: BinPackInputs) -> Tuple[int, int, int, int, int]:
    """(P, T, R, K, L) rounded up their ladders — the shape half of the
    compile-cache key."""
    p, r = inputs.pod_requests.shape
    t = inputs.group_allocatable.shape[0]
    k = inputs.pod_intolerant.shape[1]
    l = inputs.pod_required.shape[1]
    return (
        bucket_up(p, POD_FLOOR),
        bucket_up(t, GROUP_FLOOR),
        bucket_up(r, RESOURCE_FLOOR),
        bucket_up(k, TAINT_FLOOR),
        bucket_up(l, LABEL_FLOOR),
    )


def constraint_shape(inputs: BinPackInputs) -> Tuple[int, ...]:
    """(C, S, D) constraint-plane axes rounded up their ladders — joins
    the compile-cache key beside bucket_shape. Returns () when no
    shape-bearing constraint operand rides the request, so
    constraint-free traffic keeps a compact key. Padding these axes is
    inert by construction: all-false pack-class columns contribute empty
    histograms, appended zero-cap domains never change the first-fit
    target, and padded cap rows are never referenced (slot <= S_real)."""
    pc = inputs.pod_pack_class
    caps = inputs.spread_cap
    if pc is None and caps is None:
        return ()
    c = 0 if pc is None else bucket_up(pc.shape[1], CLASS_FLOOR)
    s = 0 if caps is None else bucket_up(caps.shape[0], SLOT_FLOOR)
    d = 0 if caps is None else bucket_up(caps.shape[1], DOMAIN_FLOOR)
    return (c, s, d)


def mesh_aligned_shape(
    shape: Tuple[int, int, int, int, int], extents: Tuple[int, int]
) -> Tuple[int, int, int, int, int]:
    """Grow a bucket shape's pod/group axes to the mesh-divisible
    multiples the reference's padding keeps (extents =
    parallel.mesh.mesh_extents). Constraint-universe axes are whole on
    every shard and stay on their own ladders. The result is a
    deterministic function of (bucket shape, extents), so the sharded
    dispatch key only needs to carry the extents."""
    from karpenter_tpu_torch.utils.functional import pad_to_multiple

    p, t, r, k, l = shape
    rows, cols = extents
    return (pad_to_multiple(p, rows) if rows > 1 else p,
            pad_to_multiple(t, cols) if cols > 1 else t,
            r, k, l)


def _rung_part(part) -> str:
    """One compile-cache key element, compactly: bool tuples
    (presence) as a 10-string, int tuples (shapes, extents) as
    PxTx..., everything else via str()."""
    if not isinstance(part, tuple) or not part:
        return str(part)
    if all(isinstance(x, bool) for x in part):
        return "".join("1" if x else "0" for x in part)
    if all(isinstance(x, int) for x in part):
        return "x".join(str(x) for x in part)
    return str(part)


def rung_label(key: tuple) -> str:
    """Human-readable rung of one compile-cache key, for telemetry —
    the compile ledger and /debug/solver render cache keys through
    this one formatter (observability/devicetelemetry.py). Unknown
    key vocabularies degrade to repr() rather than raise: a telemetry
    label must never break the dispatch it describes."""
    try:
        return "/".join(_rung_part(part) for part in key)
    except Exception:  # noqa: BLE001 — labels are best-effort
        return repr(key)


def presence(inputs: BinPackInputs) -> Tuple[bool, ...]:
    """Which optional operands ride this request — the other half of the
    compile-cache key (an absent operand removes whole program stages)."""
    return (
        inputs.pod_weight is not None,
        inputs.pod_group_forbidden is not None,
        inputs.pod_group_score is not None,
        inputs.pod_exclusive is not None,
        inputs.pod_priority is not None,
        inputs.group_tier is not None,
        inputs.pod_claim is not None,
        inputs.group_reservation is not None,
        inputs.pod_pack_class is not None,
        inputs.pod_spread_slot is not None,
        inputs.group_domain is not None,
        inputs.spread_cap is not None,
    )


def _pad2(a, rows: int, cols: Optional[int] = None):
    """Zero-pad a 1-D/2-D array up to (rows[, cols]); the same object is
    returned when no padding is needed so already-bucketed traffic (the
    encoder's steady state) keeps identity-based device caches warm."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    if a.ndim == 1:
        if a.shape[0] == rows:
            return a
        out = np.zeros(rows, a.dtype)
        out[: a.shape[0]] = a
        return out
    if a.shape == (rows, cols):
        return a
    out = np.zeros((rows, cols), a.dtype)
    out[: a.shape[0], : a.shape[1]] = a
    return out


def pad_to_bucket(  # lint: allow-complexity — one presence guard per optional operand
    inputs: BinPackInputs, shape: Tuple[int, int, int, int, int]
) -> BinPackInputs:
    """Pad every operand to the bucket `shape` (see module docstring for
    why this is exact). Returns `inputs` unchanged when already there."""
    p, t, r, k, l = shape
    pc = inputs.pod_pack_class
    caps = inputs.spread_cap
    c_pad = None if pc is None else bucket_up(pc.shape[1], CLASS_FLOOR)
    s_pad = None if caps is None else bucket_up(caps.shape[0], SLOT_FLOOR)
    d_pad = None if caps is None else bucket_up(caps.shape[1], DOMAIN_FLOOR)
    if (
        inputs.pod_requests.shape == (p, r)
        and inputs.group_allocatable.shape == (t, r)
        and inputs.pod_intolerant.shape == (p, k)
        and inputs.pod_required.shape == (p, l)
        and (pc is None or pc.shape == (p, c_pad))
        and (caps is None or caps.shape == (s_pad, d_pad))
    ):
        return inputs
    # pod_weight: absent means "every row counts once", so padding an
    # absent weight must materialize ones for real rows + zeros for pads
    # (an all-ones pad would count invalid padding rows into nothing —
    # they are valid=False — but zero weight keeps the aggregates exact
    # even if a future stage forgets the validity mask)
    weight = inputs.pod_weight
    if weight is not None:
        weight = _pad2(weight, p)
    forbidden = inputs.pod_group_forbidden
    if forbidden is not None:
        forbidden = _pad2(forbidden, p, t)
    score = inputs.pod_group_score
    if score is not None:
        score = _pad2(score, p, t)
    exclusive = inputs.pod_exclusive
    if exclusive is not None:
        exclusive = _pad2(exclusive, p)
    # priority pads at 0 (no steering) and tier at 0 (on-demand) — both
    # only act on rows/columns that are valid/feasible anyway
    priority = inputs.pod_priority
    if priority is not None:
        priority = _pad2(priority, p)
    tier = inputs.group_tier
    if tier is not None:
        tier = _pad2(tier, t)
    # constraint-plane operands: claim/slot pad 0 (unclaimed /
    # unconstrained — their rows are invalid anyway), reservation/domain
    # pad 0 on zero-allocatable groups nothing fits, pack-class rows pad
    # all-false (invalid rows never reach a histogram) and class/slot/
    # domain axes pad up their own ladders (inert — see
    # constraint_shape)
    claim = inputs.pod_claim
    if claim is not None:
        claim = _pad2(claim, p)
    reservation = inputs.group_reservation
    if reservation is not None:
        reservation = _pad2(reservation, t)
    if pc is not None:
        pc = _pad2(pc, p, c_pad)
    slot = inputs.pod_spread_slot
    if slot is not None:
        slot = _pad2(slot, p)
    domain = inputs.group_domain
    if domain is not None:
        domain = _pad2(domain, t)
    if caps is not None:
        caps = _pad2(caps, s_pad, d_pad)
    return BinPackInputs(
        pod_requests=_pad2(inputs.pod_requests, p, r),
        pod_valid=_pad2(inputs.pod_valid, p),
        pod_intolerant=_pad2(inputs.pod_intolerant, p, k),
        pod_required=_pad2(inputs.pod_required, p, l),
        group_allocatable=_pad2(inputs.group_allocatable, t, r),
        group_taints=_pad2(inputs.group_taints, t, k),
        group_labels=_pad2(inputs.group_labels, t, l),
        pod_weight=weight,
        pod_group_forbidden=forbidden,
        pod_group_score=score,
        pod_exclusive=exclusive,
        pod_priority=priority,
        group_tier=tier,
        pod_claim=claim,
        group_reservation=reservation,
        pod_pack_class=pc,
        pod_spread_slot=slot,
        group_domain=domain,
        spread_cap=caps,
    )


def crop_outputs(out, n_pods: int, n_groups: int):
    """Slice a padded solve's outputs back to the request's true axes.

    Padding groups are all-infeasible, so no real pod's `assigned` index
    ever points past n_groups; padding pods are invalid, so the scalar
    `unschedulable` never counts them. Host numpy in, host numpy out."""
    return dataclasses.replace(
        out,
        assigned=out.assigned[:n_pods],
        assigned_count=out.assigned_count[:n_groups],
        nodes_needed=out.nodes_needed[:n_groups],
        lp_bound=out.lp_bound[:n_groups],
    )


# -- eviction-planning (ops/preempt.py) shape ladder --------------------------
# Candidate counts are preemption-scale (a handful of high-priority
# pending pods), victim counts are occupancy-scale; each gets its own
# floor so both single-candidate probes and fleet-wide storms land on
# stable rungs.
CANDIDATE_FLOOR = 8
VICTIM_FLOOR = 64


def preempt_bucket_shape(inputs) -> Tuple[int, int, int, int]:
    """(C, N, R, V) rounded up their ladders — the shape half of the
    preempt dispatch key."""
    c, r = inputs.pod_requests.shape
    n = inputs.node_free.shape[0]
    v = inputs.victim_requests.shape[0]
    return (
        bucket_up(c, CANDIDATE_FLOOR),
        bucket_up(n, GROUP_FLOOR),
        bucket_up(r, RESOURCE_FLOOR),
        bucket_up(v, VICTIM_FLOOR),
    )


def pad_preempt_inputs(inputs, shape: Tuple[int, int, int, int]):
    """Zero-pad a PreemptInputs up to the bucket `shape`, semantics-
    preserving: padding candidates are invalid (excluded from every
    aggregate), padding node columns are zero-free AND forbidden for
    every candidate (never chosen), padding victims are invalid +
    zero-request with the LAST node column (the sorted-victim contract
    survives) and contribute nothing to prefix sums or maxima."""
    from karpenter_tpu_torch.ops.preempt import PreemptInputs

    c, n, r, v = shape
    if (
        tuple(inputs.pod_requests.shape) == (c, r)
        and tuple(inputs.node_free.shape) == (n, r)
        and tuple(inputs.victim_requests.shape) == (v, r)
    ):
        return inputs
    c0, n0, v0 = (
        inputs.pod_requests.shape[0],
        inputs.node_free.shape[0],
        inputs.victim_requests.shape[0],
    )
    forbidden = np.ones((c, n), bool)
    forbidden[:c0, :n0] = _pad2(inputs.pod_node_forbidden, c0, n0)
    victim_node = np.full(v, n - 1, np.int32)
    victim_node[:v0] = _pad2(inputs.victim_node, v0)
    return PreemptInputs(
        pod_requests=_pad2(inputs.pod_requests, c, r),
        pod_priority=_pad2(inputs.pod_priority, c),
        pod_valid=_pad2(inputs.pod_valid, c),
        pod_node_forbidden=forbidden,
        node_free=_pad2(inputs.node_free, n, r),
        node_tier=_pad2(inputs.node_tier, n),
        victim_requests=_pad2(inputs.victim_requests, v, r),
        victim_priority=_pad2(inputs.victim_priority, v),
        victim_node=victim_node,
        victim_valid=_pad2(inputs.victim_valid, v),
        victim_evictable=_pad2(inputs.victim_evictable, v),
    )


def crop_preempt_outputs(out, n_candidates: int, n_victims: int):
    """Slice a padded preempt solve back to the true candidate/victim
    axes. Padding nodes are forbidden, so no real candidate's
    chosen_node points past the real columns; padding candidates are
    invalid, so `unplaceable` never counts them."""
    return dataclasses.replace(
        out,
        chosen_node=out.chosen_node[:n_candidates],
        evict_count=out.evict_count[:n_candidates],
        evict_mask=out.evict_mask[:n_candidates, :n_victims],
    )
