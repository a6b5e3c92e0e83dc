"""THE single encoder: store snapshot -> fixed-shape solver operands
(group arrays, deduplicated weighted shape rows, spread/anti row
expansions, soft-constraint scores). Output equality across cache
states is pinned by the oracle suites.

The port's copy of karpenter_tpu/metrics/producers/pendingcapacity/
encoder.py. Its output is the port's ops/binpack.BinPackInputs holding
NUMPY arrays, byte for byte the reference's: `solve` places them on
the device, and the solve service's resident state (solver/resident.py)
keys them by object identity, so an encoded inputs object is never
mutated after it is returned. Its fault-injection points
(encoder.encode, constraints.mask) fire through the port's faults/."""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.api.core import (
    Taint,
    capacity_tier_of,
    is_ready_and_schedulable,
    matches_affinity_shape,
    matches_selector,
)
from karpenter_tpu_torch.constraints import compiler as _cc
from karpenter_tpu_torch.ops import binpack as B
from karpenter_tpu_torch.resilience import CircuitBreaker
from karpenter_tpu_torch.store.columnar import RESOURCE_PODS
from karpenter_tpu_torch.utils.functional import pad_to_multiple

from .anti import _expand_anti_rows
from .constants import (
    DEFAULT_PODS_PER_NODE,
    GROUP_PAD,
    LABEL_PAD,
    POD_PAD,
    RESOURCE_PAD,
    RESOURCES_BASE,
    TAINT_PAD,
)
from .scoring import _score_rows
from .spread import _expand_spread_rows

_pad = pad_to_multiple

# -- constraint plane (karpenter_tpu/constraints) ----------------------------
# The declarative-constraint compile is gated by a circuit breaker plus
# the constraints.mask fault point: a failing compile NEVER blocks the
# solve — the tick falls back to the unconstrained-but-feasible encode
# (counted below, breaker fed) and recovers to the constrained fixed
# point once the fault clears (half-open probe succeeds -> closed).

_constraint_breaker = CircuitBreaker(failure_threshold=3, reset_s=30.0)
# degraded: the LAST constrained admission fell back — the feed memo's
# admission epoch keys on it to keep retrying until the compile heals
constraint_stats = {
    "compiles": 0,
    "fallbacks": 0,
    "short_circuits": 0,
    "degraded": False,
    "published_compiles": 0,
    "published_fallbacks": 0,
}


def reset_constraint_state() -> None:
    """Test / recovery-boot seam: fresh breaker, zeroed counters."""
    global _constraint_breaker
    _constraint_breaker = CircuitBreaker(failure_threshold=3, reset_s=30.0)
    constraint_stats.update(
        compiles=0, fallbacks=0, short_circuits=0, degraded=False,
        published_compiles=0, published_fallbacks=0,
    )


def _constraints_admitted() -> bool:
    """One breaker-gated admission per constrained encode. False means
    THIS tick encodes unconstrained (the never-block fallback); the
    breaker turns a persistently failing compile into cheap
    short-circuits and grants one probe per reset window, so clearing
    the fault restores the constrained fixed point."""
    from karpenter_tpu_torch.faults import inject

    if not _constraint_breaker.allow():
        constraint_stats["short_circuits"] += 1
        constraint_stats["fallbacks"] += 1
        constraint_stats["degraded"] = True
        return False
    try:
        inject("constraints.mask")
    except Exception as e:
        _constraint_breaker.record_failure(type(e).__name__)
        constraint_stats["fallbacks"] += 1
        constraint_stats["degraded"] = True
        return False
    _constraint_breaker.record_success()
    constraint_stats["compiles"] += 1
    constraint_stats["degraded"] = False
    return True

def _profile_candidates(nodes: List, selector: Dict[str, str]) -> List:
    """Ready+schedulable matching nodes, falling back to ANY matching
    node when none are ready (a group scaled to zero still needs a
    shape)."""
    matching = [
        n for n in nodes if matches_selector(n.metadata.labels, selector)
    ]
    ready = [n for n in matching if is_ready_and_schedulable(n)]
    return ready or matching


def _group_profile(
    nodes: List, selector: Dict[str, str]
) -> Tuple[Dict[str, float], set, set]:
    """(allocatable by resource name, labels set, taints set) for one group.

    Ready+schedulable nodes define the group's shape; when the group is empty
    we fall back to any node matching the selector (a group scaled to zero
    still needs a shape to reason about — a limitation shared with every
    pending-pods autoscaler that lacks instance-type metadata).

    The shape is the elementwise MIN over candidate nodes (a resource a node
    lacks counts as 0): in a heterogeneous group, claiming the max across
    nodes would invent a phantom node shape no real scale-up can deliver,
    and the signal would demand nodes forever without ever scheduling the
    pod. Min keeps the promise: any node the group adds can host what we
    report feasible.

    `nodes` is the full node list (listed ONCE per solve by the caller);
    selector filtering happens here to avoid O(groups) store scans.
    """
    candidates = _profile_candidates(nodes, selector)
    alloc: Dict[str, float] = {}
    labels: set = set()
    taints: set = set()
    for i, node in enumerate(candidates):
        node_alloc = {
            r: q.to_float() for r, q in node.status.allocatable.items()
        }
        if i == 0:
            alloc = node_alloc
        else:
            alloc = {
                r: min(alloc.get(r, 0.0), node_alloc.get(r, 0.0))
                for r in set(alloc) | set(node_alloc)
            }
        node_labels = set(node.metadata.labels.items())
        labels = node_labels if i == 0 else (labels & node_labels)
        # hard taints (NoSchedule/NoExecute) exclude pods;
        # PreferNoSchedule is carried too but only SCORES (the
        # kube-scheduler's TaintToleration plugin — scoring.py): the
        # encoder's intolerance bitset filters to hard effects
        taints |= {
            (t.key, t.value, t.effect)
            for t in node.spec.taints
            if t.effect
            in ("NoSchedule", "NoExecute", "PreferNoSchedule")
        }
    if candidates and alloc.get(RESOURCE_PODS, 0.0) <= 0:
        alloc[RESOURCE_PODS] = DEFAULT_PODS_PER_NODE
    return alloc, labels, taints




def _group_arrays(profiles, resources, taint_universe, label_universe,
                  n_groups, n_resources, n_taints, n_labels):
    group_allocatable = np.zeros((n_groups, n_resources), np.float32)
    group_taints = np.zeros((n_groups, n_taints), bool)
    group_labels = np.zeros((n_groups, n_labels), bool)
    for t, (alloc, labels, taints) in enumerate(profiles):
        for r, resource in enumerate(resources):
            group_allocatable[t, r] = alloc.get(resource, 0.0)
        for taint, k in taint_universe.items():
            group_taints[t, k] = taint in taints
        for item, l in label_universe.items():
            group_labels[t, l] = item in labels
    return group_allocatable, group_taints, group_labels


def _dedup_rows(snap):
    """Collapse identical pod rows into (row indices, multiplicities).

    Two pods with the same (requests vector, required labels, toleration
    shape, validity) are interchangeable to every solver stage — same
    feasibility row, same first-feasible group, same size bucket — so the
    solve is exact over distinct shapes weighted by count. This is what
    makes the device upload O(distinct shapes), not O(pods): fleets are
    dominated by replicated workloads (Deployments/Jobs stamp identical
    pod templates).

    Raw-byte uniqueness on the concatenated row bytes: float bit-equality
    only (never merges distinct values; -0.0 vs 0.0 over-splits, which is
    merely suboptimal, never wrong).

    Fast path: cache-produced snapshots carry the INCREMENTALLY-maintained
    dedup (store/columnar.PendingPodCache._dedup_slots) — one rep row +
    count per distinct live shape, maintained at watch-event time. Only
    the S rep rows (distinct shapes, fleet-scale constant) are byte-sorted
    here for deterministic row order; the np.unique-over-all-rows below is
    the fallback for hand-built snapshots, and was ~60 ms/tick of argsort
    at 100k pods. The incremental dedup indexes live slots only; free
    (valid=False, zeroed) rows are dropped rather than collapsed into a
    zero row — output-equal, since invalid rows never contribute to any
    solver aggregate.
    """
    hi = snap.requests.shape[0]
    if hi == 0 or (snap.dedup_idx is not None and len(snap.dedup_idx) == 0):
        # hi > 0 with an empty dedup is the pending set draining to zero
        # while freed arena rows remain — the normal all-pods-scheduled
        # state, not an error
        return np.zeros(0, np.intp), np.zeros(0, np.int32)

    if snap.dedup_idx is not None:
        # O(S log S), S tiny
        order = np.argsort(_row_bytes(snap, snap.dedup_idx))
        return snap.dedup_idx[order], snap.dedup_weight[order]

    _, idx, counts = np.unique(
        _row_bytes(snap, slice(None)), return_index=True, return_counts=True
    )
    return idx, counts.astype(np.int32)


def _row_bytes(snap, idx):
    """Concatenated raw bytes of the given snapshot rows, one void scalar
    per row — the canonical sort/uniqueness key of _dedup_rows."""
    # idx=slice(None) gives zero-copy views (the arrays are already
    # contiguous); index arrays (the fast path's rep rows) gather
    hi = snap.requests.shape[0]
    n = hi if isinstance(idx, slice) else len(idx)
    parts = [
        np.ascontiguousarray(snap.requests[idx])
        .view(np.uint8)
        .reshape(n, -1),
        np.ascontiguousarray(snap.required[idx])
        .view(np.uint8)
        .reshape(n, -1),
        np.ascontiguousarray(snap.shape_id[idx])
        .view(np.uint8)
        .reshape(n, -1),
        snap.valid[idx].astype(np.uint8).reshape(n, 1),
    ]
    if snap.priority is not None:
        # priority is row identity (steering + evictability): equal-spec
        # rows of different PriorityClasses must sort/dedup apart
        parts.append(
            np.ascontiguousarray(snap.priority[idx])
            .view(np.uint8)
            .reshape(n, -1)
        )
    for ids in (
        snap.affinity_id,
        snap.preferred_id,
        snap.spread_id,
        snap.anti_id,
        snap.soft_spread_id,
        snap.soft_anti_id,
    ):
        if ids is not None:
            parts.append(
                np.ascontiguousarray(ids[idx]).view(np.uint8).reshape(n, -1)
            )
    rows = np.ascontiguousarray(np.concatenate(parts, axis=1))
    return rows.view([("k", np.void, rows.shape[1])]).ravel()


def _dedup_rows_keyed(snap):
    """(row_idx, row_weight, keys): _dedup_rows plus the canonical sparse
    dedup keys (store/columnar.PendingSnapshot.dedup_keys) reordered into
    the same byte-sorted row order. keys is None when the snapshot lacks
    the incremental dedup — the delta layer then has no stable identity
    to diff on and falls back to a full encode."""
    if (
        snap.dedup_idx is None
        or snap.dedup_keys is None
        or snap.requests.shape[0] == 0
        or len(snap.dedup_idx) == 0
    ):
        row_idx, row_weight = _dedup_rows(snap)
        keys = (
            ()
            if snap.dedup_keys is not None and len(row_idx) == 0
            else None
        )
        return row_idx, row_weight, keys
    order = np.argsort(_row_bytes(snap, snap.dedup_idx))
    keys = tuple(snap.dedup_keys[i] for i in order)
    return snap.dedup_idx[order], snap.dedup_weight[order], keys


def _dedup_rows_constrained(snap, membership):
    """_dedup_rows with group membership appended to the row identity.

    Pod labels are deliberately NOT part of the incremental dedup key
    (store/columnar.dedup_key) — unconstrained fleets must not split
    otherwise-identical rows on label noise. When constraint groups are
    live, two spec-identical pods in DIFFERENT groups are no longer
    interchangeable, so the constrained encode re-dedups over
    (row bytes, membership) with np.unique here. O(N log N) over live
    rows, paid only by constraint-carrying producers."""
    hi = snap.requests.shape[0]
    if hi == 0:
        return np.zeros(0, np.intp), np.zeros(0, np.int32)
    rows = _row_bytes(snap, slice(None))
    keyed = np.empty(
        hi,
        dtype=[("k", rows.dtype["k"]), ("m", np.int32)],
    )
    keyed["k"] = rows["k"]
    keyed["m"] = np.asarray(membership, np.int32)
    _, idx, counts = np.unique(
        keyed, return_index=True, return_counts=True
    )
    return idx, counts.astype(np.int32)




def _resource_universe(snap, profiles):
    """(resources list, resource_index, pod slot): base resources plus
    every extended resource seen in requests or allocatable, the 'pods'
    slot axis always LAST (each pod occupies exactly 1)."""
    extended = {
        r for r in snap.resources
        if r not in RESOURCES_BASE and r != RESOURCE_PODS
    }
    for alloc, _, _ in profiles:
        extended |= {
            r for r in alloc
            if r not in RESOURCES_BASE and r != RESOURCE_PODS
        }
    resources = [*RESOURCES_BASE, *sorted(extended), RESOURCE_PODS]
    resource_index = {r: idx for idx, r in enumerate(resources)}
    return resources, resource_index, resources.index(RESOURCE_PODS)


def _pod_arrays(snap, row_idx, row_weight, resources, resource_index,
                pod_slot, n_pods, n_resources, n_taints, n_labels,
                taint_universe):
    """The per-pod solver operands, gathered in bulk from the snapshot:
    requests, validity, required-label bitset, intolerance bitset (one
    evaluation per DISTINCT toleration shape, gathered to rows by
    shape id), and the dedup multiplicities (padding rows weigh
    nothing)."""
    hi = len(row_idx)
    pod_requests = np.zeros((n_pods, n_resources), np.float32)
    pod_valid = np.zeros(n_pods, bool)
    pod_required = np.zeros((n_pods, n_labels), bool)
    pod_intolerant = np.zeros((n_pods, n_taints), bool)
    pod_weight = np.zeros(n_pods, np.int32)
    if hi:
        valid = snap.valid[row_idx]
        cols = np.array(
            [resource_index[r] for r in snap.resources], np.intp
        )
        pod_requests[:hi, cols] = snap.requests[row_idx]
        pod_requests[:hi, pod_slot] = valid.astype(np.float32)
        pod_valid[:hi] = valid
        pod_weight[:hi] = row_weight
        if snap.labels:
            pod_required[:hi, : len(snap.labels)] = snap.required[row_idx]
        if snap.shape_tolerations:
            taint_objects = {
                k: Taint(key=taint[0], value=taint[1], effect=taint[2])
                for taint, k in taint_universe.items()
            }
            rows = np.zeros((len(snap.shape_tolerations), n_taints), bool)
            for s, tolerations in enumerate(snap.shape_tolerations):
                for k, taint in taint_objects.items():
                    rows[s, k] = not any(
                        tol.tolerates(taint) for tol in tolerations
                    )
            pod_intolerant[:hi] = rows[snap.shape_id[row_idx]]
    return pod_requests, pod_valid, pod_required, pod_intolerant, pod_weight


def _affinity_forbidden(snap, row_idx, group_label_dicts, n_pods,
                        n_groups):
    """Required node affinity: matchExpression semantics (In/NotIn/
    Exists/DoesNotExist/Gt/Lt, OR'd terms) don't factor into the
    conjunctive required-label bitset, so each DISTINCT affinity shape
    is evaluated host-side against each group's label assignment (the
    profile label set — the INTERSECTION of node labels, i.e. the same
    conservative single-node shape the min-allocatable uses;
    heterogeneous groups may over-admit negative operators, the caveat
    _group_profile documents for resources) and the S_a x T verdicts
    gather to rows. None when no pod constrains affinity — the common
    fleet pays nothing. Gated on LIVE rows (shape id 0 =
    unconstrained): the shape registry retains entries until
    compaction, and a long-gone affinity Job must not keep the whole
    fleet on the masked (extra-operand) kernel path."""
    hi = len(row_idx)
    shapes = snap.affinity_shapes
    live = (
        snap.affinity_id[row_idx]
        if hi and snap.affinity_id is not None and shapes is not None
        else None
    )
    if live is None or not (live != 0).any():
        return None
    allowed = np.ones((len(shapes), n_groups), bool)
    for s in np.unique(live):  # only shapes in live use
        shape = shapes[s]
        if not shape:
            continue
        for t, labels in enumerate(group_label_dicts()):
            allowed[s, t] = matches_affinity_shape(labels, shape)
    forbidden = np.zeros((n_pods, n_groups), bool)
    forbidden[:hi] = ~allowed[live]
    return forbidden


def _taint_universe(profiles) -> Dict[tuple, int]:
    """Distinct HARD taints across group profiles -> bitset slot. Soft
    (PreferNoSchedule) taints ride the profiles into the scoring plugin
    and must never gate feasibility, so they never join the bitset."""
    universe: Dict[tuple, int] = {}
    for _, _, taints in profiles:
        for taint in sorted(taints):
            if taint[2] == "PreferNoSchedule":
                continue
            if taint not in universe:
                universe[taint] = len(universe)
    return universe


def _priority_tier_operands(snap, profiles, row_idx, n_pods, n_groups):
    """Priority + capacity-tier operands (ops/binpack.py steering,
    ops/preempt.py evictability) — each absent unless the fleet
    actually carries it (a nonzero-priority pod / a spot-labeled
    group), so priority-free fleets encode byte-identically to before
    these columns existed."""
    hi = len(row_idx)
    pod_priority = None
    if (
        snap.priority is not None
        and hi
        and bool((snap.priority[row_idx] != 0).any())
    ):
        pod_priority = np.zeros(n_pods, np.int32)
        pod_priority[:hi] = snap.priority[row_idx]
    group_tier = None
    tiers = [capacity_tier_of(labels) for _, labels, _ in profiles]
    if any(tiers):
        group_tier = np.zeros(n_groups, np.int32)
        group_tier[: len(profiles)] = tiers
    return pod_priority, group_tier


def _encode_full(  # lint: allow-complexity — the encode spine: one arm per optional operand family (priority/tier/spread/constraints)
    snap, profiles, with_rows: bool = False, census=None, constraints=None
):
    """Snapshot (store/columnar.PendingSnapshot) -> solver inputs, with
    rows DEDUPLICATED into distinct pod shapes + multiplicities
    (pod_weight) — see _dedup_rows. Every solve path (feed, pod_cache,
    oracle store.list) flows through here, so outputs stay identical
    across paths by construction.

    All per-pod work here is bulk numpy (column gathers, row gathers by
    toleration-shape id); the only Python loops left are over universes —
    resources, group profiles, taints, distinct toleration shapes — whose
    cardinalities are fleet-scale constants, not pod counts.
    """
    # group label dicts: built at most once, shared by the spread
    # expansion and the affinity/preferred evaluation blocks below
    label_dicts_box: list = []

    def group_label_dicts():
        if not label_dicts_box:
            label_dicts_box.append(
                [dict(labels) for _, labels, _ in profiles]
            )
        return label_dicts_box[0]

    # declarative constraint groups (karpenter_tpu/constraints): gated
    # through the breaker + fault point; denied admission encodes this
    # tick unconstrained (never-block fallback)
    membership = None
    if constraints and _constraints_admitted():
        if snap.labels_id is not None and snap.label_sets:
            membership = _cc.compile_membership(
                snap.label_sets, snap.labels_id, constraints
            )
        else:
            membership = np.zeros(snap.requests.shape[0], np.int32)

    if membership is not None and bool((membership != 0).any()):
        # membership joins the row identity: spec-identical pods in
        # different groups are no longer interchangeable
        row_idx, row_weight = _dedup_rows_constrained(snap, membership)
    else:
        row_idx, row_weight = _dedup_rows(snap)
    # hard topology spread: constrained rows split into balanced
    # per-domain sub-rows (same source row gathered more than once, each
    # chunk masked to its domain's groups) — the device program is
    # unchanged, spread rides the existing forbidden-mask operand
    row_idx, row_weight, spread_forbidden = _expand_spread_rows(
        snap, profiles, row_idx, row_weight, group_label_dicts,
        census=census,
    )
    # required self pod-(anti-)affinity: hostname rows flag the
    # pod_exclusive operand, domain keys cap one replica per domain
    # (further sub-row expansion; the spread mask rides through)
    row_idx, row_weight, spread_forbidden, row_exclusive = (
        _expand_anti_rows(
            snap, profiles, row_idx, row_weight, spread_forbidden,
            group_label_dicts, census=census,
        )
    )

    # compile the declarative groups over the final row set; the
    # spread-quota pre-split (compiled.rep) regathers every per-row
    # array built so far
    compiled = None
    if membership is not None:
        compiled = _cc.compile_rows(
            membership[row_idx],
            row_weight,
            snap.valid[row_idx],
            profiles,
            constraints,
        )
        row_idx = row_idx[compiled.rep]
        row_weight = compiled.row_weight
        if spread_forbidden is not None:
            spread_forbidden = spread_forbidden[compiled.rep]
        if row_exclusive is not None:
            row_exclusive = row_exclusive[compiled.rep]
    hi = len(row_idx)

    resources, resource_index, pod_slot = _resource_universe(
        snap, profiles
    )
    n_resources = _pad(len(resources), RESOURCE_PAD)

    taint_universe = _taint_universe(profiles)
    label_universe = {item: l for l, item in enumerate(snap.labels)}

    n_pods = _pad(hi, POD_PAD)
    n_groups = _pad(len(profiles), GROUP_PAD)
    n_taints = _pad(len(taint_universe), TAINT_PAD)
    n_labels = _pad(len(label_universe), LABEL_PAD)

    (pod_requests, pod_valid, pod_required, pod_intolerant,
     pod_weight) = _pod_arrays(
        snap, row_idx, row_weight, resources, resource_index, pod_slot,
        n_pods, n_resources, n_taints, n_labels, taint_universe,
    )

    group_allocatable, group_taints, group_labels = _group_arrays(
        profiles, resources, taint_universe, label_universe,
        n_groups, n_resources, n_taints, n_labels,
    )

    pod_group_forbidden = _affinity_forbidden(
        snap, row_idx, group_label_dicts, n_pods, n_groups
    )

    # Topology spread + self pod-(anti-)affinity: OR the per-sub-row
    # masks into the same forbidden operand the affinity path uses
    # (padding groups are all-zero allocatable and already infeasible,
    # so mask width T_real suffices)
    if spread_forbidden is not None:
        if pod_group_forbidden is None:
            pod_group_forbidden = np.zeros((n_pods, n_groups), bool)
        pod_group_forbidden[:hi, : len(profiles)] |= spread_forbidden

    # declarative anti-affinity members take whole nodes too: OR into
    # the same exclusivity rows the hostname self-anti path flags
    if compiled is not None and compiled.exclusive is not None:
        row_exclusive = (
            compiled.exclusive
            if row_exclusive is None
            else (row_exclusive | compiled.exclusive)
        )

    # hostname self-anti-affinity rows take a whole node each — absent
    # unless some live pod actually carries the constraint
    pod_exclusive = None
    if row_exclusive is not None and row_exclusive.any():
        pod_exclusive = np.zeros(n_pods, bool)
        pod_exclusive[:hi] = row_exclusive

    # Scoring operand (ops/binpack.py pod_group_score): the kube-
    # scheduler's scoring plugins modeled over groups — preferred node
    # affinity, ScheduleAnyway spread, preferred self pod-(anti-)
    # affinity — absent unless some live pod actually prefers
    pod_group_score = _score_rows(
        snap, profiles, row_idx, group_label_dicts, census,
        n_pods, n_groups,
    )

    pod_priority, group_tier = _priority_tier_operands(
        snap, profiles, row_idx, n_pods, n_groups
    )

    # constraint-plane operands, padded to the bucketed extents (padding
    # pod rows are invalid and weightless; padding groups are all-zero
    # allocatable — both inert to every mask term). Each operand pair
    # stays None unless the compile produced it, so constraint-free
    # fleets ship today's wire byte for byte.
    pod_claim = group_reservation = None
    pod_pack_class = None
    pod_spread_slot = group_domain = spread_cap = None
    if compiled is not None:
        if compiled.claim is not None:
            pod_claim = np.zeros(n_pods, np.int32)
            pod_claim[:hi] = compiled.claim
            group_reservation = np.zeros(n_groups, np.int32)
            group_reservation[: len(profiles)] = (
                compiled.group_reservation
            )
        if compiled.pack_class is not None:
            pod_pack_class = np.zeros(
                (n_pods, compiled.pack_class.shape[1]), bool
            )
            pod_pack_class[:hi] = compiled.pack_class
        if compiled.spread_slot is not None:
            pod_spread_slot = np.zeros(n_pods, np.int32)
            pod_spread_slot[:hi] = compiled.spread_slot
            group_domain = np.zeros(n_groups, np.int32)
            group_domain[: len(profiles)] = compiled.group_domain
            spread_cap = compiled.spread_cap.copy()

    inputs = B.BinPackInputs(
        pod_requests=pod_requests,
        pod_valid=pod_valid,
        pod_intolerant=pod_intolerant,
        pod_required=pod_required,
        group_allocatable=group_allocatable,
        group_taints=group_taints,
        group_labels=group_labels,
        pod_weight=pod_weight,
        pod_group_forbidden=pod_group_forbidden,
        pod_group_score=pod_group_score,
        pod_exclusive=pod_exclusive,
        pod_priority=pod_priority,
        group_tier=group_tier,
        pod_claim=pod_claim,
        group_reservation=group_reservation,
        pod_pack_class=pod_pack_class,
        pod_spread_slot=pod_spread_slot,
        group_domain=group_domain,
        spread_cap=spread_cap,
    )
    if with_rows:
        # the simulation API maps per-row solver outputs back to pods:
        # row i of `inputs` gathers snapshot row row_idx[i] (an arena
        # slot) with multiplicity row_weight[i]
        return inputs, row_idx, row_weight
    return inputs


# -- incremental (delta) encoding --------------------------------------------


class ResidentPlan:
    """The changed-row map between two consecutive delta encodes — what
    the device-resident fleet state (solver/resident.py) scatters
    instead of re-uploading the full operand stack.

    `prev` is the PREVIOUS tick's BinPackInputs (held strongly: the
    plan is only useful while a resident buffer keyed on that identity
    exists); `rows` are the positions whose spliced operand rows
    (requests/valid/required/intolerant) differ from prev's, and
    `weight_rows` the positions whose dedup multiplicity moved (a
    scaled Deployment changes weights without changing any key). Both
    are exact: a row is listed iff its bytes changed, so scattering
    exactly these rows reproduces a cold full upload bit for bit."""

    __slots__ = ("prev", "rows", "weight_rows")

    def __init__(self, prev, rows, weight_rows):
        self.prev = prev
        self.rows = np.asarray(rows, np.int32)
        self.weight_rows = np.asarray(weight_rows, np.int32)


# id(inputs) -> (weakref-to-inputs, ResidentPlan), written by every
# SnapshotDeltaCache instance and read by ResidentFleetState.
# BinPackInputs is an eq-dataclass (unhashable), so the registry keys
# on id() with a weakref guard: the stored ref must still resolve to
# the SAME object, and a finalizer removes the entry on GC so a reused
# id can never alias a dead plan. Registering a successor plan drops
# the predecessor's entry, so prev-chains never grow past one hop.
_plan_registry: Dict[int, tuple] = {}
# RLock, not Lock: the GC can run a plan finalizer (_drop_plan) on
# whatever thread triggered collection — including one that is already
# inside _register_plan holding this lock
_plan_lock = threading.RLock()


def resident_plan(inputs) -> Optional["ResidentPlan"]:
    """The changed-row plan for a delta-encoded inputs object, or None
    (cold/full encode, or a non-delta caller)."""
    with _plan_lock:
        entry = _plan_registry.get(id(inputs))
        if entry is None or entry[0]() is not inputs:
            return None
        return entry[1]


def _drop_plan(key: int) -> None:
    with _plan_lock:
        _plan_registry.pop(key, None)


def _register_plan(inputs, plan: "ResidentPlan") -> None:
    with _plan_lock:
        _plan_registry[id(inputs)] = (weakref.ref(inputs), plan)
        # cap the identity chain: the predecessor's own plan (if any)
        # is unreachable through a resident entry once this successor
        # exists
        _plan_registry.pop(id(plan.prev), None)
    weakref.finalize(inputs, _drop_plan, id(inputs))


def reset_resident_plans() -> None:
    """Recovery-boot seam companion to SnapshotDeltaCache.reset: a plan
    computed against pre-reset state must not splice into post-reset
    resident buffers."""
    with _plan_lock:
        _plan_registry.clear()


class _DeltaEntry:
    """One cached encode per (group-set, universe) key: the canonical
    sorted dedup keys, their row positions, the operand arrays those
    positions index, and the BinPackInputs built from them. Arrays are
    never mutated after construction — a delta builds NEW arrays and
    splices cached rows across, so inputs objects handed to callers (and
    any identity-keyed device cache holding them) stay frozen."""

    __slots__ = (
        "profiles", "resources", "resource_index", "pod_slot",
        "taint_universe", "keys", "pos", "row_weight",
        "n_pods", "n_resources", "n_taints", "n_labels",
        "inputs",
    )

    def __init__(self, keys, row_weight, n_pods, inputs):
        self.keys = keys
        self.pos = {key: i for i, key in enumerate(keys)}
        self.row_weight = np.asarray(row_weight)
        self.n_pods = n_pods
        self.inputs = inputs

    def successor(self, keys, row_weight, n_pods, inputs) -> "_DeltaEntry":
        """Next-tick entry sharing every universe-derived field (equal
        by the eligibility checks) — ONE construction path, so a field
        added to the entry can't be populated on the cold path only."""
        entry = _DeltaEntry(keys, row_weight, n_pods, inputs)
        entry.profiles = self.profiles
        entry.resources = self.resources
        entry.resource_index = self.resource_index
        entry.pod_slot = self.pod_slot
        entry.taint_universe = self.taint_universe
        entry.n_resources = self.n_resources
        entry.n_taints = self.n_taints
        entry.n_labels = self.n_labels
        return entry


class SnapshotDeltaCache:
    """Delta layer over _encode_full: caches the last encoded snapshot
    per (group-set, resource-universe) key and answers the next tick by
    splicing unchanged rows instead of rebuilding _pod_arrays /
    _group_arrays from scratch.

    Output parity is BIT-IDENTICAL to a full re-encode, by construction:

      * rows are matched on the CANONICAL sparse dedup key
        (store/columnar.PendingSnapshot.dedup_keys) — the identity that
        survives slot reuse, universe growth, and arena compaction. With
        equal resource/label universes and the same group profiles, the
        same key encodes to the same operand row byte for byte, so a
        copied row equals a recomputed one;
      * row ORDER is the same byte-sort _dedup_rows canonicalizes, so
        matched rows land at the positions a full encode would put them;
      * fresh rows are produced by the SAME _pod_arrays code path on
        just their subset, then scattered into position.

    The fast path only engages for the unconstrained fleet (no live
    affinity / spread / anti / soft-score rows, no census, no with_rows)
    — everything else, and any universe or profile change, falls back to
    _encode_full (which also refreshes the cache entry). Group profiles
    are compared by IDENTITY: the runtime's NodeMirror memoizes profile
    tuples, so unchanged nodes present the same objects every tick, and
    a recomputed profile (node churn) invalidates naturally.

    An unchanged dedup set returns the SAME BinPackInputs OBJECT, so
    identity-keyed device-residency caches skip the host->device
    transfer even when the pod set churned through identical shapes."""

    _MAX_ENTRIES = 4  # distinct (group-set, universe) keys kept live

    def __init__(self):
        import collections
        import threading

        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()
        # observability: identical-set hits, row-level deltas, full passes
        self.hits = 0
        self.deltas = 0
        self.fulls = 0

    def reset(self) -> None:
        """Recovery-boot seam (docs/resilience.md "Crash recovery"):
        drop every cached entry. The delta layer's fast path returns the
        SAME BinPackInputs OBJECT for an unchanged dedup set — an
        identity contract downstream device-residency caches key on —
        so after a crash-recovery boot the pre-crash entries must not be
        splice sources: the next encode of each key is a full pass.
        Resident scatter plans (the device-residency companion) drop
        with the entries — a plan against pre-reset state must never
        splice into post-reset device buffers."""
        with self._lock:
            self._entries.clear()
        reset_resident_plans()

    def encode(
        self,
        snap,
        profiles,
        with_rows: bool = False,
        census=None,
        constraints=None,
    ):
        if (
            with_rows
            or census is not None
            # constraint groups re-key the dedup (membership joins the
            # row identity) and attach operands the splice doesn't
            # carry: always a full pass
            or constraints
            # no incremental dedup (hand-built / oracle snapshots): bail
            # BEFORE the keyed dedup pass, or a 100k-row snapshot would
            # pay the O(N) np.unique row sort twice (here and inside
            # _encode_full)
            or snap.dedup_idx is None
            or snap.dedup_keys is None
        ):
            self.fulls += 1
            return _encode_full(
                snap, profiles, with_rows=with_rows, census=census,
                constraints=constraints,
            )
        row_idx, row_weight, keys = _dedup_rows_keyed(snap)
        if keys is None or self._live_constraints(snap, row_idx):
            self.fulls += 1
            return _encode_full(snap, profiles, census=census)
        cache_key = (
            len(profiles),
            tuple(snap.resources),
            tuple(snap.labels),
        )
        with self._lock:
            return self._encode_locked(
                cache_key, snap, profiles, row_idx, row_weight, keys
            )

    def _encode_locked(
        self, cache_key, snap, profiles, row_idx, row_weight, keys
    ):
        entry = self._entries.get(cache_key)
        if entry is not None and self._entry_valid(entry, profiles):
            n_pods = _pad(len(row_idx), POD_PAD)
            if (
                entry.keys == keys
                and entry.n_pods == n_pods
                and np.array_equal(entry.row_weight, row_weight)
            ):
                self.hits += 1
                self._entries.move_to_end(cache_key)
                return entry.inputs
            self.deltas += 1
            entry = self._apply_delta(
                entry, snap, row_idx, row_weight, keys, n_pods
            )
        else:
            self.fulls += 1
            entry = self._build_entry(
                snap, profiles, row_idx, row_weight, keys
            )
        self._entries[cache_key] = entry
        self._entries.move_to_end(cache_key)
        while len(self._entries) > self._MAX_ENTRIES:
            self._entries.popitem(last=False)
        return entry.inputs

    @staticmethod
    def _live_constraints(snap, row_idx) -> bool:
        """Any live row carrying affinity/spread/anti/soft shapes routes
        to the full encode (those operands need census + row expansion);
        id 0 is always the unconstrained shape. Nonzero-priority rows
        route there too: the delta layer does not splice the
        pod_priority operand, and priority fleets are preemption-scale
        (small), so the full encode is cheap where it matters."""
        if len(row_idx) == 0:
            return False
        if snap.priority is not None and bool(
            (snap.priority[row_idx] != 0).any()
        ):
            return True
        for ids in (
            snap.affinity_id,
            snap.preferred_id,
            snap.spread_id,
            snap.anti_id,
            snap.soft_spread_id,
            snap.soft_anti_id,
        ):
            if ids is not None and bool((ids[row_idx] != 0).any()):
                return True
        return False

    @staticmethod
    def _entry_valid(entry, profiles) -> bool:
        # identity, not equality: profile tuples are memoized upstream
        # (NodeMirror), so pointer-equal means node state unchanged, and
        # value comparison would cost what _group_arrays costs
        return len(entry.profiles) == len(profiles) and all(
            a is b for a, b in zip(entry.profiles, profiles)
        )

    def _build_entry(self, snap, profiles, row_idx, row_weight, keys):
        """Cold path: one _encode_full pass, then index its output rows
        by dedup key so the next tick can splice from them. The cached
        inputs ARE the full encode's output — parity is definitional."""
        inputs = _encode_full(snap, profiles)
        entry = _DeltaEntry(
            keys, row_weight, inputs.pod_requests.shape[0], inputs
        )
        entry.profiles = list(profiles)
        entry.resources, entry.resource_index, entry.pod_slot = (
            _resource_universe(snap, profiles)
        )
        entry.taint_universe = _taint_universe(profiles)
        entry.n_resources = inputs.pod_requests.shape[1]
        entry.n_taints = inputs.pod_intolerant.shape[1]
        entry.n_labels = inputs.pod_required.shape[1]
        return entry

    def _apply_delta(self, entry, snap, row_idx, row_weight, keys, n_pods):
        """Row-level splice: copy rows whose canonical key survived from
        the cached arrays, gather only the fresh rows through the normal
        _pod_arrays path, and reuse the group arrays untouched.

        Also publishes the ResidentPlan for the new inputs: a row is
        CHANGED unless its key matched AT THE SAME POSITION (same key
        elsewhere means the byte-sorted order moved — the resident
        buffer's row at that position holds different bytes either
        way), and weight rows are diffed value-wise since multiplicity
        is not part of the key."""
        hi = len(row_idx)
        matched_new, matched_old, fresh_new = [], [], []
        in_place = []
        for i, key in enumerate(keys):
            j = entry.pos.get(key)
            if j is None:
                fresh_new.append(i)
            else:
                matched_new.append(i)
                matched_old.append(j)
                if j == i:
                    in_place.append(i)

        pod_requests = np.zeros((n_pods, entry.n_resources), np.float32)
        pod_valid = np.zeros(n_pods, bool)
        pod_required = np.zeros((n_pods, entry.n_labels), bool)
        pod_intolerant = np.zeros((n_pods, entry.n_taints), bool)
        pod_weight = np.zeros(n_pods, np.int32)

        old = entry.inputs
        if matched_new:
            m_new = np.asarray(matched_new, np.intp)
            m_old = np.asarray(matched_old, np.intp)
            pod_requests[m_new] = old.pod_requests[m_old]
            pod_valid[m_new] = old.pod_valid[m_old]
            pod_required[m_new] = old.pod_required[m_old]
            pod_intolerant[m_new] = old.pod_intolerant[m_old]
        if fresh_new:
            f_new = np.asarray(fresh_new, np.intp)
            sub = _pod_arrays(
                snap,
                row_idx[f_new],
                row_weight[f_new],
                entry.resources,
                entry.resource_index,
                entry.pod_slot,
                len(fresh_new),
                entry.n_resources,
                entry.n_taints,
                entry.n_labels,
                entry.taint_universe,
            )
            pod_requests[f_new] = sub[0]
            pod_valid[f_new] = sub[1]
            pod_required[f_new] = sub[2]
            pod_intolerant[f_new] = sub[3]
        pod_weight[:hi] = row_weight

        inputs = B.BinPackInputs(
            pod_requests=pod_requests,
            pod_valid=pod_valid,
            pod_intolerant=pod_intolerant,
            pod_required=pod_required,
            group_allocatable=old.group_allocatable,
            group_taints=old.group_taints,
            group_labels=old.group_labels,
            pod_weight=pod_weight,
            # tier is a pure function of the (identity-equal) profiles:
            # reuse like the other group arrays. pod_priority needs no
            # splice — priority rows never reach the delta path
            # (_live_constraints).
            group_tier=old.group_tier,
        )
        if n_pods == entry.n_pods:
            # the device-resident scatter plan (solver/resident.py):
            # only meaningful when the padded extent held — a bucket
            # crossing rebuilds the resident stack anyway
            hi_old = len(entry.keys)
            span = max(hi, hi_old)
            changed = np.ones(span, bool)
            if in_place:
                changed[np.asarray(in_place, np.intp)] = False
            w_new = np.zeros(span, np.int32)
            w_new[:hi] = row_weight
            w_old = np.asarray(old.pod_weight[:span], np.int32)
            _register_plan(
                inputs,
                ResidentPlan(
                    prev=old,
                    rows=np.nonzero(changed)[0],
                    weight_rows=np.nonzero(w_new != w_old)[0],
                ),
            )
        return entry.successor(keys, row_weight, n_pods, inputs)


_default_delta = SnapshotDeltaCache()


def reset_delta_cache() -> None:
    """Invalidate the process-default SnapshotDeltaCache (the recovery
    boot calls this — see SnapshotDeltaCache.reset)."""
    _default_delta.reset()


def _encode_from_cache(
    snap, profiles, with_rows: bool = False, census=None, constraints=None
):
    """THE encode seam (public face: pendingcapacity.encode_snapshot):
    delta-accelerated when the process-default SnapshotDeltaCache has a
    matching entry, bit-identical to _encode_full always."""
    # injection point (faults/registry.py): a failed encode is a
    # producer-reconcile failure — row-isolated by solve_pending, then
    # ridden down the engine's retryable-backoff ladder
    from karpenter_tpu_torch.faults import inject

    inject("encoder.encode")
    return _default_delta.encode(
        snap, profiles, with_rows=with_rows, census=census,
        constraints=constraints,
    )


