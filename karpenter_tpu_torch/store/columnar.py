"""Incremental columnar snapshot of pending pods — the device feed path.

SURVEY.md §7 hard part (d): at 100k pods the bin-pack device call is ~0.1 ms
but a naive host feed is seconds — store.list() deep-copies every Pod and a
Python loop re-encodes requests/tolerations/selectors EVERY tick. The
reference never solved this (its pending-capacity producer is a stub,
reference: pkg/metrics/producers/pendingcapacity/producer.go:29-31, and its
design doc concedes the naive form "scales linearly ... as the cluster
grows", docs/designs/DESIGN.md).

The TPU-first answer is the same one informers give the reference's Go
controllers (watch once, index incrementally — reference:
pkg/controllers/manager.go:73-79 pod index): subscribe to store watch
events and maintain the solver's input arrays *incrementally*:

- slot-allocated columnar arena: requests (float32 N×R), required-label
  bitset (bool N×L), toleration-shape id (int32 N), valid mask
- universes (resource names, selector label pairs, toleration shapes) grow
  in arrival order; when churn leaves the arena or the universes mostly
  dead (peak >> live), a compaction pass rebuilds both from the retained
  per-slot sparse records — amortized O(live), no store access, so costs
  track the LIVE pending set, not the historical peak
- a pod is parsed ONCE at its lifecycle event (Quantity → float, selector →
  bitset), not once per tick; per-tick feed cost is O(changed pods), and
  snapshot() is a bulk numpy copy
- downstream, the chain stays incremental all the way to the chip: the
  encoder's delta layer (pendingcapacity/encoder.SnapshotDeltaCache)
  splices only the changed rows and publishes a ResidentPlan, and the
  solver's device-resident fleet state (solver/resident.py) applies it
  as a batched scatter — an unchanged dedup set costs zero host encode
  AND zero host->device upload (docs/solver-service.md
  "Device-resident fleet state")

Intolerance vs the (node-derived) taint universe cannot be cached here —
taints belong to groups and change with nodes — so the cache stores each
pod's toleration SHAPE id; the per-tick solve computes one row per distinct
shape (fleets share a handful) and gathers rows by id.

The same encoder also serves the non-cached oracle path:
snapshot_from_pods() runs a detached (watch-free) cache over a pod list,
so there is exactly ONE encode implementation and the cached path can never
drift from the documented list semantics.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.api.core import affinity_shape as _affinity_shape
from karpenter_tpu_torch.api.core import pod_affinity_shape as _pod_affinity_shape
from karpenter_tpu_torch.api.core import preferred_shape as _preferred_shape
from karpenter_tpu_torch.api.core import (
    soft_pod_affinity_shape as _soft_pod_affinity_shape,
)
from karpenter_tpu_torch.api.core import soft_spread_shape as _soft_spread_shape
from karpenter_tpu_torch.api.core import spread_shape as _spread_shape
from karpenter_tpu_torch.api.core import selector_form_matches
from karpenter_tpu_torch.store.store import DELETED, Store

# seed columns; extended resources append after in arrival order.
# (pendingcapacity.py's RESOURCES_BASE aliases this — single definition.)
BASE_RESOURCES = ("cpu", "memory")
RESOURCE_PODS = "pods"

_GROW = 2  # arena growth factor
_COMPACT_FACTOR = 4  # compact when peak > factor × live
_COMPACT_FLOOR = 256  # ...and peak is at least this big


def is_pending(pod) -> bool:
    """Unschedulable set: unbound and not yet running/finished (the
    reference's pending-pods definition, DESIGN.md 'Pending Pods')."""
    return not pod.spec.node_name and pod.status.phase in ("", "Pending")


def _intern(shapes: List[tuple], index: Dict[tuple, int], shape: tuple) -> int:
    """Shape-registry intern: one id per distinct canonical tuple; id 0
    is always the empty/unconstrained shape (seeded at arena reset)."""
    sid = index.get(shape)
    if sid is None:
        sid = len(shapes)
        index[shape] = sid
        shapes.append(shape)
    return sid


def _adopt_and_watch(store: Store, kind: str, on_event) -> None:
    """Seed from the store's current objects, then subscribe — both under
    the store lock so no event lands in the gap. The single definition of
    the watch-mirror init contract for every cache in this module."""
    with store._lock:
        for obj in store.list(kind):
            on_event("Added", obj)
        store.watch(kind, on_event)


@dataclass
class _SparsePod:
    """Per-slot retained encoding — enough to rebuild arenas on compaction
    without touching the store (no store-lock acquisition from the cache
    side, so lock order is strictly store → cache)."""

    requests: List[Tuple[str, float]]
    selector: List[Tuple[str, str]]
    shape: tuple
    tolerations: list
    priority: int = 0  # resolved scheduling priority (api/core)
    affinity: tuple = ()  # canonical required-node-affinity shape
    preferred: tuple = ()  # canonical preferred-node-affinity shape
    spread: tuple = ()  # canonical hard topology-spread shape
    anti: tuple = ()  # canonical self pod-(anti-)affinity shape
    soft_spread: tuple = ()  # canonical ScheduleAnyway spread shape
    soft_anti: tuple = ()  # canonical preferred self pod-(anti-)affinity
    labels: tuple = ()  # sorted pod label items (constraint-group membership)


class PendingPodCache:
    """Watch-maintained columnar arena of pending-pod solver inputs.

    store=None builds a DETACHED encoder (no watch, no adoption) used by
    snapshot_from_pods() — the oracle path reuses the exact same encode.
    """

    def __init__(
        self,
        store: Optional[Store] = None,
        capacity: int = 1024,
        default_priority: int = 0,
    ):
        # fleet default for pods naming an unknown PriorityClass (the
        # --default-priority knob); resolved spec.priority always wins
        self._default_priority = default_priority
        self._lock = threading.Lock()
        # generation counts MUTATIONS (upsert/remove/compact), not resets:
        # snapshot() memoizes on it, and downstream encode/device caches key
        # on it to skip re-encoding + re-transferring an unchanged fleet
        self._generation = 0
        self._snap_memo: Optional[Tuple[int, "PendingSnapshot"]] = None
        self._reset_arena(max(16, capacity))

        if store is not None:
            _adopt_and_watch(store, "Pod", self._on_event)

    def _reset_arena(self, capacity: int) -> None:
        self._resources: List[str] = list(BASE_RESOURCES)
        self._resource_index: Dict[str, int] = {
            r: i for i, r in enumerate(BASE_RESOURCES)
        }
        self._labels: List[Tuple[str, str]] = []
        self._label_index: Dict[Tuple[str, str], int] = {}
        self._shapes: List[tuple] = []
        self._shape_index: Dict[tuple, int] = {}
        self._shape_tolerations: List[list] = []
        # required-node-affinity shapes (api/core.affinity_shape tuples);
        # id 0 is the unconstrained shape so zeroed slots stay neutral
        self._affinity_shapes: List[tuple] = [()]
        self._affinity_index: Dict[tuple, int] = {(): 0}
        # preferred-node-affinity shapes (api/core.preferred_shape)
        self._preferred_shapes: List[tuple] = [()]
        self._preferred_index: Dict[tuple, int] = {(): 0}
        # hard topology-spread shapes (api/core.spread_shape)
        self._spread_shapes: List[tuple] = [()]
        self._spread_index: Dict[tuple, int] = {(): 0}
        # self pod-(anti-)affinity shapes (api/core.pod_affinity_shape)
        self._anti_shapes: List[tuple] = [()]
        self._anti_index: Dict[tuple, int] = {(): 0}
        # SOFT (scored, never constraining) shapes: ScheduleAnyway
        # spread + preferred self pod-(anti-)affinity
        self._soft_spread_shapes: List[tuple] = [()]
        self._soft_spread_index: Dict[tuple, int] = {(): 0}
        self._soft_anti_shapes: List[tuple] = [()]
        self._soft_anti_index: Dict[tuple, int] = {(): 0}
        # distinct pod label SETS (constraint-plane membership input;
        # id 0 = unlabeled). NOT part of the dedup key: label churn on
        # identical specs must not split rows for unconstrained fleets —
        # constraint-active encodes re-dedup with membership appended
        # (encoder._dedup_rows_constrained).
        self._label_sets: List[tuple] = [()]
        self._label_set_index: Dict[tuple, int] = {(): 0}
        # incremental shape-dedup: canonical pod key -> live slots with that
        # key. Maintained at event time so snapshot() emits (rep row,
        # multiplicity) pairs in O(distinct shapes) — the per-tick
        # np.unique over ALL rows it replaces was the top host cost of a
        # churned 100k-pod tick (~60 ms of argsort).
        self._dedup_slots: Dict[tuple, set] = {}
        self._slot_key: Dict[int, tuple] = {}

        self._requests = np.zeros(
            (capacity, len(self._resources) + 4), np.float32
        )
        self._required = np.zeros((capacity, 8), bool)
        self._priority = np.zeros(capacity, np.int32)
        self._shape_id = np.zeros(capacity, np.int32)
        self._affinity_id = np.zeros(capacity, np.int32)
        self._preferred_id = np.zeros(capacity, np.int32)
        self._spread_id = np.zeros(capacity, np.int32)
        self._anti_id = np.zeros(capacity, np.int32)
        self._soft_spread_id = np.zeros(capacity, np.int32)
        self._soft_anti_id = np.zeros(capacity, np.int32)
        self._labels_id = np.zeros(capacity, np.int32)
        self._valid = np.zeros(capacity, bool)

        self._slot: Dict[Tuple[str, str], int] = {}
        self._sparse: Dict[int, _SparsePod] = {}
        self._free: List[int] = []
        self._hi = 0  # slots [0, _hi) have ever been used

    # -- watch path --------------------------------------------------------

    def _on_event(self, event: str, pod) -> None:
        key = (pod.metadata.namespace, pod.metadata.name)
        with self._lock:
            if event == DELETED or not is_pending(pod):
                self._remove(key)
            else:
                self._upsert(key, pod)

    def _remove(self, key) -> None:
        slot = self._slot.pop(key, None)
        if slot is None:
            return
        self._generation += 1
        self._valid[slot] = False
        self._requests[slot, :] = 0.0
        self._required[slot, :] = False
        self._priority[slot] = 0
        self._shape_id[slot] = 0
        self._affinity_id[slot] = 0
        self._preferred_id[slot] = 0
        self._spread_id[slot] = 0
        self._anti_id[slot] = 0
        self._soft_spread_id[slot] = 0
        self._soft_anti_id[slot] = 0
        self._labels_id[slot] = 0
        self._sparse.pop(slot, None)
        self._dedup_discard(slot)
        self._free.append(slot)

    def _dedup_discard(self, slot: int) -> None:
        dedup_key = self._slot_key.pop(slot, None)
        if dedup_key is None:
            return
        slots = self._dedup_slots.get(dedup_key)
        if slots is not None:
            slots.discard(slot)
            if not slots:
                del self._dedup_slots[dedup_key]

    def _upsert(self, key, pod) -> None:
        from karpenter_tpu_torch.api.core import effective_priority

        sparse = _SparsePod(
            # effective_requests: the SCHEDULER's fit semantics (init
            # containers max'd against the container sum, overhead added) —
            # the bin-pack must see what a real kube-scheduler would fit,
            # or the scale-up signal undersizes pods with heavy init phases
            requests=[
                (resource, quantity.to_float())
                for resource, quantity in pod.effective_requests().items()
                if quantity.to_float() > 0 and resource != RESOURCE_PODS
            ],
            selector=sorted(pod.spec.node_selector.items()),
            shape=tuple(
                sorted(
                    (t.key, t.operator, t.value, t.effect)
                    for t in pod.spec.tolerations
                )
            ),
            tolerations=list(pod.spec.tolerations),
            affinity=_affinity_shape(pod.spec.affinity),
            preferred=_preferred_shape(pod.spec.affinity),
            spread=_spread_shape(
                pod.spec.topology_spread_constraints,
                pod.metadata.namespace,
                pod.metadata.labels,
            ),
            anti=_pod_affinity_shape(
                pod.spec.affinity,
                pod.metadata.labels,
                pod.metadata.namespace,
            ),
            soft_spread=_soft_spread_shape(
                pod.spec.topology_spread_constraints,
                pod.metadata.namespace,
                pod.metadata.labels,
            ),
            soft_anti=_soft_pod_affinity_shape(
                pod.spec.affinity,
                pod.metadata.labels,
                pod.metadata.namespace,
            ),
            priority=effective_priority(
                pod, default=self._default_priority
            ),
            labels=tuple(sorted((pod.metadata.labels or {}).items())),
        )
        slot = self._slot.get(key)
        if slot is None:
            slot = self._alloc()
            self._slot[key] = slot
        self._generation += 1
        self._encode(slot, sparse)

    def _encode(self, slot: int, sparse: _SparsePod) -> None:
        self._requests[slot, :] = 0.0
        self._required[slot, :] = False
        for resource, value in sparse.requests:
            idx = self._resource_col(resource)
            self._requests[slot, idx] = value
        for item in sparse.selector:
            # resolve the column BEFORE subscripting: _label_col may
            # replace self._required with a grown copy
            idx = self._label_col(item)
            self._required[slot, idx] = True
        shape_id = self._shape_index.get(sparse.shape)
        if shape_id is None:
            shape_id = len(self._shapes)
            self._shape_index[sparse.shape] = shape_id
            self._shapes.append(sparse.shape)
            self._shape_tolerations.append(sparse.tolerations)
        self._shape_id[slot] = shape_id
        self._affinity_id[slot] = _intern(
            self._affinity_shapes, self._affinity_index, sparse.affinity
        )
        self._preferred_id[slot] = _intern(
            self._preferred_shapes, self._preferred_index, sparse.preferred
        )
        self._spread_id[slot] = _intern(
            self._spread_shapes, self._spread_index, sparse.spread
        )
        self._anti_id[slot] = _intern(
            self._anti_shapes, self._anti_index, sparse.anti
        )
        self._soft_spread_id[slot] = _intern(
            self._soft_spread_shapes,
            self._soft_spread_index,
            sparse.soft_spread,
        )
        self._soft_anti_id[slot] = _intern(
            self._soft_anti_shapes,
            self._soft_anti_index,
            sparse.soft_anti,
        )
        self._labels_id[slot] = _intern(
            self._label_sets, self._label_set_index, sparse.labels
        )
        self._priority[slot] = sparse.priority
        self._valid[slot] = True
        self._sparse[slot] = sparse
        # dedup maintenance: two slots share a key iff their canonical
        # sparse encodings match, which (with stable universe columns)
        # guarantees identical arena rows. Resource order in `requests` is
        # dict-iteration order, so sort for canonicality; selector/shape
        # are already sorted at build time. Priority is part of shape
        # identity: it drives steering and evictability, so equal-spec
        # pods of different PriorityClasses must not collapse.
        dedup_key = (
            tuple(sorted(sparse.requests)),
            tuple(sparse.selector),
            sparse.shape,
            sparse.affinity,
            sparse.preferred,
            sparse.spread,
            sparse.anti,
            sparse.soft_spread,
            sparse.soft_anti,
            sparse.priority,
        )
        if self._slot_key.get(slot) != dedup_key:
            self._dedup_discard(slot)
            self._slot_key[slot] = dedup_key
            self._dedup_slots.setdefault(dedup_key, set()).add(slot)

    # -- compaction --------------------------------------------------------

    def _needs_compaction(self) -> bool:
        """O(1) unless a cheap precondition trips: the O(live) live-set
        scans below only run when a universe has already crossed the
        absolute floor — snapshot() on a healthy cache stays a bulk copy."""
        live = len(self._slot)
        if self._hi >= _COMPACT_FLOOR and self._hi > _COMPACT_FACTOR * live:
            return True
        for registry, ids in (
            (self._shapes, self._shape_id),
            (self._affinity_shapes, self._affinity_id),
            (self._preferred_shapes, self._preferred_id),
            (self._spread_shapes, self._spread_id),
            (self._anti_shapes, self._anti_id),
            (self._soft_spread_shapes, self._soft_spread_id),
            (self._soft_anti_shapes, self._soft_anti_id),
            (self._label_sets, self._labels_id),
        ):
            if len(registry) >= _COMPACT_FLOOR:
                live_ids = len(
                    {int(ids[s]) for s in self._slot.values()}
                )
                if len(registry) > _COMPACT_FACTOR * max(1, live_ids):
                    return True
        if len(self._labels) >= _COMPACT_FLOOR:
            live_labels: set = set()
            for sparse in self._sparse.values():
                live_labels.update(sparse.selector)
            if len(self._labels) > _COMPACT_FACTOR * max(1, len(live_labels)):
                return True
        return False

    def _compact(self) -> None:
        """Rebuild arenas + universes from live sparse records: O(live),
        restoring cost proportional to the live pending set after a peak
        (incident) has drained or per-job universes have churned."""
        records = [
            (key, self._sparse[slot]) for key, slot in self._slot.items()
        ]
        capacity = 16
        while capacity < 2 * max(1, len(records)):
            capacity *= _GROW
        self._generation += 1  # row order / universes may change
        self._reset_arena(capacity)
        for key, sparse in records:
            slot = self._alloc()
            self._slot[key] = slot
            self._encode(slot, sparse)

    # -- arena management --------------------------------------------------

    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        if self._hi == self._requests.shape[0]:
            self._requests = self._grow_rows(self._requests)
            self._required = self._grow_rows(self._required)
            self._priority = self._grow_rows(self._priority)
            self._shape_id = self._grow_rows(self._shape_id)
            self._affinity_id = self._grow_rows(self._affinity_id)
            self._preferred_id = self._grow_rows(self._preferred_id)
            self._spread_id = self._grow_rows(self._spread_id)
            self._anti_id = self._grow_rows(self._anti_id)
            self._soft_spread_id = self._grow_rows(self._soft_spread_id)
            self._soft_anti_id = self._grow_rows(self._soft_anti_id)
            self._labels_id = self._grow_rows(self._labels_id)
            self._valid = self._grow_rows(self._valid)
        slot = self._hi
        self._hi += 1
        return slot

    @staticmethod
    def _grow_rows(arr: np.ndarray) -> np.ndarray:
        shape = (arr.shape[0] * _GROW, *arr.shape[1:])
        out = np.zeros(shape, arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    def _resource_col(self, resource: str) -> int:
        idx = self._resource_index.get(resource)
        if idx is None:
            idx = len(self._resources)
            self._resource_index[resource] = idx
            self._resources.append(resource)
            if idx == self._requests.shape[1]:
                self._requests = self._grow_cols(self._requests)
        return idx

    def _label_col(self, item: Tuple[str, str]) -> int:
        idx = self._label_index.get(item)
        if idx is None:
            idx = len(self._labels)
            self._label_index[item] = idx
            self._labels.append(item)
            if idx == self._required.shape[1]:
                self._required = self._grow_cols(self._required)
        return idx

    @staticmethod
    def _grow_cols(arr: np.ndarray) -> np.ndarray:
        out = np.zeros((arr.shape[0], arr.shape[1] * _GROW), arr.dtype)
        out[:, : arr.shape[1]] = arr
        return out

    # -- solve-side read ---------------------------------------------------

    def snapshot(self) -> "PendingSnapshot":
        """Bulk-copy the live region; O(pending pods) numpy memcpy, no
        Python-per-pod work. Compacts first when peak >> live.

        Memoized per generation: an unchanged arena returns the SAME
        snapshot object, so callers can key their own derived caches
        (encoded solver inputs, device-resident buffers) on identity or
        on `snapshot.generation`. This identity chain is load-bearing:
        snapshot identity -> delta-cache hit -> same BinPackInputs
        object -> ResidentFleetState identity hit (zero upload), so
        snapshot() must never return equal-but-distinct objects for an
        unchanged generation."""
        with self._lock:
            if self._needs_compaction():
                self._compact()
            if (
                self._snap_memo is not None
                and self._snap_memo[0] == self._generation
            ):
                return self._snap_memo[1]
            hi = self._hi
            # one items() walk so keys/reps/weights share the dict order:
            # dedup_keys[i] is the CANONICAL sparse key of the shape that
            # dedup_idx[i]/dedup_weight[i] describe — the stable identity
            # the encoder's delta layer diffs consecutive snapshots on
            # (slot ids and universe ids churn; the canonical key doesn't)
            dedup_items = list(self._dedup_slots.items())
            reps = np.fromiter(
                (next(iter(s)) for _, s in dedup_items),
                np.intp,
                len(dedup_items),
            )
            weights = np.fromiter(
                (len(s) for _, s in dedup_items),
                np.int32,
                len(dedup_items),
            )
            snap = PendingSnapshot(
                requests=self._requests[:hi, : len(self._resources)].copy(),
                required=self._required[:hi, : len(self._labels)].copy(),
                priority=self._priority[:hi].copy(),
                shape_id=self._shape_id[:hi].copy(),
                valid=self._valid[:hi].copy(),
                resources=list(self._resources),
                labels=list(self._labels),
                shape_tolerations=[list(t) for t in self._shape_tolerations],
                generation=self._generation,
                dedup_idx=reps,
                dedup_weight=weights,
                dedup_keys=tuple(k for k, _ in dedup_items),
                affinity_id=self._affinity_id[:hi].copy(),
                affinity_shapes=list(self._affinity_shapes),
                preferred_id=self._preferred_id[:hi].copy(),
                preferred_shapes=list(self._preferred_shapes),
                spread_id=self._spread_id[:hi].copy(),
                spread_shapes=list(self._spread_shapes),
                anti_id=self._anti_id[:hi].copy(),
                anti_shapes=list(self._anti_shapes),
                soft_spread_id=self._soft_spread_id[:hi].copy(),
                soft_spread_shapes=list(self._soft_spread_shapes),
                soft_anti_id=self._soft_anti_id[:hi].copy(),
                soft_anti_shapes=list(self._soft_anti_shapes),
                labels_id=self._labels_id[:hi].copy(),
                label_sets=list(self._label_sets),
            )
            self._snap_memo = (self._generation, snap)
            return snap

    def __len__(self) -> int:
        with self._lock:
            return len(self._slot)


class NodeMirror:
    """Watch-maintained mirror of Node objects with memoized group
    profiles.

    _group_profile (pendingcapacity.py) is O(nodes) per selector with
    Python-level label matching; recomputing it for every producer every
    5 s tick costs O(producers × nodes) even when no node changed. The
    mirror holds the store's Node set current via watch events and
    memoizes profile(selector) until ANY node event invalidates (node
    churn is orders slower than the reconcile tick). Lock order is
    strictly store → mirror: events only touch mirror state, profile
    computation never touches the store.
    """

    def __init__(self, store: Store, profile_fn):
        self._lock = threading.Lock()
        self._profile_fn = profile_fn  # (nodes, selector) -> profile
        self._nodes: Dict[Tuple[str, str], object] = {}
        self._memo: Dict[tuple, object] = {}
        self._version = 0
        _adopt_and_watch(store, "Node", self._on_event)

    def _on_event(self, event: str, node) -> None:
        key = (node.metadata.namespace, node.metadata.name)
        with self._lock:
            if event == DELETED:
                self._nodes.pop(key, None)
            else:
                self._nodes[key] = node
            self._memo.clear()
            self._version += 1

    @property
    def version(self) -> int:
        """Node-event counter; bumps on any node churn. Lets callers key
        profile-derived caches (encoded group arrays) on it."""
        with self._lock:
            return self._version

    def nodes(self, selector: Optional[Dict[str, str]] = None) -> list:
        """Current node objects, optionally filtered by label selector.
        Returned refs are safe to read: event-delivered copies are never
        mutated in place."""
        from karpenter_tpu_torch.api.core import matches_selector

        with self._lock:
            values = list(self._nodes.values())
        if selector is None:
            return values
        return [
            n for n in values if matches_selector(n.metadata.labels, selector)
        ]

    def profile(self, selector: Dict[str, str]):
        key = tuple(sorted(selector.items()))
        # the O(nodes) profile pass runs OUTSIDE the mirror lock: watch
        # callbacks (which run under the store lock) must never wait on a
        # profile recomputation, or every store operation stalls behind it.
        # Event-delivered node copies are never mutated in place, so
        # computing over a snapshot of the refs is safe.
        with self._lock:
            cached = self._memo.get(key)
            if cached is not None:
                return cached
            nodes = list(self._nodes.values())
            version = self._version
        profile = self._profile_fn(nodes, selector)
        with self._lock:
            if self._version == version:
                self._memo[key] = profile
            # stale (a node event landed mid-compute): return this tick's
            # consistent-at-read value uncached; the next tick recomputes
        return profile


class ReservationsCache:
    """Watch-maintained per-node reserved-resource sums — the incremental
    feed for the ReservedCapacity producer (reference hot loop #2,
    SURVEY.md §3.5: O(nodes + pods) exact Quantity additions per 5 s tick).

    Every BOUND pod's container requests (and its 1 'pods' slot) are added
    to its node's running total exactly once, at its lifecycle event;
    rebinding/resize/delete applies the exact inverse (Fraction arithmetic
    is exact, so incremental add/subtract equals a fresh sum). A tick then
    reads O(nodes-in-group) cached sums instead of iterating every pod.

    Display-format caveat: Quantity.add adopts the FIRST non-zero
    operand's format, so in a fleet mixing formats for one resource
    (e.g. "1Gi" and "1000M" memory) the rendered status string may pick a
    different (value-equal) canonical form than a fresh sum would.
    """

    def __init__(self, store: Store):
        from karpenter_tpu_torch.api.core import RESOURCE_PODS as _PODS
        from karpenter_tpu_torch.utils.quantity import Quantity

        self._lock = threading.Lock()
        self._quantity = Quantity
        self._pods_resource = _PODS
        # pod key -> (node_name, {resource: Quantity incl. the pods slot})
        self._pod_records: Dict[Tuple[str, str], Tuple[str, dict]] = {}
        # node name -> {resource: Quantity}
        self._node_sums: Dict[str, dict] = {}
        _adopt_and_watch(store, "Pod", self._on_event)

    def _record_for(self, pod) -> Optional[Tuple[str, dict]]:
        if not pod.spec.node_name:
            return None
        # Pod.requests() is THE accumulation semantics (container-level
        # only, reference reservations.go); the cache must never drift
        requests = pod.requests()
        requests[self._pods_resource] = self._quantity.parse("1")
        return (pod.spec.node_name, requests)

    def _on_event(self, event: str, pod) -> None:
        key = (pod.metadata.namespace, pod.metadata.name)
        new = None if event == DELETED else self._record_for(pod)
        with self._lock:
            old = self._pod_records.pop(key, None)
            if old is not None:
                node, requests = old
                sums = self._node_sums.get(node)
                if sums is not None:
                    for resource, quantity in requests.items():
                        sums[resource] = sums[resource].sub(quantity)
                    if all(q.value == 0 for q in sums.values()):
                        # node drained (or deleted): drop the entry, or a
                        # node-churning fleet leaks one dict per node name
                        # ever seen
                        del self._node_sums[node]
            if new is not None:
                self._pod_records[key] = new
                node, requests = new
                sums = self._node_sums.setdefault(node, {})
                for resource, quantity in requests.items():
                    current = sums.get(resource)
                    sums[resource] = (
                        quantity if current is None else current.add(quantity)
                    )

    def reserved_on(self, node_names) -> dict:
        """{resource: Quantity} summed over the given nodes (exact)."""
        with self._lock:
            totals: dict = {}
            for name in node_names:
                for resource, quantity in self._node_sums.get(
                    name, {}
                ).items():
                    current = totals.get(resource)
                    totals[resource] = (
                        quantity
                        if current is None
                        else current.add(quantity)
                    )
            return totals


def is_counted(pod) -> bool:
    """Occupancy set: pods BOUND to a node and not terminal — the pods
    the kube-scheduler counts when evaluating topology spread skew and
    inter-pod (anti-)affinity domains against an incoming pod. Assigned-
    but-still-Pending pods count (they hold their domain); Succeeded/
    Failed pods don't block a domain the scheduler would reuse."""
    return bool(pod.spec.node_name) and pod.status.phase not in (
        "Succeeded",
        "Failed",
    )


class ScheduledOccupancy:
    """Watch-maintained census of SCHEDULED pods, grouped by
    (namespace, exact label set) with per-node counts — the existing-pod
    side of topology-spread skew and self-(anti-)affinity domain
    occupancy (producers/pendingcapacity.DomainCensus).

    Shape: {namespace: {labels_items_tuple: {node_name: count}}}.
    Replicated workloads collapse to one label group per namespace
    (plus one per pod for per-pod labels like the StatefulSet pod-name
    label). Event-time cost is O(1 + registered views) per pod
    transition.

    MATERIALIZED VIEWS (`view_counts`): per-pod-unique labels fragment
    a 100k-replica StatefulSet into 100k label groups, so answering a
    selector by scanning groups costs ~600 ms per occupancy epoch —
    over the tick budget by itself. Instead, each distinct query
    selector registers a view {node: matching-pod count}, built ONCE by
    a scan and then maintained incrementally at event time (each bound
    pod transition evaluates the pod's labels against the registered
    selector forms — a fleet-scale-constant set, LRU-capped). Queries
    read the view: O(nodes with matching pods), never O(label groups).

    Readers MUST use view() (raw groups) or view_counts(); the lock is
    held for the (short) duration of either. store=None builds a
    detached census (occupancy_from_pods).
    """

    # registered selector views are LRU-capped: every event updates the
    # views of ITS namespace, so a leak of stale selectors would tax
    # the event path. Above the cap (more distinct live (namespace,
    # selector) pairs than this, queried every solve) eviction thrashes
    # and each rebuild is a group scan under the lock — view_evictions
    # (published as karpenter_runtime_census_view_evictions_total)
    # makes that visible instead of silent.
    VIEW_CAP = 1024

    def __init__(self, store: Optional[Store] = None):
        self._lock = threading.Lock()
        self._generation = 0
        self._spaces: Dict[str, Dict[tuple, Dict[str, int]]] = {}
        # pod key -> (namespace, labels_items, node_name) for exact undo
        self._pods: Dict[Tuple[str, str], Tuple[str, tuple, str]] = {}
        # (namespace, selector form) -> {node: matching pod count}
        self._views: Dict[tuple, Dict[str, int]] = {}
        self._views_by_ns: Dict[str, Dict[tuple, Dict[str, int]]] = {}
        self._view_clock = 0
        self._view_used: Dict[tuple, int] = {}
        # cumulative LRU evictions — cap-thrash observability
        self.view_evictions = 0
        if store is not None:
            _adopt_and_watch(store, "Pod", self._on_event)

    def _view_delta(self, namespace, labels_items, node, delta) -> None:
        forms = self._views_by_ns.get(namespace)
        if not forms:
            return
        labels = dict(labels_items)
        for form, view in forms.items():
            if not selector_form_matches(form, labels):
                continue
            count = view.get(node, 0) + delta
            if count > 0:
                view[node] = count
            else:
                view.pop(node, None)

    def _on_event(self, event: str, pod) -> None:
        key = (pod.metadata.namespace, pod.metadata.name)
        entry = None
        if event != DELETED and is_counted(pod):
            entry = (
                pod.metadata.namespace,
                tuple(sorted(pod.metadata.labels.items())),
                pod.spec.node_name,
            )
        with self._lock:
            prev = self._pods.get(key)
            if prev == entry:
                return
            self._generation += 1
            if prev is not None:
                namespace, labels, node = prev
                groups = self._spaces.get(namespace, {})
                nodes = groups.get(labels)
                if nodes is not None:
                    count = nodes.get(node, 0) - 1
                    if count > 0:
                        nodes[node] = count
                    else:
                        nodes.pop(node, None)
                        if not nodes:
                            del groups[labels]
                            if not groups:
                                del self._spaces[namespace]
                self._view_delta(namespace, labels, node, -1)
            if entry is None:
                self._pods.pop(key, None)
            else:
                self._pods[key] = entry
                namespace, labels, node = entry
                nodes = self._spaces.setdefault(namespace, {}).setdefault(
                    labels, {}
                )
                nodes[node] = nodes.get(node, 0) + 1
                self._view_delta(namespace, labels, node, +1)

    @property
    def generation(self) -> int:
        """Mutation counter — downstream query memos key on it."""
        with self._lock:
            return self._generation

    def namespace_names(self) -> set:
        """Namespaces holding scheduled pods — the conservative
        namespaceSelector fallback scope (DomainCensus)."""
        with self._lock:
            return set(self._spaces)

    @contextlib.contextmanager
    def view(self):
        """(generation, {namespace: {labels_items: {node: count}}})
        under the census lock — treat as read-only, don't retain past
        the with-block."""
        with self._lock:
            yield self._generation, self._spaces

    def _view_locked(self, namespace: str, sel_form: tuple) -> dict:
        """Resolve-or-build one view; caller holds the lock."""
        key = (namespace, sel_form)
        self._view_clock += 1
        view = self._views.get(key)
        if view is None:
            view = {}
            for labels_items, nodes in self._spaces.get(
                namespace, {}
            ).items():
                if selector_form_matches(sel_form, dict(labels_items)):
                    for node, n in nodes.items():
                        view[node] = view.get(node, 0) + n
            self._views[key] = view
            self._views_by_ns.setdefault(namespace, {})[sel_form] = view
            if len(self._views) > self.VIEW_CAP:
                evict = min(
                    (k for k in self._views if k != key),
                    key=lambda k: self._view_used.get(k, 0),
                )
                del self._views[evict]
                self._views_by_ns.get(evict[0], {}).pop(evict[1], None)
                self._view_used.pop(evict, None)
                self.view_evictions += 1
        self._view_used[key] = self._view_clock
        return view

    def view_counts(
        self, namespace: str, sel_form: tuple
    ) -> Tuple[int, Dict[str, int]]:
        """(generation, {node: count of scheduled pods matching the
        canonical selector form}) — the materialized-view read. First
        use of a selector builds its view by one scan (under the lock:
        consistency beats a one-time stall); every later read is a
        small copy kept current by the event path."""
        with self._lock:
            return self._generation, dict(
                self._view_locked(namespace, sel_form)
            )

    def view_counts_many(
        self, namespace: str, sel_forms
    ) -> Tuple[int, List[Dict[str, int]]]:
        """view_counts for several selectors under ONE lock hold — the
        results are a single-generation-consistent set (a pod event
        landing between per-form reads could otherwise show a moved
        replica on neither node)."""
        with self._lock:
            return self._generation, [
                dict(self._view_locked(namespace, form))
                for form in sel_forms
            ]


def occupancy_from_pods(pods) -> ScheduledOccupancy:
    """Oracle path: one-shot census of a pod list through the SAME
    accounting the watch-maintained census uses (detached mode)."""
    census = ScheduledOccupancy(store=None)
    for pod in pods:
        census._on_event("Added", pod)
    return census


class ProducerSelectorIndex:
    """Watch-maintained {key: (node_selector, node_group_ref,
    constraint_groups)} of every pendingCapacity MetricsProducer — the
    solve needs ONLY the selector, scale-from-zero ref, and declared
    constraint groups of non-due producers (their status writes land on
    discarded copies anyway; gauges are keyed by name/namespace), so
    listing + deep-copying every producer object per tick is
    avoidable."""

    def __init__(self, store: Store):
        self._lock = threading.Lock()
        self._specs: Dict[
            Tuple[str, str], Tuple[Dict[str, str], str, tuple]
        ] = {}
        _adopt_and_watch(store, "MetricsProducer", self._on_event)

    def _on_event(self, event: str, mp) -> None:
        key = (mp.metadata.namespace, mp.metadata.name)
        selector, ref, constraints = None, "", ()
        if event != DELETED and mp.spec.pending_capacity is not None:
            selector = mp.spec.pending_capacity.node_selector
            ref = getattr(mp.spec.pending_capacity, "node_group_ref", "")
            constraints = tuple(
                getattr(mp.spec.pending_capacity, "constraints", None)
                or ()
            )
            try:
                selector = dict(selector)
            except TypeError:
                # poisoned spec (e.g. null selector): index it verbatim —
                # a watch callback must NEVER raise (it runs under the
                # store's notify path, shared by every watcher), and the
                # per-row guard in solve_pending contains the blast radius
                # to this one producer at solve time
                pass
        with self._lock:
            if event == DELETED or mp.spec.pending_capacity is None:
                self._specs.pop(key, None)
            else:
                self._specs[key] = (selector, ref, constraints)

    def items(
        self,
    ) -> List[Tuple[Tuple[str, str], Tuple[Dict[str, str], str, tuple]]]:
        """(key, (selector, node_group_ref, constraint_groups)) in
        deterministic (namespace, name) order — the group-axis order of
        the solve."""
        with self._lock:
            return sorted(self._specs.items())


class PendingFeed:
    """The full incremental feed for the pending-pods solve: pod arena +
    node profiles + producer selectors, all watch-maintained. One object
    so the factory wires one thing and solve_pending takes one seam."""

    def __init__(
        self, store: Store, profile_fn, node_mirror=None,
        default_priority: int = 0,
    ):
        self.pods = PendingPodCache(
            store, default_priority=default_priority
        )
        self.nodes = (
            node_mirror
            if node_mirror is not None
            else NodeMirror(store, profile_fn)
        )
        self.producers = ProducerSelectorIndex(store)
        # existing-pod domain occupancy for spread/anti fidelity; the
        # solve path lazily attaches its memoizing DomainCensus here
        self.occupancy = ScheduledOccupancy(store)
        self.census = None
        # owned by the feed, WRITTEN by the solve path
        # (metrics/producers/pendingcapacity.solve_pending): memoizes the
        # last (fingerprint, BinPackInputs) so an unchanged fleet reuses
        # the same inputs OBJECT and the solver's identity-keyed device
        # cache skips the host->device transfer. The fingerprint covers
        # pods.snapshot().generation, nodes.version, the producer
        # (selector, nodeGroupRef) set, and the RESOLVED scale-from-zero
        # template profiles — so any reset/replacement of those caches,
        # and any provider-template change (within the resolver's TTL),
        # invalidates it naturally.
        self.encode_memo: Optional[tuple] = None


def snapshot_from_pods(pods) -> "PendingSnapshot":
    """Oracle path: one-shot encode of a pod list through the SAME encoder
    the watch-maintained cache uses (detached mode — no store, no watch)."""
    cache = PendingPodCache(store=None, capacity=max(16, len(pods)))
    for pod in pods:
        if is_pending(pod):
            cache._upsert(
                (pod.metadata.namespace, pod.metadata.name), pod
            )
    return cache.snapshot()


@dataclass(slots=True, eq=False, repr=False)  # ndarray fields: identity eq,
class PendingSnapshot:                        # no 100k-row reprs in logs
    requests: np.ndarray
    required: np.ndarray
    shape_id: np.ndarray
    valid: np.ndarray
    resources: List[str]
    labels: List[Tuple[str, str]]
    shape_tolerations: List[list]
    generation: int = 0  # arena mutation counter at snapshot time
    # incremental dedup (None on hand-built snapshots: _dedup_rows then
    # falls back to np.unique over all rows): representative row index +
    # multiplicity per distinct live pod shape, unordered — the encoder
    # canonicalizes order by row bytes
    dedup_idx: Optional[np.ndarray] = None
    dedup_weight: Optional[np.ndarray] = None
    # canonical sparse dedup keys aligned with dedup_idx/dedup_weight:
    # the shape identity that survives slot reuse, universe growth, and
    # compaction — what the encoder's delta layer matches rows on across
    # consecutive snapshots. None on hand-built snapshots.
    dedup_keys: Optional[tuple] = None
    # resolved scheduling priority per row (api/core.effective_priority;
    # part of the dedup identity). None on hand-built snapshots = every
    # row priority 0 — the encoder then emits NO priority operand, so
    # priority-free fleets solve exactly as before.
    priority: Optional[np.ndarray] = None
    # required node affinity: per-row shape id into affinity_shapes
    # (canonical api/core.affinity_shape tuples; id 0 = unconstrained).
    # None on hand-built snapshots = no pod constrains affinity.
    affinity_id: Optional[np.ndarray] = None
    affinity_shapes: Optional[List[tuple]] = None
    # preferred node affinity (api/core.preferred_shape; id 0 = none)
    preferred_id: Optional[np.ndarray] = None
    preferred_shapes: Optional[List[tuple]] = None
    # hard topology spread (api/core.spread_shape; id 0 = unconstrained)
    spread_id: Optional[np.ndarray] = None
    spread_shapes: Optional[List[tuple]] = None
    # self pod-(anti-)affinity (api/core.pod_affinity_shape; id 0 = none)
    anti_id: Optional[np.ndarray] = None
    anti_shapes: Optional[List[tuple]] = None
    # SOFT (scored) shapes: ScheduleAnyway spread + preferred self
    # pod-(anti-)affinity (api/core.soft_{spread,pod_affinity}_shape)
    soft_spread_id: Optional[np.ndarray] = None
    soft_spread_shapes: Optional[List[tuple]] = None
    soft_anti_id: Optional[np.ndarray] = None
    soft_anti_shapes: Optional[List[tuple]] = None
    # pod label sets (constraint-group membership): per-row id into
    # label_sets (id 0 = unlabeled). None on hand-built snapshots = no
    # membership data, constraint groups match nothing.
    labels_id: Optional[np.ndarray] = None
    label_sets: Optional[List[tuple]] = None
