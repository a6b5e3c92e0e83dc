"""Existing-pod domain occupancy queries (DomainCensus) and the
per-row node-filter tokens the spread/anti expansions key their
memos on. See the class docstring for the memoization contract."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.api.core import matches_affinity_shape, selector_form_matches

class DomainCensus:
    """Existing-pod domain occupancy: the query layer between a
    ScheduledOccupancy census (store/columnar) and the spread/anti row
    expansions. The kube-scheduler evaluates topology spread skew and
    inter-pod (anti-)affinity against the pods ALREADY PLACED; without
    these counts the signal could promise a placement (e.g. a replica
    into a zone that already holds one) the scheduler then refuses.

    All queries are memoized per (occupancy generation, node version)
    epoch, so steady-state ticks answer from the memo; the underlying
    census and node mirror are incremental, so nothing here scans the
    store. Node-side work (label extraction, per-row node filters) and
    pod-side work (selector evaluation over distinct label sets) are
    memoized independently.

    Pod-side reads go through the census's MATERIALIZED VIEWS
    (ScheduledOccupancy.view_counts): per-pod-unique labels fragment a
    100k-replica StatefulSet into 100k label groups, and a per-epoch
    group scan costs ~600 ms — over the tick budget by itself. A
    selector's view is built once and maintained at event time, so a
    churned tick's recompute here is O(nodes with matching pods).
    """

    def __init__(self, occupancy, nodes_fn, node_version_fn=None):
        self._occupancy = occupancy
        self._nodes_fn = nodes_fn  # () -> list of Node objects
        self._node_version_fn = node_version_fn or (lambda: 0)
        # Namespace objects FROZEN per solve (set_namespaces): the
        # encode-memo fingerprint and the namespaceSelector resolution
        # must read the same snapshot, or a label change landing
        # between the two reads caches an encode under a state it was
        # not computed from
        self._namespaces: list = []
        self._epoch: Optional[tuple] = None
        self._memo: Dict[tuple, object] = {}
        self._node_memo: Dict[tuple, object] = {}
        self._named_labels: Optional[List[Tuple[str, dict]]] = None
        # epoch invalidations (bound-pod or node churn between solves);
        # published as karpenter_runtime_census_refresh_total so an
        # operator can see how often constrained ticks pay a recompute.
        # `published`/`evictions_published` are _publish_census
        # watermarks.
        self.refreshes = 0
        self.published = 0
        self.evictions_published = 0

    def _fresh(self, generation: int) -> None:
        epoch = (generation, self._node_version_fn())
        if epoch != self._epoch:
            self._epoch = epoch
            self._memo.clear()
            self._node_memo.clear()
            self._named_labels = None
            self.refreshes += 1

    def _node_counts(self, namespace, sel_form) -> Dict[str, int]:
        """Epoch check + {node: matching-pod count} for one selector,
        through the census's materialized view. Unmemoized on purpose:
        the view read is O(matching nodes) and the epoch check must run
        BEFORE any memo is consulted (a cached answer from a previous
        occupancy generation must never serve this one)."""
        generation, counts = self._occupancy.view_counts(
            namespace, sel_form
        )
        self._fresh(generation)
        return counts

    def _fresh_now(self) -> None:
        self._fresh(self._occupancy.generation)

    def _nodes(self) -> List[Tuple[str, dict]]:
        if self._named_labels is None:
            self._named_labels = [
                (n.metadata.name, dict(n.metadata.labels))
                for n in self._nodes_fn()
            ]
        return self._named_labels

    def spread(
        self, namespace, sel_form, split_key, filter_token, node_passes
    ) -> Tuple[Dict[str, int], set]:
        """(counts: {domain value: matching-pod count}, present: domain
        values among filter-passing live nodes) for one spread
        constraint. The node filter is the ROW's nodeSelector + required
        node affinity (nodeAffinityPolicy=Honor, the k8s default; taints
        are Ignored per the nodeTaintsPolicy default): only nodes the
        incoming pod could land on define domains and contribute counts.
        """
        # O(1) epoch check BEFORE any memo lookup (a cached answer from
        # a previous occupancy generation must never serve this one);
        # the view is only copied on memo miss
        self._fresh_now()
        memo_hit = self._memo.get(
            ("spread", namespace, sel_form, split_key, filter_token)
        )
        by_node = (
            self._node_counts(namespace, sel_form)
            if memo_hit is None and sel_form is not None
            else {}
        )
        node_key = (split_key, filter_token)
        node_side = self._node_memo.get(node_key)
        if node_side is None:
            passing: Dict[str, str] = {}
            present: set = set()
            for name, labels in self._nodes():
                value = labels.get(split_key)
                if value is None or not node_passes(labels):
                    continue
                passing[name] = value
                present.add(value)
            node_side = (passing, present)
            self._node_memo[node_key] = node_side
        passing, present = node_side
        memo_key = ("spread", namespace, sel_form, split_key,
                    filter_token)
        got = self._memo.get(memo_key)
        if got is None:
            counts: Dict[str, int] = {}
            for node, n in by_node.items():
                value = passing.get(node)
                if value is not None:
                    counts[value] = counts.get(value, 0) + n
            got = (counts, present)
            self._memo[memo_key] = got
        return got

    def set_namespaces(self, namespaces: list) -> None:
        """Freeze the Namespace set for this solve (see __init__)."""
        self._namespaces = list(namespaces)

    def known_namespace_names(self) -> set:
        return {ns.metadata.name for ns in self._namespaces}

    def namespaces_matching(self, ns_sel_form: tuple) -> set:
        """Names of live namespaces whose labels match the canonical
        namespaceSelector form (empty form = all namespaces, the k8s
        rule)."""
        return {
            ns.metadata.name
            for ns in self._namespaces
            if selector_form_matches(ns_sel_form, ns.metadata.labels)
        }

    def occupancy_namespaces(self) -> set:
        """Every namespace the occupancy census holds scheduled pods
        in — the conservative ANTI fallback when no Namespace objects
        exist to resolve a namespaceSelector against (fixtures,
        simulations): blocking against every known namespace's pods
        can only under-promise."""
        return self._occupancy.namespace_names()

    def domain_counts(self, namespace, sel_form, key) -> Dict[str, int]:
        """{topology value: matching-pod count} over ALL live nodes —
        the scoring-side census (soft spread / preferred inter-pod
        affinity score existing placements; no node filter applies to
        a preference). One counting implementation: this is spread()
        with the pass-all node filter, sharing its memos — the same
        token the hard path's nodeAffinityPolicy=Ignore case uses."""
        counts, _present = self.spread(
            namespace, sel_form, key, ("ignore",), lambda labels: True
        )
        return counts

    def matching_nodes(self, namespace, sel_form) -> set:
        """Node names hosting scheduled pods matching the selector —
        the hostname-key census. kubernetes.io/hostname domains ARE
        node names (the kubelet's well-known label), so this reads the
        materialized per-node view directly instead of requiring the
        label on Node objects (fixtures often omit it)."""
        return set(self._node_counts(namespace, sel_form))

    def _workload_nodes(self, namespace, sel_forms) -> tuple:
        """(any_nodes, all_nodes_or_None): node-name sets occupied by
        pods matching ANY of the workload's selectors (the anti-blocking
        set — over-blocking is conservative) and, for co-location, the
        nodes hosting a matching pod for EVERY live selector — the
        scheduler's per-term rule: each required term is satisfied by a
        domain holding a pod matching THAT term's selector (they need
        not be the same pod). all_nodes is None when NO selector has a
        matching scheduled pod anywhere in the namespace (the k8s
        first-replica bootstrap: a required self-affinity term with no
        matching pod cluster-wide imposes nothing). All forms are read
        under ONE census lock hold (view_counts_many) so the set is
        generation-consistent — a replica moving nodes between
        per-form reads could otherwise appear on neither."""
        # O(1) epoch check before the memo (stale answers must never
        # cross occupancy generations)
        self._fresh_now()
        memo_key = ("workload", namespace, sel_forms)
        got = self._memo.get(memo_key)
        if got is not None:
            return got
        generation, per_form = self._occupancy.view_counts_many(
            namespace, sel_forms
        )
        self._fresh(generation)
        any_nodes: set = set()
        for counts in per_form:
            any_nodes |= counts.keys()
        live = [counts for counts in per_form if counts]
        all_nodes: Optional[set] = None
        if live:
            all_nodes = set(live[0])
            for counts in live[1:]:
                all_nodes &= counts.keys()
        got = (any_nodes, all_nodes)
        self._memo[memo_key] = got
        return got

    def anti_domains(self, namespace, sel_forms, keys) -> Dict[str, set]:
        """Per anti key: topology values already OCCUPIED by an existing
        pod matching any of the workload's selectors — a self-anti
        replica can never be placed there again. Unfiltered nodes: the
        scheduler's inter-pod terms have no node-affinity gate."""
        any_nodes, _ = self._workload_nodes(namespace, sel_forms)
        blocked: Dict[str, set] = {key: set() for key in keys}
        if any_nodes:
            for name, labels in self._nodes():
                if name not in any_nodes:
                    continue
                for key in keys:
                    value = labels.get(key)
                    if value is not None:
                        blocked[key].add(value)
        return blocked

    def co_domains(
        self, namespace, sel_forms, keys
    ) -> Optional[Dict[str, set]]:
        """Per co key: the topology values that HOLD a matching pod —
        required self-affinity forces new replicas into one of them.
        None = bootstrap (no matching scheduled pod anywhere): the
        term imposes nothing and the whole-workload-in-one-domain rule
        alone applies."""
        _, all_nodes = self._workload_nodes(namespace, sel_forms)
        if all_nodes is None:
            return None
        allowed: Dict[str, set] = {key: set() for key in keys}
        for name, labels in self._nodes():
            if name not in all_nodes:
                continue
            for key in keys:
                value = labels.get(key)
                if value is not None:
                    allowed[key].add(value)
        return allowed


def _row_node_filter(snap, slot: int) -> tuple:
    """(memo token, node_passes) for a snapshot row: the row's
    nodeSelector + required-node-affinity filter, applied to census
    nodes (nodeAffinityPolicy=Honor). Token is content-derived so census
    memo entries are shared across rows with the same filter."""
    sel_items = [
        snap.labels[c] for c in np.flatnonzero(snap.required[slot])
    ]
    shape = (
        snap.affinity_shapes[snap.affinity_id[slot]]
        if snap.affinity_shapes is not None and snap.affinity_id is not None
        else ()
    )
    token = (tuple(sorted(sel_items)), shape)

    def node_passes(labels: dict) -> bool:
        if any(labels.get(k) != v for k, v in sel_items):
            return False
        return not shape or matches_affinity_shape(labels, shape)

    return token, node_passes




def _entry_census(census, namespace, entry, row_filter):
    """({value: count}, present values) for one spread entry under one
    row filter — THE census dispatch (honor vs Ignore policy, the
    census-less fallback), shared by the split budgets and the anti
    path's zero-cap masks so the two can never diverge."""
    _key, _skew, _mind, sel, _self, honor = entry
    if census is None or sel is None:
        return {}, set()
    if honor:
        token, node_passes = row_filter
        return census.spread(
            namespace, sel, entry[0], token, node_passes
        )
    # nodeAffinityPolicy=Ignore: every live node exposing the key
    # defines a domain and contributes counts
    return census.spread(
        namespace, sel, entry[0], ("ignore",), lambda labels: True
    )


