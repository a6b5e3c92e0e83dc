"""Row-independent group exclusions a pod_affinity_shape imposes
(key presence, co pins, foreign terms vs the census), the co-bucket
pin, and the arena-independent canonical row key used to order
multi-row hand-outs."""

from __future__ import annotations

from typing import Dict

import numpy as np

from karpenter_tpu_torch.api.core import HOSTNAME_TOPOLOGY_KEY

def _self_exclusion(
    need_keys, co_keys, co_allowed, label_dicts, n_groups
):
    """Key-presence + required self co-location pinning: groups missing
    a constrained key are out; when the workload already runs somewhere,
    new replicas pin to domains that hold a matching pod."""
    excluded = np.zeros(n_groups, bool)
    for t, labels in enumerate(label_dicts):
        if any(key not in labels for key in need_keys):
            excluded[t] = True
        elif co_allowed is not None and any(
            labels[key] not in co_allowed[key] for key in co_keys
        ):
            excluded[t] = True
    return excluded


def _foreign_scope_namespaces(census, sign, scope):
    """Resolve a foreign term's namespace scope. ("names", tuple) is
    explicit; ("selector", form, explicit) resolves against the frozen
    Namespace set unioned with the explicit list (the k8s combination
    rule) — and an ANTI term additionally blocks against every
    occupancy namespace with NO Namespace object to judge
    (conservative)."""
    if scope[0] == "names":
        return scope[1]
    _tag, ns_form, explicit = scope
    resolved = set(explicit)
    resolved |= census.namespaces_matching(ns_form)
    if sign < 0:
        known = census.known_namespace_names()
        resolved |= {
            ns
            for ns in census.occupancy_namespaces()
            if ns not in known
        }
    return sorted(resolved)


def _apply_foreign_term(excluded, census, label_dicts, sign, key, sel,
                        namespaces):
    """Fold ONE foreign term into the exclusion mask. Anti (sign -1)
    blocks occupied domains; co (sign +1) requires one with no
    first-replica bootstrap (a foreign selector the incoming pod
    doesn't match gets no grace — the scheduler's rule); sign +2 is the
    bootstrap-eligible SELF projection (api/core._foreign_terms): an
    empty census imposes nothing. Hostname co can never be met by a
    fresh node; hostname domains are node names, answered by the
    per-node materialized view without requiring the label on Node
    objects."""
    if sign == 1 and key == HOSTNAME_TOPOLOGY_KEY:
        # occupied or not, a fresh node can never host the neighbor —
        # skip the census walk entirely
        excluded[:] = True
        return
    occupied: set = set()
    for foreign_ns in namespaces:
        if key == HOSTNAME_TOPOLOGY_KEY:
            occupied |= census.matching_nodes(foreign_ns, sel)
        else:
            occupied |= census.domain_counts(foreign_ns, sel, key).keys()
    if sign < 0:
        for t, labels in enumerate(label_dicts):
            if labels.get(key) in occupied:
                excluded[t] = True
    else:
        _require_occupied_domain(excluded, label_dicts, sign, key, occupied)


def _require_occupied_domain(excluded, label_dicts, sign, key, occupied):
    """The CO arms of a foreign term: placement must land in a domain
    holding a matching pod."""
    if sign > 1 and not occupied:
        # the scheduler's first-replica grace: the pod itself is in
        # scope and matches, so an empty census imposes nothing
        return
    if key == HOSTNAME_TOPOLOGY_KEY:
        excluded[:] = True
        return
    for t, labels in enumerate(label_dicts):
        value = labels.get(key)
        if value is None or value not in occupied:
            excluded[t] = True


def _anti_base_exclusion(shape, census, label_dicts, n_groups):
    """(excluded mask, anti blocked values, co allowed values) — the
    ROW-INDEPENDENT group exclusions a pod_affinity_shape imposes:
    key-presence, required self co-location pinning to occupied
    domains (_self_exclusion), and FOREIGN required terms enforced
    against SCHEDULED state (_apply_foreign_term has the per-sign
    rules; _foreign_scope_namespaces the namespace scoping). Shared by
    the anti expansion's plan AND the spread caps' frozen-domain
    feedback — the one implementation of the exclusion rules."""
    _hostname_excl, anti_keys, co_keys, ident, foreign = shape
    blocked: Dict[str, set] = {}
    co_allowed = None
    if census is not None and ident:
        ident_ns, sel_forms = ident
        if anti_keys:
            blocked = census.anti_domains(ident_ns, sel_forms, anti_keys)
        if co_keys:
            co_allowed = census.co_domains(ident_ns, sel_forms, co_keys)
    excluded = _self_exclusion(
        [*anti_keys, *co_keys], co_keys, co_allowed, label_dicts, n_groups
    )
    if foreign and census is not None:
        for sign, key, sel, scope in foreign:
            namespaces = _foreign_scope_namespaces(census, sign, scope)
            _apply_foreign_term(
                excluded, census, label_dicts, sign, key, sel, namespaces
            )
    return excluded, blocked, co_allowed


def _anti_frozen_mask(shape, census, label_dicts, n_groups):
    """The anti-stage exclusions a SPREAD split must anticipate: base
    exclusion plus the co-only single-bucket pin (a spread split
    produces several rows, which triggers the multi-row pin in
    _expand_anti_rows). A spread domain whose groups are all excluded
    here can never receive its chunk — without feeding that back into
    the caps, the split balances over domains the anti stage then
    forbids, over-promising the survivors (found by the soundness
    fuzz). Anticipating the pin when the split ends up single-row only
    tightens: conservative."""
    _hostname_excl, anti_keys, co_keys, _ident, _foreign = shape
    excluded, _blocked, _co_allowed = _anti_base_exclusion(
        shape, census, label_dicts, n_groups
    )
    if co_keys and not anti_keys:
        excluded = _co_pin(excluded, label_dicts, co_keys, n_groups)
    return excluded


def _co_pin(excluded, label_dicts, co_keys, n_groups):
    """Pin a co-only multi-row workload to ONE deterministic co bucket
    (lexicographically first among non-excluded groups) — THE single
    implementation: the anti expansion and the spread caps' frozen
    feedback must pick the identical bucket, or the split balances
    weight into a domain the pin then forbids (the over-promise class
    the soundness fuzz caught)."""
    co_vecs: Dict[tuple, list] = {}
    for t, labels in enumerate(label_dicts):
        if not excluded[t]:
            co_vecs.setdefault(
                tuple(labels[k] for k in co_keys), []
            ).append(t)
    if not co_vecs:
        return excluded
    chosen = set(co_vecs[min(co_vecs)])
    excluded = excluded.copy()
    for t in range(n_groups):
        if t not in chosen:
            excluded[t] = True
    return excluded




def _total_order(value):
    """Totally-ordered encoding of a canonical shape component. Shape
    tuples embed OPTIONAL selector forms (None when the field is absent
    — e.g. spread_shape's selectorForm, metav1 nil-selector semantics),
    and plain tuple comparison raises TypeError on None-vs-tuple, so a
    legal spec mixing a nil and a set selector would crash the whole
    solve. Every node gets a type rank so any two
    encoded keys compare: None < numbers < strings < tuples."""
    if isinstance(value, tuple):
        return (3, tuple(_total_order(v) for v in value))
    if value is None:
        return (0, 0.0)
    if isinstance(value, str):
        return (2, value)
    return (1, float(value))  # bool / int / float


def _shape_of(shapes, ids, slot) -> tuple:
    """A row's canonical shape from an optional (registry, id-column)
    pair; () when the snapshot doesn't carry that column."""
    if shapes is not None and ids is not None:
        return shapes[ids[slot]]
    return ()


def _canonical_row_key(snap, slot: int) -> tuple:
    """Arena-independent content key for a snapshot row: every component
    is resolved through its universe REGISTRY (resource names, label
    items, canonical shape tuples), so two arenas that numbered the same
    pod shapes differently still produce the same key. Used to order
    domain hand-out across a workload's rows (_expand_anti_rows). The
    result is passed through _total_order so keys embedding optional
    (None) selector forms stay comparable under sorted()."""
    requests = tuple(
        sorted(
            (snap.resources[r], float(snap.requests[slot, r]))
            for r in range(len(snap.resources))
            if snap.requests[slot, r] != 0
        )
    )
    selector = tuple(
        sorted(
            snap.labels[c]
            for c in range(len(snap.labels))
            if snap.required[slot, c]
        )
    )
    tolerations = tuple(
        sorted(
            (
                (t.key, t.operator, t.value, t.effect)
                for t in snap.shape_tolerations[snap.shape_id[slot]]
            ),
            # toleration value/key may be None (Exists operator)
            key=_total_order,
        )
    )
    affinity = _shape_of(snap.affinity_shapes, snap.affinity_id, slot)
    preferred = _shape_of(snap.preferred_shapes, snap.preferred_id, slot)
    spread = _shape_of(snap.spread_shapes, snap.spread_id, slot)
    soft = tuple(
        shapes[ids[slot]]
        for shapes, ids in (
            (snap.soft_spread_shapes, snap.soft_spread_id),
            (snap.soft_anti_shapes, snap.soft_anti_id),
        )
        if shapes is not None and ids is not None
    )
    return _total_order(
        (requests, selector, tolerations, affinity, preferred, spread,
         soft)
    )


