"""Constraint-group compiler: declarative specs -> exact-integer solver
operands (ops/binpack constraint plane).

The compiler is pure host-side numpy over the DEDUPLICATED weighted rows
the encoder already produces; everything it emits is integer-exact so
the XLA and numpy kernels stay bitwise-identical:

- membership: first matching group wins, evaluated once per DISTINCT pod
  label set (the columnar label_sets registry), gathered to rows
- reservation: claim ids over the reservation universe = spec claims
  union group karpenter.sh/reservation labels — reserved groups fence
  unclaimed pods even when nothing claims them
- compact placement: isolation class 1+k per compact group (class 0 is
  the shared class everything else packs in)
- spread: balanced per-zone quotas q+1/q from divmod(member weight,
  live zones) — skew <= 1 <= any legal maxSkew — plus the EXACTNESS
  CONTRACT the kernel's rank rule requires: member rows are pre-split at
  quota boundaries so every row's weighted rank interval lies inside one
  zone's quota (ops/binpack.constraint_mask assigns whole rows to the
  first zone with remaining quota; an unsplit straddling row would
  overflow it). Zone-less groups land in a trailing sink domain with
  quota 0 (spread members never place there; unconstrained pods are
  unaffected).

Nothing here raises on fleet state: an unsatisfiable constraint yields
infeasible rows (unschedulable counts), never an encode error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from karpenter_tpu_torch.api.core import (
    ZONE_LABEL,
    domain_of,
    matches_selector,
    reservation_of,
)
from karpenter_tpu_torch.constraints.spec import spread_topology_key


def compile_membership(label_sets, labels_id, groups) -> np.ndarray:
    """i32[rows]: 0 = no group, g+1 = first group whose podSelector
    matches the row's pod labels. One selector evaluation per DISTINCT
    label set (label_sets registry), gathered to rows by labels_id."""
    per_set = np.zeros(max(1, len(label_sets)), np.int32)
    for sid, items in enumerate(label_sets):
        labels = dict(items)
        for g, group in enumerate(groups):
            if matches_selector(labels, group.pod_selector):
                per_set[sid] = g + 1
                break
    return per_set[np.asarray(labels_id, np.int32)]


@dataclass
class ConstraintMeta:
    """Host-side universe metadata (verdict gauges, reports) — derived
    deterministically from (groups, profiles), never shipped to the
    device."""

    reservations: List[str]  # claim id c = 1 + index
    zones: List[str]  # domain d = index; sink domain = len(zones) —
    #                   domains of `topology_key` (zone only by default)
    spread_names: List[str]  # slot s = 1 + index
    compact_names: List[str]  # pack class = 1 + index
    # the one label axis this set's spread groups balance over (the
    # validated single-key invariant, constraints/spec.py)
    topology_key: str = ZONE_LABEL


def constraint_meta(groups, profiles) -> ConstraintMeta:
    group_reservations = {
        reservation_of(labels) for _, labels, _ in profiles
    }
    spec_claims = {g.reservation for g in groups if g.reservation}
    key = spread_topology_key(groups)
    return ConstraintMeta(
        reservations=sorted(
            (spec_claims | group_reservations) - {""}
        ),
        zones=sorted(
            {domain_of(labels, key) for _, labels, _ in profiles} - {""}
        ),
        spread_names=[g.name for g in groups if g.spread is not None],
        compact_names=[g.name for g in groups if g.compact],
        topology_key=key,
    )


@dataclass
class CompiledConstraints:
    """Per-row / per-group constraint operands over the FINAL row set
    (after spread-quota splitting). `rep` gathers every pre-existing
    per-row array (row_idx, masks, exclusivity) into that final set."""

    rep: np.ndarray  # intp[hi'] — gather of pre-split row positions
    row_weight: np.ndarray  # i32[hi'] — split weights (sum preserved)
    claim: Optional[np.ndarray]  # i32[hi'] or None
    group_reservation: Optional[np.ndarray]  # i32[T_real] or None
    pack_class: Optional[np.ndarray]  # bool[hi', C] or None
    spread_slot: Optional[np.ndarray]  # i32[hi'] or None
    group_domain: Optional[np.ndarray]  # i32[T_real] or None
    spread_cap: Optional[np.ndarray]  # i32[S, D] or None
    exclusive: Optional[np.ndarray]  # bool[hi'] anti-affinity members
    meta: ConstraintMeta


def _split_spread_rows(membership, weights, valid, groups, meta):  # lint: allow-complexity — cap-boundary row splitting: each guard is a documented exactness rule
    """(rep, new_weights, slot_of_final_row, caps) — balanced zone
    quotas per spread slot and the row pre-split the kernel's rank rule
    requires. Row ORDER is preserved (split pieces adjacent): the
    kernel's exclusive weighted prefix-sum rank walks rows in order, so
    the compiler's quota accounting must walk the same order."""
    hi = len(membership)
    slot_by_group: Dict[int, int] = {}
    for j, name in enumerate(meta.spread_names):
        for gidx, group in enumerate(groups):
            if group.spread is not None and group.name == name:
                slot_by_group[gidx] = j + 1
    row_slot = np.zeros(hi, np.int32)
    for gidx, s in slot_by_group.items():
        row_slot[membership == gidx + 1] = s

    n_zones = len(meta.zones)
    n_slots = len(meta.spread_names)
    if n_slots == 0 or n_zones == 0 or not bool((row_slot != 0).any()):
        rep = np.arange(hi, dtype=np.intp)
        return rep, np.asarray(weights, np.int32).copy(), None, None

    caps = np.zeros((n_slots, n_zones + 1), np.int32)  # +1 = sink, 0
    for j in range(n_slots):
        members = (row_slot == j + 1) & valid
        total = int(np.asarray(weights)[members].sum())
        q, r = divmod(total, n_zones)
        caps[j, :n_zones] = q
        caps[j, :r] += 1
    bounds = np.cumsum(caps[:, :n_zones], axis=1)

    rep: List[int] = []
    new_w: List[int] = []
    out_slot: List[int] = []
    rank = np.zeros(n_slots, np.int64)
    for i in range(hi):
        s = int(row_slot[i])
        w = int(weights[i])
        if s == 0 or not valid[i] or w == 0:
            rep.append(i)
            new_w.append(w)
            out_slot.append(s)
            continue
        start = int(rank[s - 1])
        rank[s - 1] += w
        end = start + w
        # chunk [start, end) at the slot's quota boundaries so each
        # piece lies inside one zone's quota interval
        cuts = [start]
        cuts.extend(
            int(b) for b in bounds[s - 1] if start < b < end
        )
        cuts.append(end)
        for a, b in zip(cuts, cuts[1:]):
            rep.append(i)
            new_w.append(b - a)
            out_slot.append(s)
    return (
        np.asarray(rep, np.intp),
        np.asarray(new_w, np.int32),
        np.asarray(out_slot, np.int32),
        caps,
    )


def compile_rows(membership, weights, valid, profiles, groups):  # lint: allow-complexity — one arm per constraint kind, all optional
    """The full per-solve compile: (membership i32[hi], weights i32[hi],
    valid bool[hi], group profiles, constraint groups) ->
    CompiledConstraints. Operands are attached only when live (absent
    halves stay None so unconstrained fleets ship today's wire)."""
    membership = np.asarray(membership, np.int32)
    weights = np.asarray(weights, np.int32)
    valid = np.asarray(valid, bool)
    meta = constraint_meta(groups, profiles)
    n_groups = len(profiles)

    rep, row_weight, spread_slot, caps = _split_spread_rows(
        membership, weights, valid, groups, meta
    )
    membership = membership[rep]

    # reservation claims: claim id per row, reservation id per group
    claim = None
    group_reservation = None
    if meta.reservations:
        claim_of_group = np.zeros(len(groups) + 1, np.int32)
        for gidx, group in enumerate(groups):
            if group.reservation:
                claim_of_group[gidx + 1] = (
                    1 + meta.reservations.index(group.reservation)
                )
        claim = claim_of_group[membership]
        group_reservation = np.zeros(n_groups, np.int32)
        for t, (_, labels, _) in enumerate(profiles):
            name = reservation_of(labels)
            if name:
                group_reservation[t] = 1 + meta.reservations.index(name)
        if not claim.any() and not group_reservation.any():
            claim = None
            group_reservation = None

    # compact-placement isolation classes
    pack_class = None
    if meta.compact_names:
        class_of_group = np.zeros(len(groups) + 1, np.int32)
        for gidx, group in enumerate(groups):
            if group.compact:
                class_of_group[gidx + 1] = (
                    1 + meta.compact_names.index(group.name)
                )
        row_class = class_of_group[membership]
        if row_class.any():
            n_classes = 1 + len(meta.compact_names)
            pack_class = np.zeros((len(rep), n_classes), bool)
            pack_class[np.arange(len(rep)), row_class] = True

    # spread domains: zone index per group, sink for zone-less groups
    group_domain = None
    spread_cap = None
    if spread_slot is not None:
        group_domain = np.zeros(n_groups, np.int32)
        sink = len(meta.zones)
        for t, (_, labels, _) in enumerate(profiles):
            zone = domain_of(labels, meta.topology_key)
            group_domain[t] = (
                meta.zones.index(zone) if zone else sink
            )
        spread_cap = caps

    # anti-affinity members take whole nodes
    exclusive = None
    anti = np.zeros(len(groups) + 1, bool)
    for gidx, group in enumerate(groups):
        anti[gidx + 1] = group.anti_affinity
    row_anti = anti[membership]
    if row_anti.any():
        exclusive = row_anti

    return CompiledConstraints(
        rep=rep,
        row_weight=row_weight,
        claim=claim,
        group_reservation=group_reservation,
        pack_class=pack_class,
        spread_slot=spread_slot,
        group_domain=group_domain,
        spread_cap=spread_cap,
        exclusive=exclusive,
        meta=meta,
    )


# -- verdict helpers (host-side, from inputs + assigned) ---------------------


def spread_skew(inputs, assigned, meta: ConstraintMeta) -> Dict[str, int]:
    """Per spread group: max - min placed weight across live zones
    (assigned rows only — unschedulable members place nowhere)."""
    out: Dict[str, int] = {}
    n_zones = len(meta.zones)
    if inputs.pod_spread_slot is None or n_zones == 0:
        return {name: 0 for name in meta.spread_names}
    slot = np.asarray(inputs.pod_spread_slot)
    domain = np.asarray(inputs.group_domain)
    weight = (
        np.asarray(inputs.pod_weight)
        if inputs.pod_weight is not None
        else np.ones(len(slot), np.int32)
    )
    valid = np.asarray(inputs.pod_valid)
    assigned = np.asarray(assigned)
    for j, name in enumerate(meta.spread_names):
        rows = np.nonzero(
            (slot[: len(assigned)] == j + 1)
            & valid[: len(assigned)]
            & (assigned >= 0)
        )[0]
        per_zone = np.zeros(n_zones, np.int64)
        for i in rows:
            d = int(domain[assigned[i]])
            if d < n_zones:
                per_zone[d] += int(weight[i])
        out[name] = int(per_zone.max() - per_zone.min())
    return out


def reservation_fill(  # lint: allow-complexity — host-side verdict: one guard per absent-operand case
    inputs, assigned, meta: ConstraintMeta
) -> Dict[str, float]:
    """Per reservation: placed claimed weight / total claimed weight
    (1.0 when nothing claims it — an idle reservation is fully
    honored, not unfilled)."""
    out: Dict[str, float] = {}
    if inputs.pod_claim is None:
        return {name: 1.0 for name in meta.reservations}
    claim = np.asarray(inputs.pod_claim)
    reservation = (
        np.asarray(inputs.group_reservation)
        if inputs.group_reservation is not None
        else None
    )
    weight = (
        np.asarray(inputs.pod_weight)
        if inputs.pod_weight is not None
        else np.ones(len(claim), np.int32)
    )
    valid = np.asarray(inputs.pod_valid)
    assigned = np.asarray(assigned)
    for c, name in enumerate(meta.reservations):
        rows = np.nonzero(
            (claim[: len(assigned)] == c + 1) & valid[: len(assigned)]
        )[0]
        total = int(weight[rows].sum())
        if total == 0:
            out[name] = 1.0
            continue
        placed = 0
        for i in rows:
            t = int(assigned[i])
            if t >= 0 and (
                reservation is None or int(reservation[t]) == c + 1
            ):
                placed += int(weight[i])
        out[name] = placed / total
    return out
