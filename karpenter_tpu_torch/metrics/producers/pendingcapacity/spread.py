"""Topology-spread constraint machinery: per-entry caps, the
immutable per-(shape, filter) cap views, the partition-form view for
anti-expanded rows, and the spread row expansion itself."""

from __future__ import annotations

import collections
from typing import Dict, Tuple

import numpy as np

from .census import _entry_census, _row_node_filter
from .exclusion import _anti_frozen_mask, _canonical_row_key
from .partition import _UNBOUNDED, _partition_chunks, _water_fill

def _entry_caps(
    skew, min_domains, self_match, values, counts_e, present_e
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Per-value new-replica caps imposed by ONE spread constraint
    entry over the `values` domain list (_UNBOUNDED where it imposes
    nothing). The three regimes the scheduler's skew check induces:

    - selfMatch false: placements never accumulate into the counts, so
      the check is static per domain — existing count must stay within
      maxSkew of the global minimum (0 under the minDomains rule);
      violating domains cap at 0, the rest are unbounded.
    - minDomains unsatisfied: global minimum treated as 0 — each domain
      holds at most maxSkew matching pods INCLUDING existing ones.
    - otherwise: domains among filter-passing live nodes that the
      candidate groups can't fill freeze the global minimum, capping
      each value at outside-minimum + maxSkew.
    """
    d = len(values)
    c_e = np.array([counts_e.get(v, 0) for v in values], np.int64)
    caps = np.full(d, _UNBOUNDED, np.int64)
    min_rule = bool(min_domains) and d < min_domains
    if not self_match:
        floor = 0 if min_rule else min(
            [
                int(c_e.min()),
                *(counts_e.get(v, 0) for v in present_e - set(values)),
            ]
        )
        caps[c_e - floor > skew] = 0
    elif min_rule:
        caps = np.clip(skew - c_e, 0, None)
    else:
        outside = present_e - set(values)
        m_out = min(
            (counts_e.get(v, 0) for v in outside), default=None
        )
        if m_out is not None:
            caps = np.clip(m_out + skew - c_e, 0, None)
    return caps, c_e, min_rule


def _partition_entry(entry_idx, skew, value_groups, caps, values,
                     counts_e):
    """One joint-partition 5-tuple: (entry index, maxSkew,
    value->groups, per-value caps with None = unbounded, per-value
    existing counts) — the shape _partition_chunks consumes."""
    return (
        entry_idx,
        int(skew),
        value_groups,
        {
            v: (int(caps[j]) if caps[j] < _UNBOUNDED else None)
            for j, v in enumerate(values)
        },
        {v: counts_e.get(v, 0) for v in values},
    )


def _mark_dead_domains(dead, caps2, values2, vals2, n_groups):
    """Flag every group of a zero-capacity domain in the dead mask."""
    if dead is None:
        dead = np.zeros(n_groups, bool)
    for j, value in enumerate(values2):
        if caps2[j] <= 0:
            dead[vals2[value]] = True
    return dead


def _nonsplit_entry_states(entries, split_key, entry_counts, eligible,
                           label_dicts, dead):
    """Fold the NON-split entries into (others, dead). Their
    zero-capacity domains (dead groups) can leave a split domain with
    no live group at all, and such a domain must then FREEZE the
    split-key global minimum like an unfillable outside domain —
    otherwise the surviving domains are over-promised capacity the
    scheduler's skew check denies against the frozen one. EVERY
    selfMatch non-split entry joins the chunk partition:
    even with unbounded caps its skew binds placements to a balanced
    distribution across its domains (the soundness fuzz caught whole
    chunks piling into one rack)."""
    others = []
    for entry_idx, e in enumerate(entries):
        if e[0] == split_key:
            continue
        _key, skew, min_domains, _sel, self_match, _honor = e
        counts_e, present_e = entry_counts(e)
        vals2: Dict[str, list] = {}
        for t in eligible:
            value = label_dicts[t].get(e[0])
            if value is not None:
                vals2.setdefault(value, []).append(t)
        if not vals2:
            continue
        values2 = sorted(vals2)
        caps2, _, _ = _entry_caps(skew, min_domains, self_match,
                                  values2, counts_e, present_e)
        if (caps2 <= 0).any():
            dead = _mark_dead_domains(
                dead, caps2, values2, vals2, len(label_dicts)
            )
        if self_match:
            others.append(
                _partition_entry(
                    entry_idx, skew, {v: vals2[v] for v in values2},
                    caps2, values2, counts_e,
                )
            )
    return others, dead


def _seed_covers(entries, split_key) -> bool:
    """Whether the fill-order seed (entries[0]'s counts) is the ONLY
    selfMatch split-key entry. The initial water-fill balances against
    entries[0]'s counts only — a fixpoint of a selfMatch split entry's
    relative skew bound just for THAT entry: a same-key selfMatch entry
    with a DIFFERENT selector has its own census counts, and with every
    live domain fillable its _entry_caps are unbounded — nothing
    enforces its skew against its own imbalance unless it joins the
    joint partition (two same-key DoNotSchedule
    constraints promised a replica into a domain the scheduler's second
    skew check denies)."""
    selfmatch_split = sum(
        1 for e in entries if e[0] == split_key and e[4]
    )
    return bool(entries[0][4]) and selfmatch_split == 1


def _frozen_split_values(values, split_groups, dead) -> np.ndarray:
    """Split values every live group of which is dead: unfillable, so
    they freeze the split-key global minimum."""
    frozen = np.zeros(len(values), bool)
    if dead is not None:
        for j, v in enumerate(values):
            if all(dead[t] for t in split_groups[v]):
                frozen[j] = True
    return frozen


def _split_entry_caps(e, values, counts_e, present_e, frozen):
    """Per-value caps for ONE split-key entry with the frozen-domain
    feedback applied: frozen domains' counts cap everything else at
    frozen-min + maxSkew (the outside-minimum rule), and nothing can
    actually land in a frozen domain."""
    _key, skew, min_domains, _sel, self_match, _honor = e
    caps_e, c_e, min_rule = _entry_caps(
        skew, min_domains, self_match, values, counts_e, present_e
    )
    if frozen.any():
        if self_match and not min_rule:
            m_frozen = int(c_e[frozen].min())
            caps_e = np.minimum(
                caps_e, np.clip(m_frozen + skew - c_e, 0, None)
            )
        caps_e = caps_e.copy()
        caps_e[frozen] = 0  # nothing can actually land there
    return caps_e, skew, self_match


def _spread_state(namespace, entries, values, census, row_filter,
                  label_dicts, eligible, extra_dead=None):
    """IMMUTABLE per-(shape, node-filter) cap VIEW — what the
    scheduler's skew checks admit for a row carrying this filter:

    - `static`[d]: split-key caps from non-selfMatch entries (0 or
      unbounded — placements never consume them);
    - `budget`[d]: split-key caps from selfMatch entries, the MIN over
      every same-key entry (a single "first entry" cap could silently
      drop a tighter same-key constraint);
    - `counts`[d]: the first entry's census counts (the fill-order
      seed);
    - `dead`: groups excluded outright — extra_dead (the anti stage's
      row-independent exclusions) plus every entry's zero-capacity
      domains;
    - `others`: EVERY selfMatch entry — non-split ones first, then the
      split entries themselves, so the joint partition
      (_partition_chunks) re-validates the split after other keys
      narrow — as (entry index, maxSkew, value->groups, per-value caps
      with None = unbounded, per-value existing counts) 5-tuples. The
      split entries also join whenever MORE THAN ONE selfMatch entry
      shares the split key (or the seed entry isn't selfMatch): each
      same-key selector has its own census counts and its relative
      skew bound only holds through the partition.

    CONSUMPTION lives one level up, in the per-WORKLOAD shared ledgers
    (_expand_spread_rows): placements count against the workload's
    skew regardless of which row's node filter admitted them, so rows
    with DIFFERENT filters still spend one budget — each row's
    effective cap is its own view minus everything the workload already
    placed."""
    split_key = entries[0][0]

    def entry_counts(e):
        return _entry_census(census, namespace, e, row_filter)

    d = len(values)
    static = np.full(d, _UNBOUNDED, np.int64)
    budget = np.full(d, _UNBOUNDED, np.int64)
    # `extra_dead` seeds the dead mask with the anti stage's
    # row-independent exclusions (co pins, foreign terms): a domain
    # those will forbid must freeze the minimum HERE, before the split
    # balances weight into it (found by the soundness fuzz)
    dead = extra_dead.copy() if extra_dead is not None else None
    # NON-SPLIT entries first (_nonsplit_entry_states has the freeze
    # rationale)
    others, dead = _nonsplit_entry_states(
        entries, split_key, entry_counts, eligible, label_dicts, dead
    )
    has_other_partitions = bool(others)
    seed_covers = _seed_covers(entries, split_key)
    split_groups: Dict[str, list] = {}
    for t in eligible:
        split_groups.setdefault(label_dicts[t][split_key], []).append(t)
    frozen = _frozen_split_values(values, split_groups, dead)
    for entry_idx, e in enumerate(entries):
        if e[0] != split_key:
            continue
        counts_e, present_e = entry_counts(e)
        caps_e, skew, self_match = _split_entry_caps(
            e, values, counts_e, present_e, frozen
        )
        if self_match:
            budget = np.minimum(budget, caps_e)
            # the split entry ALSO joins the joint partition (LAST, so
            # it re-validates after other keys narrow): when another
            # key's budget drops part of a domain's chunk, the split
            # key's own balance must re-bind against the shrunken
            # totals — the pre-allocation alone would leave e.g. zone
            # [2,0,1] standing after a rack cap emptied the middle
            # zone (found by the soundness fuzz). With NO other
            # partition entries AND a single selfMatch split entry
            # seeding the fill, nothing can shed and the split
            # water-fill is already a fixpoint of these exact bounds —
            # the common single-key fleet skips the partition entirely.
            # Same-key selfMatch entries beyond the seed always join
            # (seed_covers above).
            if has_other_partitions or not seed_covers:
                others.append(
                    _partition_entry(
                        entry_idx, skew, dict(split_groups), caps_e,
                        values, counts_e,
                    )
                )
        else:
            static = np.minimum(static, caps_e)
    first_counts, _ = entry_counts(entries[0])
    counts = (
        np.array([first_counts.get(v, 0) for v in values], np.int64)
        if entries[0][4]
        else np.zeros(d, np.int64)
    )
    return {
        "static": static,
        "budget": budget,
        "counts": counts,
        "first_selfmatch": bool(entries[0][4]),
        "dead": dead,
        "others": others,
    }




def _spread_partition_view(shape, row_filter, label_dicts, census,
                           n_groups):
    """Partition-form view of ALL of a spread shape's entries, for rows
    whose SPLIT was skipped in favor of the anti rule: the anti
    hand-out decides the anti domains, but every spread entry still
    binds — through the same _partition_chunks water-fill the spread
    path uses (zero-cap exclusion alone let the hand-out concentrate a
    workload onto one rack, found by the soundness fuzz).

    dead: groups missing a constrained key, non-selfMatch zero-cap
    domains, and selfMatch currently-full domains (cap 0 — also kept
    in the partition caps, but dead lets the hand-out skip them
    without consuming a pick). others: every selfMatch entry as a
    partition dimension (skew + remaining caps + existing counts)."""
    namespace, entries = shape
    dead = np.zeros(n_groups, bool)
    others = []
    for idx, entry in enumerate(entries):
        key, skew, min_domains, _sel, self_match, _honor = entry
        vals: Dict[str, list] = {}
        for t, labels in enumerate(label_dicts):
            value = labels.get(key)
            if value is None:
                dead[t] = True
            else:
                vals.setdefault(value, []).append(t)
        if not vals:
            continue
        counts_e, present_e = _entry_census(
            census, namespace, entry, row_filter
        )
        values = sorted(vals)
        caps_e, _, _ = _entry_caps(
            skew, min_domains, self_match, values, counts_e, present_e
        )
        dead = _mark_dead_domains(dead, caps_e, values, vals, n_groups)
        if self_match:
            others.append(
                _partition_entry(
                    ("spread", idx), skew, {v: vals[v] for v in values},
                    caps_e, values, counts_e,
                )
            )
    return {
        "others": others,
        "dead": dead if dead.any() else None,
    }




def _expand_spread_rows(  # lint: allow-complexity — per-domain chunking: each guard is a documented spread rule
    snap, profiles, row_idx, row_weight, label_dicts_fn, census=None
):
    """Topology spread (DoNotSchedule, non-hostname keys): partition each
    constrained row's weight into per-domain sub-rows, WATER-FILLED
    against the existing matching-pod counts per domain (DomainCensus).

    The solver assigns a whole weighted row to one group, so skew is
    enforced where it binds — in the GROUP choice: a domain is a distinct
    value of the topologyKey among the group-label INTERSECTIONS (a group
    spanning zones has no single domain value and is excluded, like a node
    missing the key is excluded by the kube-scheduler's PodTopologySpread
    filter). New replicas fill the least-loaded domains first — the only
    incremental order the scheduler's skew check always admits — so final
    totals are as balanced as the existing counts allow, satisfying any
    maxSkew >= 1. Domains among FILTER-PASSING live nodes that no
    candidate group serves freeze the global minimum: each eligible
    domain is then capped at (outside minimum + maxSkew) total, exactly
    the scheduler's skew bound against a domain a scale-up cannot fill.
    When minDomains exceeds the eligible domain count, the scheduler's
    global-minimum-0 rule applies — at most (maxSkew - existing) new
    pods per domain, the excess unschedulable. A pod that does NOT match
    its own constraint's selector (selfMatch false, incl. nil selector)
    never moves the counts: domains whose existing skew already exceeds
    the bound are excluded, the rest split balanced.

    Approximations, all conservative for a scale-up signal (may spread
    wider / mark more unschedulable than a lopsided-but-legal placement,
    never the reverse): maxSkew slack beyond 1 is not exploited when
    counts are level; with multiple constrained keys the split runs on
    the FIRST (key, selector) entry while the others are enforced
    through key-presence exclusion, zero-capacity dead masks, and the
    per-chunk domain PARTITION pass (_partition_chunks) that
    water-fills each chunk across their domains under their skews and
    remaining capacities; rows of one workload consume a SHARED budget
    in canonical content order; without a census (hand-built snapshot
    paths) counts are zero and the splits are plain balanced.

    Returns (row_idx, row_weight, spread_forbidden[rows, T]-or-None);
    unconstrained snapshots pass through untouched.
    """
    shapes = snap.spread_shapes
    if (
        len(row_idx) == 0
        or snap.spread_id is None
        or shapes is None
        or not (snap.spread_id[row_idx] != 0).any()
    ):
        return row_idx, row_weight, None

    n_groups = len(profiles)
    label_dicts = label_dicts_fn()
    live_ids = snap.spread_id[row_idx].copy()
    # rows whose self-anti-affinity carries a domain key are split
    # 1-per-domain by _expand_anti_rows — the most balanced placement a
    # topology key admits, so a second spread split would double-place
    # the weight; the spread keys still contribute key-presence
    # exclusion through the anti mask (docs/OPERATIONS.md)
    if snap.anti_id is not None and snap.anti_shapes is not None:
        anti_live = snap.anti_id[row_idx]
        domain_capped = np.array(
            [
                bool(snap.anti_shapes[a]) and bool(snap.anti_shapes[a][1])
                for a in anti_live
            ]
        )
        live_ids[domain_capped] = 0
        if not (live_ids != 0).any():
            return row_idx, row_weight, None

    # per live shape: (namespace, entries, ordered domain values,
    # [D, T] per-domain forbidden-mask matrix — built ONCE per shape,
    # rows are emitted by reference and only copied by the final stack)
    plan: Dict[int, tuple] = {}
    for s in np.unique(live_ids):
        shape = shapes[s]
        if not shape:
            continue
        namespace, entries = shape
        keys = [entry[0] for entry in entries]
        split_key = entries[0][0]
        domains: Dict[str, list] = {}
        eligible = []
        for t, labels in enumerate(label_dicts):
            if all(key in labels for key in keys):
                eligible.append(t)
                domains.setdefault(labels[split_key], []).append(t)
        values = sorted(domains)
        masks = np.ones((len(values), n_groups), bool)
        for rank, value in enumerate(values):
            masks[rank, domains[value]] = False
        plan[int(s)] = (namespace, entries, values, masks, eligible)

    all_forbidden = np.ones(n_groups, bool)
    no_forbidden = np.zeros(n_groups, bool)
    # per-(shape, filter) cap VIEWS are immutable; consumption lives in
    # per-WORKLOAD (per-sid) shared ledgers, so rows with DIFFERENT node
    # filters still spend one budget — placements count against the
    # workload's skew regardless of which filter admitted them.
    # Multi-row shapes process in canonical content order so
    # the hand-out never depends on arena-local numbering (the
    # path-stability rule _expand_anti_rows already follows); the
    # canonical key is only computed for shapes that actually have
    # several rows (it walks every universe — too hot for the common
    # one-row-per-workload tick).
    view_memo: Dict[tuple, dict] = {}
    ledgers: Dict[int, dict] = {}
    anti_dead_memo: Dict[int, np.ndarray] = {}
    sid_rows = collections.Counter(
        int(s) for s in live_ids if s and plan.get(int(s)) is not None
    )
    order = sorted(
        range(len(live_ids)),
        key=lambda i: (
            (0, (), i)
            if not live_ids[i] or plan.get(int(live_ids[i])) is None
            else (
                1,
                int(live_ids[i]),
                _canonical_row_key(snap, row_idx[i])
                if sid_rows[int(live_ids[i])] > 1
                else (),
            )
        ),
    )
    out_idx, out_weight, out_forbidden = [], [], []
    for i in order:
        sid = live_ids[i]
        entry = plan.get(int(sid))
        if entry is None:
            out_idx.append(row_idx[i])
            out_weight.append(row_weight[i])
            out_forbidden.append(no_forbidden)
            continue
        namespace, entries, values, masks, eligible = entry
        weight = int(row_weight[i])
        if not values or weight == 0:
            # no group exposes the key(s): unschedulable by spread —
            # keep the row, forbid everything, so the pods are COUNTED
            out_idx.append(row_idx[i])
            out_weight.append(row_weight[i])
            out_forbidden.append(all_forbidden)
            continue
        d = len(values)
        row_filter = (
            _row_node_filter(snap, row_idx[i])
            if census is not None
            else (None, None)
        )
        # the anti stage's row-independent exclusions (co pins, foreign
        # terms) feed the caps as dead groups, so a domain the anti
        # masks will forbid freezes the minimum instead of absorbing a
        # balanced chunk (found by the soundness fuzz); domain-capped
        # anti rows never reach here (their split is the anti rule's)
        anti_sid = (
            int(snap.anti_id[row_idx[i]])
            if snap.anti_id is not None and snap.anti_shapes is not None
            else 0
        )
        anti_dead = None
        if anti_sid and snap.anti_shapes[anti_sid]:
            if anti_sid in anti_dead_memo:
                anti_dead = anti_dead_memo[anti_sid]
            else:
                anti_dead = _anti_frozen_mask(
                    snap.anti_shapes[anti_sid], census, label_dicts,
                    n_groups,
                )
                if not anti_dead.any():
                    # a shape imposing no exclusions must not fragment
                    # the view memo or tax every chunk with a
                    # copy-and-OR of an all-False mask
                    anti_dead = None
                anti_dead_memo[anti_sid] = anti_dead
        view_key = (
            int(sid),
            row_filter[0],
            anti_sid if anti_dead is not None else 0,
        )
        view = view_memo.get(view_key)
        if view is None:
            view = _spread_state(
                namespace, entries, values, census, row_filter,
                label_dicts, eligible, extra_dead=anti_dead,
            )
            view_memo[view_key] = view
        ledger = ledgers.get(int(sid))
        if ledger is None:
            ledger = {
                "placed": np.zeros(d, np.int64),
                "counts": view["counts"].copy(),
                "others_placed": {},
            }
            ledgers[int(sid)] = ledger
        caps = np.minimum(
            np.clip(
                np.minimum(view["static"], view["budget"])
                - ledger["placed"],
                0,
                None,
            ),
            weight,
        )
        schedulable = min(weight, int(caps.sum()))
        # content-keyed remainder rotation (see _water_fill)
        seed = weight + int(
            np.ascontiguousarray(snap.requests[row_idx[i]])
            .view(np.uint8)
            .sum()
        )
        additions = _water_fill(
            ledger["counts"], caps, schedulable, seed
        )
        pieces = _partition_chunks(
            additions, masks, view, ledger["others_placed"], n_groups,
            seed,
        )
        # consume the shared ledgers with the KEPT counts (the
        # partition may shed part of a chunk): a later row of this
        # workload sees what THIS row placed — selfMatch placements
        # also accumulate into the fill-order counts, exactly like the
        # scheduler's sequential skew accounting
        kept = np.zeros(d, np.int64)
        for rank, count, _extra in pieces:
            kept[rank] += count
        ledger["placed"] = ledger["placed"] + kept
        if view["first_selfmatch"]:
            ledger["counts"] = ledger["counts"] + kept
        dead = view["dead"]
        placed = 0
        for rank, count, extra in pieces:
            placed += count
            forbidden = masks[rank]
            if dead is not None or extra is not None:
                forbidden = forbidden.copy()
                if dead is not None:
                    forbidden |= dead
                if extra is not None:
                    forbidden |= extra
            out_idx.append(row_idx[i])
            out_weight.append(np.int32(count))
            out_forbidden.append(forbidden)
        if placed < weight:
            out_idx.append(row_idx[i])
            out_weight.append(np.int32(weight - placed))
            out_forbidden.append(all_forbidden)
    return (
        np.asarray(out_idx, np.intp),
        np.asarray(out_weight, np.int32),
        np.stack(out_forbidden) if out_forbidden else None,
    )


