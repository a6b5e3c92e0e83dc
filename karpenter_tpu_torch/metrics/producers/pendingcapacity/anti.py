"""Required inter-pod self-(anti-)affinity row expansion: exclusive
rows, per-domain weight-1 splits with shared domain sequences, co
pins, and the spread re-validation of anti-decided rows."""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

import numpy as np

from .census import _row_node_filter
from .exclusion import _anti_base_exclusion, _canonical_row_key, _co_pin
from .partition import _partition_chunks
from .spread import _spread_partition_view

def _expand_anti_rows(  # lint: allow-complexity — per-domain capping: each guard is a documented anti-affinity rule
    snap, profiles, row_idx, row_weight, prior_forbidden, label_dicts_fn,
    census=None,
):
    """Required inter-pod SELF-(anti-)affinity (api/core.pod_affinity_shape):

    - hostname anti-affinity marks the row EXCLUSIVE (one pod per node,
      the ops/binpack.py pod_exclusive operand);
    - domain anti-affinity (zone/region keys) caps the workload at ONE
      pod per topology domain OF EVERY KEY: eligible groups bucket by
      combined key values and a greedy pass selects domains no two of
      which share any key's value; the row splits into weight-1
      sub-rows, each masked to one selected domain's groups, the
      excess reported unschedulable. Rows sharing an anti shape (same
      workload identity — the canonical self-matching selector, so
      StatefulSet per-pod labels don't fragment it) draw from one
      shared domain sequence, so a workload split across
      request-distinct rows (e.g. mid-VPA-rollout) still never doubles
      up a domain;
    - co-location affinity keys exclude groups missing the key (group
      profiles hold the label INTERSECTION, so a group spanning domain
      values drops the key and is excluded). Combined with domain
      anti-affinity, ALL the workload's sub-rows pin to the single co
      bucket offering the most anti domains (independent per-domain
      assignment could split replicas across co domains the scheduler
      forces together). Co-location alone: the solver's whole-row-to-
      one-group assignment keeps a single-row workload in one domain;
      a workload split across request-distinct rows pins to one
      deterministic co bucket.

    A domain is a distinct topologyKey value among group-label
    intersections, exactly the _expand_spread_rows rule; a row with both
    hard spread and domain anti-affinity is split by the anti rule (the
    most balanced placement possible — spread's split is skipped, see
    _expand_spread_rows) while its spread keys contribute key-presence
    exclusion here.

    EXISTING-pod occupancy (`census`, a DomainCensus): domains already
    holding a scheduled pod matching the workload's selectors are spent
    for anti-affinity (seeded into the greedy pass), and required
    co-location pins new replicas to the domains that hold a matching
    pod — unless NO matching pod exists anywhere (the k8s first-replica
    bootstrap, which imposes nothing). census=None (hand-built
    snapshots) means no occupancy: bootstrap semantics throughout. Conservative throughout: the signal may report more
    unschedulable or spread wider than a legal placement, never claim
    feasibility the kube-scheduler would deny for the modeled slice
    (docs/OPERATIONS.md 'Scheduling fidelity').

    prior_forbidden (the spread expansion's per-row mask, aligned with
    the INPUT rows) is carried through the re-expansion: every output
    row inherits its source row's mask OR'd with the anti exclusions.

    Domain hand-out across a workload's rows is ordered by CANONICAL
    row content (_canonical_row_key), never by dedup-row position:
    byte-sorted row order depends on arena-local id numbering, so a
    position-ordered hand-out could give the oracle and feed paths
    different row->domain assignments — and with per-domain taints,
    different outputs — breaking the outputs-identical-on-every-
    encode-path invariant (the spread expansion's
    content-keyed rotation avoids the same trap).

    Returns (row_idx, row_weight, forbidden[rows, T]-or-None,
    exclusive[rows]-or-None); unconstrained snapshots pass untouched.
    """
    shapes = snap.anti_shapes
    if (
        len(row_idx) == 0
        or snap.anti_id is None
        or shapes is None
        or not (snap.anti_id[row_idx] != 0).any()
    ):
        return row_idx, row_weight, prior_forbidden, None

    n_groups = len(profiles)
    label_dicts = label_dicts_fn()
    live_ids = snap.anti_id[row_idx]
    spread_shapes = snap.spread_shapes
    live_spread = (
        snap.spread_id[row_idx] if snap.spread_id is not None else None
    )

    # per live anti shape: (ordered domain group-lists or None,
    # key-exclusion mask, hostname_exclusive); the domain sequence is
    # SHARED across rows with the same shape, handed out in canonical
    # content order (path-stable — see docstring)
    sid_rows = collections.Counter(int(s) for s in live_ids)
    # (spread shape id, row filter token) -> partition view; ledgers
    # keyed per spread sid ONLY (one budget per workload) — for anti
    # rows whose spread split was skipped (see below)
    spread_view_memo: Dict[tuple, dict] = {}
    spread_ledgers: Dict[int, dict] = {}
    plan: Dict[int, tuple] = {}
    for s in np.unique(live_ids):
        shape = shapes[s]
        if not shape:
            continue
        flags, anti_keys, co_keys, ident, foreign = shape
        hostname_excl = bool(flags & 1)
        hostname_co = bool(flags & 2)
        excluded, blocked, co_allowed = _anti_base_exclusion(
            shape, census, label_dicts, n_groups
        )
        domains = None
        if anti_keys:
            # Combined-value accounting so EVERY key's cap holds (a
            # first-key-only split can put two replicas in one domain
            # of a coarser key): eligible groups bucket
            # by (co-key values, anti-key values); within each co
            # bucket, greedily select anti domains such that no two
            # share ANY key's value; the co bucket with the most
            # selected domains wins — the workload's co-location keys
            # pin ALL its replicas to that one bucket (a per-domain
            # independent assignment could split replicas across co
            # domains the scheduler forces together). Deterministic:
            # sorted iteration, count-then-lexicographic choice.
            buckets: Dict[tuple, Dict[tuple, list]] = {}
            for t, labels in enumerate(label_dicts):
                if excluded[t]:
                    continue
                co_vec = tuple(labels[k] for k in co_keys)
                anti_vec = tuple(labels[k] for k in anti_keys)
                buckets.setdefault(co_vec, {}).setdefault(
                    anti_vec, []
                ).append(t)
            best: Optional[tuple] = None
            for co_vec in sorted(buckets):
                # domains an EXISTING replica occupies are spent: seed
                # the per-key used sets so no new replica shares any
                # key's value with a pod already placed
                used: List[set] = [
                    set(blocked.get(key, ())) for key in anti_keys
                ]
                selected = []
                for anti_vec in sorted(buckets[co_vec]):
                    if any(
                        value in used[i]
                        for i, value in enumerate(anti_vec)
                    ):
                        continue
                    for i, value in enumerate(anti_vec):
                        used[i].add(value)
                    selected.append(buckets[co_vec][anti_vec])
                if best is None or len(selected) > len(best[1]):
                    best = (co_vec, selected)
            domains = best[1] if best is not None else []
        elif co_keys and sid_rows[int(s)] > 1:
            # co-location-only workload split across request-distinct
            # rows (mid-VPA): whole-row-to-one-group no longer pins ONE
            # domain, so pin all the workload's rows to a single
            # deterministic co bucket (_co_pin — the same choice the
            # spread caps anticipated); single-row workloads keep full
            # group freedom
            excluded = _co_pin(excluded, label_dicts, co_keys, n_groups)
        plan[int(s)] = (domains, excluded, hostname_excl, hostname_co)

    def row_spread_view(i):
        """Partition view + shared ledger for an anti-split row's SKIPPED
        spread shape: the anti hand-out decides the anti domains, but
        every spread entry still binds through the same water-fill
        partition the spread path uses (r3; zero-cap exclusion alone let
        a workload concentrate onto one rack — soundness fuzz)."""
        if (
            live_spread is None
            or live_spread[i] == 0
            or spread_shapes is None
        ):
            return None, None
        spread_sid = int(live_spread[i])
        row_filter = (
            _row_node_filter(snap, row_idx[i])
            if census is not None
            else (None, None)
        )
        key = (spread_sid, row_filter[0])
        view = spread_view_memo.get(key)
        if view is None:
            view = _spread_partition_view(
                spread_shapes[spread_sid], row_filter, label_dicts,
                census, n_groups,
            )
            spread_view_memo[key] = view
        # the LEDGER is per WORKLOAD (per spread sid), never per filter
        # token: rows with different node selectors must spend one
        # budget
        return view, spread_ledgers.setdefault(spread_sid, {})

    # hand out domains per workload in canonical content order; a
    # domain dead for one row (its spread capacity spent, or every
    # group of it excluded) is SKIPPED, not consumed — a later row may
    # still use it, while consumption stays GLOBAL per workload so no
    # two rows ever share a domain (the no-doubling invariant)
    picks: Dict[int, list] = {}
    row_views: Dict[int, tuple] = {}
    rows_by_sid: Dict[int, list] = {}
    for i, sid in enumerate(live_ids):
        entry = plan.get(int(sid))
        if entry is not None and entry[0] is not None:
            rows_by_sid.setdefault(int(sid), []).append(i)
    for sid, rows_i in rows_by_sid.items():
        domain_list = plan[sid][0]
        if len(rows_i) > 1:
            rows_i = sorted(
                rows_i,
                key=lambda i: _canonical_row_key(snap, row_idx[i]),
            )
        consumed = [False] * len(domain_list)
        for i in rows_i:
            view, ledger = row_spread_view(i)
            if view is not None:
                row_views[i] = (view, ledger)
            dead = view["dead"] if view is not None else None
            need = int(row_weight[i])
            mine = []
            for rank, groups in enumerate(domain_list):
                if len(mine) >= need:
                    break
                if consumed[rank]:
                    continue
                if dead is not None and all(dead[t] for t in groups):
                    continue
                consumed[rank] = True
                mine.append(rank)
            picks[i] = mine

    # hostname CO bootstrap cap: ONE promised replica per workload
    # (replicas beyond the first must join the first's node, which a
    # group-level pack cannot promise; with an occupied census the +2
    # foreign projection already forbade every group). The single
    # promise goes to the CANONICALLY-first row so every encode path
    # hands it out identically (the domain hand-out's path-stability
    # rule).
    co_budget_row: Dict[int, int] = {}
    for s, entry in plan.items():
        if entry[3]:
            rows_i = [i for i, s2 in enumerate(live_ids) if int(s2) == s]
            co_budget_row[s] = (
                min(
                    rows_i,
                    key=lambda i: _canonical_row_key(snap, row_idx[i]),
                )
                if len(rows_i) > 1
                else rows_i[0]
            )

    out_idx, out_weight, out_forbidden, out_exclusive = [], [], [], []
    for i, sid in enumerate(live_ids):
        prior = (
            prior_forbidden[i]
            if prior_forbidden is not None
            else np.zeros(n_groups, bool)
        )
        entry = plan.get(int(sid))
        if entry is None:
            out_idx.append(row_idx[i])
            out_weight.append(row_weight[i])
            out_forbidden.append(prior)
            out_exclusive.append(False)
            continue
        domains, excluded, hostname_excl, hostname_co = entry
        excluded = excluded | prior
        if i in row_views and row_views[i][0]["dead"] is not None:
            # partial-dead domains stay usable through their live
            # groups; the mask forbids the spent ones
            excluded |= row_views[i][0]["dead"]
        weight = int(row_weight[i])
        if domains is None:
            if hostname_co:
                take = (
                    min(1, weight)
                    if co_budget_row.get(int(sid)) == i
                    else 0
                )
                if take:
                    out_idx.append(row_idx[i])
                    out_weight.append(np.int32(take))
                    out_forbidden.append(excluded)
                    out_exclusive.append(hostname_excl)
                if weight > take:
                    out_idx.append(row_idx[i])
                    out_weight.append(np.int32(weight - take))
                    out_forbidden.append(np.ones(n_groups, bool))
                    out_exclusive.append(hostname_excl)
                continue
            # hostname/co-location only: no split, mask + flag ride along
            out_idx.append(row_idx[i])
            out_weight.append(row_weight[i])
            out_forbidden.append(excluded)
            out_exclusive.append(hostname_excl)
            continue
        mine = picks[i]
        if hostname_co:
            # one replica total: only the budget row places, one domain
            mine = mine[:1] if co_budget_row.get(int(sid)) == i else []
        view_ledger = row_views.get(i)
        placed = 0
        # content-keyed, invariant across this row's ranks (arena
        # numbering must not steer the partition)
        content_sum = int(
            np.ascontiguousarray(snap.requests[row_idx[i]])
            .view(np.uint8)
            .sum()
        )
        for rank in mine:
            forbidden = np.ones(n_groups, bool)
            forbidden[domains[rank]] = False
            forbidden |= excluded
            if view_ledger is None:
                placed += 1
                out_idx.append(row_idx[i])
                out_weight.append(np.int32(1))
                out_forbidden.append(forbidden)
                out_exclusive.append(hostname_excl)
                continue
            # the SKIPPED spread shape still binds: partition this
            # weight-1 sub-row across every spread entry's domains
            # against the workload-shared ledger (picking e.g. the
            # rack with remaining balance, not whichever group the
            # solver tries first)
            view, ledger = view_ledger
            seed = rank + content_sum
            pieces = _partition_chunks(
                np.array([1], np.int64), [forbidden], view, ledger,
                n_groups, seed,
            )
            for _rank0, count, extra in pieces:
                placed += count
                sub = forbidden
                if extra is not None:
                    # view["dead"] already rode in through `excluded`
                    sub = sub | extra
                out_idx.append(row_idx[i])
                out_weight.append(np.int32(count))
                out_forbidden.append(sub)
                out_exclusive.append(hostname_excl)
        if weight > placed:
            # beyond the usable domain count / spread capacity:
            # unschedulable by anti-affinity — keep the excess as a
            # forbidden-everywhere row so it COUNTS
            out_idx.append(row_idx[i])
            out_weight.append(np.int32(weight - placed))
            out_forbidden.append(np.ones(n_groups, bool))
            out_exclusive.append(hostname_excl)
    return (
        np.asarray(out_idx, np.intp),
        np.asarray(out_weight, np.int32),
        np.stack(out_forbidden) if out_forbidden else None,
        np.asarray(out_exclusive, bool),
    )


