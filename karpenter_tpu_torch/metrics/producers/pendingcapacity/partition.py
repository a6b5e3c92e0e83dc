"""The water-fill and the joint chunk partition — the two primitives
every skew-bounded hand-out (spread splits, anti domain caps) shares.
Pure numpy, no store or census access."""

from __future__ import annotations

import numpy as np

def _water_fill(counts, caps, schedulable: int, seed: int) -> np.ndarray:
    """Distribute `schedulable` new replicas over domains that already
    hold `counts` matching pods, filling the least-loaded first (the
    only incremental order the skew check always admits: each placement
    lands on a current global minimum), capped per-domain by `caps`
    (None = unbounded). Returns per-domain additions. The remainder at
    the final water level rotates by content-keyed `seed`, so no domain
    is systematically overweighted across shapes (and the choice never
    depends on arena-local numbering). All-numpy: runs per dedup row on
    the churned-tick hot path."""
    c = np.asarray(counts, np.int64)
    cap = None if caps is None else np.asarray(caps, np.int64)

    def filled(level: int) -> int:
        add = np.clip(level - c, 0, None)
        if cap is not None:
            add = np.minimum(add, cap)
        return int(add.sum())

    lo = int(c.min())
    hi = (
        int(c.max()) + schedulable
        if cap is None
        else int((c + cap).max())
    )
    hi = max(lo, hi)
    while lo < hi:  # greatest level with filled(level) <= schedulable
        mid = (lo + hi + 1) // 2
        if filled(mid) <= schedulable:
            lo = mid
        else:
            hi = mid - 1
    level = lo
    out = np.clip(level - c, 0, None)
    if cap is not None:
        out = np.minimum(out, cap)
    remainder = schedulable - int(out.sum())
    if remainder:
        at_level = c + out == level
        can_grow = at_level if cap is None else at_level & (out < cap)
        candidates = np.flatnonzero(can_grow)
        if len(candidates):
            offset = seed % len(candidates)
            chosen = (
                np.arange(len(candidates)) - offset
            ) % len(candidates) < remainder
            out[candidates[chosen]] += 1
    return out


_UNBOUNDED = np.iinfo(np.int64).max // 4




def _partition_chunks(additions, masks, view, others_placed, n_groups,  # lint: allow-complexity — the wave loop: reach, floor, fill, charge, refund, repeat to fixpoint
                      seed):
    """Partition each chunk across every partition entry's domains by
    the SAME water-fill the split key uses: each entry's skew binds
    placements to a balanced distribution over its domains, and finite
    caps (occupancy, frozen minima) bound it absolutely. The relative
    bound holds against domains a chunk CANNOT reach, with WAVES to
    the fixpoint: a chunk capped by the floor may admit more once
    other chunks raise the unreachable minima (zone<->rack correlated
    topologies grow in lock-step instead of stranding weight). Totals
    and caps charge the WORKLOAD-shared `others_placed` ledger (keyed
    by entry index + value), so every row of a workload spends one
    budget; weight a LATER entry sheds is REFUNDED along its charge
    history, so phantom charges never starve later rows. Entries apply
    sequentially — a later entry re-partitions the earlier one's
    sub-chunks (product of domain counts at worst, fleet-scale
    constants). Dead groups are excluded from candidacy up front.

    Returns [(rank, count, extra mask or None)] — the pieces the
    caller emits; pods no piece can hold fall out (the caller counts
    them unschedulable). Mutates `others_placed`."""
    dead = view["dead"]
    pieces = []  # (rank, count, extra mask, charge history)
    for rank in range(len(additions)):
        chunk = int(additions[rank])
        if chunk:
            pieces.append((rank, chunk, None, ()))
    if not view["others"] or not pieces:
        return [(rank, count, extra) for rank, count, extra, _ in pieces]

    refunded = [False]

    def refund(history, amount):
        refunded[0] = True
        for ledger, value in history:
            ledger[value] = ledger.get(value, 0) - amount

    for entry_idx, skew, value_groups, caps2, counts2 in view["others"]:
        group_value = {}
        for value, groups in value_groups.items():
            for t in groups:
                group_value[t] = value
        placed = others_placed.setdefault(entry_idx, {})
        work = []  # (rank, remaining, extra, history, reachable)
        for rank, count, extra, history in pieces:
            allowed = ~masks[rank]
            if dead is not None:
                allowed = allowed & ~dead
            if extra is not None:
                allowed = allowed & ~extra
            reachable = sorted(
                {
                    group_value[t]
                    for t in np.flatnonzero(allowed)
                    if t in group_value
                }
            )
            work.append([rank, count, extra, history, reachable])
        taken = [dict() for _ in work]  # value -> count per piece
        progressed = True
        while progressed:
            progressed = False
            for w, (rank, remaining, _extra, _hist, reachable) in enumerate(
                work
            ):
                if remaining == 0 or not reachable:
                    continue
                totals = [
                    counts2.get(v, 0) + placed.get(v, 0)
                    for v in reachable
                ]
                floor = min(
                    counts2.get(v, 0) + placed.get(v, 0)
                    for v in value_groups
                )
                caps = []
                for v, total_v in zip(reachable, totals):
                    cap = caps2.get(v)
                    relative = max(0, floor + skew - total_v)
                    cap_v = (
                        relative
                        if cap is None
                        else min(
                            relative,
                            max(0, cap - placed.get(v, 0)),
                        )
                    )
                    caps.append(min(remaining, cap_v))
                schedulable = min(remaining, int(np.sum(caps)))
                if schedulable == 0:
                    continue
                adds = _water_fill(
                    totals, caps, schedulable, seed + rank
                )
                for j, value in enumerate(reachable):
                    take = int(adds[j])
                    if take:
                        taken[w][value] = taken[w].get(value, 0) + take
                        placed[value] = placed.get(value, 0) + take
                work[w][1] = remaining - schedulable
                progressed = True
        next_pieces = []
        for w, (rank, remaining, extra, history, _reachable) in enumerate(
            work
        ):
            if remaining:
                # this entry shed weight an EARLIER entry already
                # charged for: refund it, or the phantom charge starves
                # later rows (the charge-by-final-take rule, r3)
                refund(history, remaining)
            for value in sorted(taken[w]):
                restrict = np.ones(n_groups, bool)
                restrict[value_groups[value]] = False
                next_pieces.append(
                    [
                        rank,
                        taken[w][value],
                        restrict
                        if extra is None
                        else (extra | restrict),
                        (*history, (placed, value)),
                    ]
                )
        pieces = next_pieces

    # CASCADE: a refund at a later entry can invalidate the relative
    # floor that JUSTIFIED an earlier allocation (r0's third pod was
    # legal only while r1 held the charge the zone stage then shed —
    # soundness fuzz, heavy sweep). Verify every entry against the
    # FINAL ledgers and shed the excess from THIS row's pieces until
    # stable; prior rows stay valid because refunds only remove this
    # row's charges, so totals never drop below their end state. With
    # no refund, charges only grew the floor: nothing to verify.
    changed = refunded[0]
    while changed:
        changed = False
        for entry_idx, skew, value_groups, caps2, counts2 in (
            view["others"]
        ):
            ledger = others_placed[entry_idx]
            totals = {
                v: counts2.get(v, 0) + ledger.get(v, 0)
                for v in value_groups
            }
            floor = min(totals.values())
            for v in sorted(value_groups):
                excess = totals[v] - (floor + skew)
                cap = caps2.get(v)
                if cap is not None:
                    excess = max(excess, ledger.get(v, 0) - cap)
                if excess <= 0:
                    continue
                for piece in reversed(pieces):
                    if excess <= 0:
                        break
                    if piece[1] and any(
                        led is ledger and val == v
                        for led, val in piece[3]
                    ):
                        take = min(piece[1], excess)
                        piece[1] -= take
                        excess -= take
                        refund(piece[3], take)
                        changed = True
    return [
        (rank, count, extra)
        for rank, count, extra, _ in pieces
        if count
    ]

