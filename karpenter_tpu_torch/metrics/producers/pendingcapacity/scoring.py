"""Soft-constraint scoring: ScheduleAnyway spread and preferred
inter-pod (anti-)affinity as pod_group_score contributions (the
kube-scheduler scoring plugins — steering, never constraining)."""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.api.core import Taint, preference_score


def _taint_toleration_raw(snap, profiles, row_idx, n_real):
    """TaintToleration plugin: groups with FEWER PreferNoSchedule
    taints the pod does not tolerate rank higher (soft taints never
    gate feasibility — the encoder keeps them out of the intolerance
    bitset). One evaluation per DISTINCT toleration shape, gathered to
    rows by shape id. None when no group carries a soft taint — the
    common fleet pays nothing."""
    soft = [
        [
            Taint(key=k, value=v, effect=e)
            for (k, v, e) in sorted(taints)
            if e == "PreferNoSchedule"
        ]
        for _, _, taints in profiles
    ]
    if not any(soft):
        return None
    shapes = snap.shape_tolerations
    raw = np.zeros((len(shapes), n_real), np.float32)
    for s, tolerations in enumerate(shapes):
        for t, group_soft in enumerate(soft):
            for taint in group_soft:
                if not any(tol.tolerates(taint) for tol in tolerations):
                    raw[s, t] -= 1.0
    return raw[snap.shape_id[row_idx]]


def _live_ids(snap_ids, shapes, row_idx):
    """Per-row shape ids for one plugin, or None when the fleet carries
    none of this preference kind."""
    if snap_ids is None or shapes is None:
        return None
    live = snap_ids[row_idx]
    return live if (live != 0).any() else None


def _node_affinity_raw(shapes, live, label_dicts_fn, n_real):
    """NodeAffinity plugin: preferred-term weight sums
    (api/core.preference_score) per (shape, group)."""
    raw = np.zeros((len(shapes), n_real), np.float32)
    for s in np.unique(live):
        shape = shapes[s]
        if not shape:
            continue
        for t, labels in enumerate(label_dicts_fn()):
            raw[s, t] = preference_score(labels, shape)
    return raw


def _soft_spread_raw(shapes, live, label_dicts_fn, census, n_real):
    """PodTopologySpread plugin (ScheduleAnyway): domains with FEWER
    existing matching pods rank higher; groups missing the key rank
    strictly below every keyed group (the plugin's keyless-node rule)."""
    raw = np.zeros((len(shapes), n_real), np.float32)
    for s in np.unique(live):
        shape = shapes[s]
        if not shape:
            continue
        namespace, entries = shape
        for key, sel in entries:
            counts = (
                census.domain_counts(namespace, sel, key)
                if census is not None and sel is not None
                else {}
            )
            # keyless groups rank strictly below every keyed one
            worst = float(max(counts.values(), default=0)) + 1.0
            for t, labels in enumerate(label_dicts_fn()):
                value = labels.get(key)
                raw[s, t] -= (
                    float(counts.get(value, 0))
                    if value is not None
                    else worst
                )
    return raw


def _soft_anti_raw(shapes, live, label_dicts_fn, census, n_real):
    """InterPodAffinity plugin: preferred self-(anti-)affinity terms add
    sign x weight per existing matching pod in the group's domain."""
    raw = np.zeros((len(shapes), n_real), np.float32)
    for s in np.unique(live):
        shape = shapes[s]
        if not shape:
            continue
        namespace, entries = shape
        for sign, weight, key, sel in entries:
            counts = census.domain_counts(namespace, sel, key)
            for t, labels in enumerate(label_dicts_fn()):
                value = labels.get(key)
                if value is not None:
                    raw[s, t] += (
                        sign * weight * float(counts.get(value, 0))
                    )
    return raw


def _score_pieces(snap, profiles, row_idx, label_dicts_fn, census, n_real):
    """(plugin weight, raw[hi, n_real]) per active scoring plugin."""
    pieces = []

    taint_raw = _taint_toleration_raw(snap, profiles, row_idx, n_real)
    if taint_raw is not None and taint_raw.any():
        # all-zero contributions (every pod tolerates every soft taint)
        # must not put the fleet on the scored kernel path
        pieces.append((3.0, taint_raw))

    live = _live_ids(snap.preferred_id, snap.preferred_shapes, row_idx)
    if live is not None:
        raw = _node_affinity_raw(
            snap.preferred_shapes, live, label_dicts_fn, n_real
        )
        pieces.append((1.0, raw[live]))

    live = _live_ids(snap.soft_spread_id, snap.soft_spread_shapes, row_idx)
    if live is not None:
        raw = _soft_spread_raw(
            snap.soft_spread_shapes, live, label_dicts_fn, census, n_real
        )
        pieces.append((2.0, raw[live]))

    live = _live_ids(snap.soft_anti_id, snap.soft_anti_shapes, row_idx)
    if live is not None and census is not None:
        raw = _soft_anti_raw(
            snap.soft_anti_shapes, live, label_dicts_fn, census, n_real
        )
        if raw.any():
            pieces.append((1.0, raw[live]))
    return pieces


def _score_rows(
    snap, profiles, row_idx, label_dicts_fn, census, n_pods, n_groups
):
    """The kube-scheduler's scoring plugins over candidate groups ->
    the solver's pod_group_score operand (argmax among feasible, index
    tie-break). Three plugins, combined with the scheduler's default
    weights after per-row min-max normalization to 0..100 (min-max is
    monotone, so a fleet using only ONE plugin keeps exactly the raw
    scores' argmax and tie-break order):

    - NodeAffinity (weight 1): preferred-term weight sums
      (api/core.preference_score).
    - PodTopologySpread (weight 2): ScheduleAnyway constraints prefer
      domains with FEWER existing matching pods (DomainCensus counts);
      groups missing the key rank below every keyed group, matching
      the scoring plugin's treatment of keyless nodes.
    - InterPodAffinity (weight 1): preferred self-(anti-)affinity
      terms add sign x weight per existing matching pod in the
      group's domain.
    - TaintToleration (weight 3): groups with fewer PreferNoSchedule
      taints the pod does not tolerate rank higher.

    Returns None when no live row carries any preference AND no group
    carries a soft taint — the common fleet skips the score operand
    entirely. census=None (hand-built snapshots) scores with zero
    counts: spread still ranks keyless groups last; inter-pod terms
    contribute nothing.
    """
    hi = len(row_idx)
    if hi == 0:
        return None
    n_real = len(profiles)
    pieces = _score_pieces(
        snap, profiles, row_idx, label_dicts_fn, census, n_real
    )
    if not pieces:
        return None
    acc = np.zeros((hi, n_real), np.float32)
    for weight, raw in pieces:
        lo = raw.min(axis=1, keepdims=True)
        rng = raw.max(axis=1, keepdims=True) - lo
        safe = np.where(rng > 0, rng, 1.0)
        acc += weight * np.where(rng > 0, (raw - lo) / safe * 100.0, 0.0)
    total = np.zeros((n_pods, n_groups), np.float32)
    total[:hi, :n_real] = acc
    return total
