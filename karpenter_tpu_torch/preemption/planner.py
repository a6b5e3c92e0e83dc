"""Preemption planner: encode the fleet's eviction-planning problem (the
port's copy of karpenter_tpu/preemption/planner.py).

The consolidation planner (consolidation/planner.py) asks "can this
node's pods re-pack elsewhere?"; this planner asks the dual question —
"which occupancy do I evict to place THIS pending pod?" — and encodes it
for the batched eviction kernel (ops/preempt.py) in one PreemptInputs:

  * the NODE axis is the cluster's nodes (one column per node,
    reusing the consolidation ClusterView's free-capacity accounting:
    allocatable minus scheduler-effective bound requests);
  * the CANDIDATE axis is the high-priority pending pods, with
    per-(candidate, node) feasibility — nodeSelector, required node
    affinity, untolerated hard taints, not-ready/cordoned receivers,
    coordination holds — folded host-side into pod_node_forbidden
    (the same fold consolidation does, at the same KB scale);
  * the VICTIM axis is the bound occupancy, sorted by (node, priority,
    name) — the kernel's sorted-victim contract — with the policy mask
    (do-not-disrupt pods/nodes, held nodes) in victim_evictable;
  * node_tier marks preemptible/spot capacity: the capacity-type node
    labels (api/core.capacity_tier_of) OR an owning ScalableNodeGroup
    with spec.preemptible — victims there are evictable-by-contract
    regardless of priority (the spot-reclaim model).

The kernel plans candidates independently; conflict resolution (two
plans claiming one victim), budgets, and actuation live in engine.py.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.api.core import (
    Taint,
    capacity_tier_of,
    effective_priority,
)
from karpenter_tpu_torch.consolidation.planner import (
    ClusterView,
    _pod_compatible,
    _opted_out,
    request_row,
    resource_universe_for,
)
from karpenter_tpu_torch.ops.preempt import MAX_VICTIMS, PreemptInputs


def _resource_universe(view: ClusterView, candidates: List) -> List[str]:
    """The preemption universe: node free capacity + EVERY bound pod
    (the victims) + the pending candidates — the shared
    consolidation-planner rule over this planner's pod set."""
    import itertools

    return resource_universe_for(
        view,
        itertools.chain(
            (pod for nv in view.nodes for pod in nv.pods), candidates
        ),
    )


def _victim_axis(
    view: ClusterView,
    resources: List[str],
    default_priority: int,
    excluded: FrozenSet[str],
    max_victims: int,
):
    """(requests, priority, node, evictable, keys): the bound occupancy
    sorted by (node column, priority, name) — the kernel's contract.
    Overflow past max_victims drops the HIGHEST-priority victims first
    (the least evictable ones — strictly conservative: dropping a
    victim only removes eviction options, never invents them)."""
    rows = []  # (node_col, priority, name_key, pod, evictable)
    for col, nv in enumerate(view.nodes):
        node_blocked = (
            nv.name in excluded or _opted_out(nv.node)
        )
        for pod in nv.pods:
            rows.append(
                (
                    col,
                    effective_priority(pod, default=default_priority),
                    (pod.metadata.namespace, pod.metadata.name),
                    pod,
                    not node_blocked and not _opted_out(pod),
                )
            )
    if len(rows) > max_victims:
        rows = sorted(rows, key=lambda r: (r[1], r[0], r[2]))[:max_victims]
    rows.sort(key=lambda r: (r[0], r[1], r[2]))
    v = len(rows)
    requests = np.zeros((v, len(resources)), np.float32)
    priority = np.zeros(v, np.int32)
    node = np.zeros(v, np.int32)
    evictable = np.zeros(v, bool)
    keys: List[Tuple[str, str]] = []
    for i, (col, prio, key, pod, ok) in enumerate(rows):
        requests[i] = request_row(pod, resources)
        priority[i] = prio
        node[i] = col
        evictable[i] = ok
        keys.append(key)
    return requests, priority, node, evictable, keys


def _tier_of(nv, preemptible_groups) -> int:
    """1 = preemptible/spot: the capacity-type node labels OR a
    spec.preemptible owning group."""
    if capacity_tier_of(nv.node.metadata.labels) > 0:
        return 1
    if (
        nv.group is not None
        and (nv.group[0], nv.group[2]) in preemptible_groups
    ):
        return 1
    return 0


def _node_axis(
    view: ClusterView, candidates, resources, excluded_nodes,
    preemptible_groups,
):
    """(node_free, node_tier, forbidden): the shared node-column
    operands — free capacity, capacity tier (spot labels OR a
    spec.preemptible owner), and the host-folded per-(candidate, node)
    feasibility mask (selectors/affinity/taints, non-receivers,
    coordination holds)."""
    n, c = len(view.nodes), len(candidates)
    node_free = np.zeros((n, len(resources)), np.float32)
    node_tier = np.zeros(n, np.int32)
    forbidden = np.zeros((c, n), bool)
    for col, nv in enumerate(view.nodes):
        for r, resource in enumerate(resources):
            node_free[col, r] = nv.free.get(resource, 0.0)
        node_tier[col] = _tier_of(nv, preemptible_groups)
        if not nv.receiver or nv.name in excluded_nodes:
            forbidden[:, col] = True
            continue
        labels = dict(nv.node.metadata.labels)
        hard_taints = [
            Taint(key=t.key, value=t.value, effect=t.effect)
            for t in nv.node.spec.taints
            if t.effect in ("NoSchedule", "NoExecute")
        ]
        for i, pod in enumerate(candidates):
            if not _pod_compatible(pod, labels, hard_taints):
                forbidden[i, col] = True
    return node_free, node_tier, forbidden


def build_problem(
    view: ClusterView,
    candidates: List,
    default_priority: int = 0,
    excluded_nodes: FrozenSet[str] = frozenset(),
    preemptible_groups: FrozenSet[Tuple[str, str]] = frozenset(),
    max_victims: int = MAX_VICTIMS,
) -> Tuple[PreemptInputs, List[Tuple[str, str]], List[str]]:
    """(inputs, victim_keys, node_names) for the given candidate pods.

    `excluded_nodes` are coordination holds — nodes the consolidation
    FSM (or a previous preemption round) currently owns: their columns
    are forbidden receivers AND their pods non-evictable, so the two
    disruption engines can never fight over one node.
    `preemptible_groups` are (namespace, nodeGroupRef) pairs whose
    ScalableNodeGroup declares spec.preemptible."""
    resources = _resource_universe(view, candidates)
    c = len(candidates)
    node_free, node_tier, forbidden = _node_axis(
        view, candidates, resources, excluded_nodes, preemptible_groups
    )

    pod_requests = np.zeros((c, len(resources)), np.float32)
    pod_priority = np.zeros(c, np.int32)
    for i, pod in enumerate(candidates):
        pod_requests[i] = request_row(pod, resources)
        pod_priority[i] = effective_priority(
            pod, default=default_priority
        )

    vreq, vprio, vnode, vevict, victim_keys = _victim_axis(
        view, resources, default_priority, excluded_nodes, max_victims
    )
    inputs = PreemptInputs(
        pod_requests=pod_requests,
        pod_priority=pod_priority,
        pod_valid=np.ones(c, bool),
        pod_node_forbidden=forbidden,
        node_free=node_free,
        node_tier=node_tier,
        victim_requests=vreq,
        victim_priority=vprio,
        victim_node=vnode,
        victim_valid=np.ones(len(victim_keys), bool),
        victim_evictable=vevict,
    )
    return inputs, victim_keys, [nv.name for nv in view.nodes]


def plan_rows(out, victim_keys: List[Tuple[str, str]], node_names: List[str]) -> List[Optional[Dict]]:
    """Decode PreemptOutputs into per-candidate plan dicts:
    {"node": name, "evictions": [(ns, name), ...]} — None for
    unplaceable candidates. Zero-eviction plans come back with an empty
    eviction list (the pod fits already; nothing to actuate)."""
    chosen = np.asarray(out.chosen_node)
    mask = np.asarray(out.evict_mask)
    plans: List[Optional[Dict]] = []
    for i in range(chosen.shape[0]):
        col = int(chosen[i])
        if col < 0:
            plans.append(None)
            continue
        plans.append(
            {
                "node": node_names[col],
                "evictions": [
                    victim_keys[v] for v in np.nonzero(mask[i])[0]
                ],
            }
        )
    return plans
