"""Consolidation planner: batched on-device node-drain feasibility (the
port's copy of karpenter_tpu/consolidation/planner.py).

The reference Karpenter only ever moves replica COUNTS; it never asks
which concrete nodes are safe to remove, so fragmented groups stay
over-provisioned forever. The consolidation question — "for each
candidate node, can its pods re-pack onto the remainder of the
cluster?" — is one masked bin-pack per candidate, and the mask is the
only thing that differs between candidates, which makes the whole
evaluation one batched device call:

  * the GROUP axis is the cluster's nodes themselves, one column per
    node, allocatable = that node's FREE capacity (allocatable minus the
    scheduler-effective requests of its bound pods, clipped at zero);
  * the POD axis of candidate c is the pods bound to c, re-injected as
    pending rows (scheduler-effective requests + one 'pods' slot);
  * per-candidate masking rides the existing `pod_group_forbidden`
    operand: the candidate's own column is forbidden (a drained node
    cannot receive its own pods back), as is every receiver that is not
    ready+schedulable and every (pod, node) pair ruled out by
    nodeSelector, required node affinity, or an untolerated hard taint;
  * a candidate is DRAINABLE iff the masked bin-pack fits everything:
    zero unschedulable rows and `nodes_needed <= 1` for every column —
    each column is one real node, so needing a second node of that shape
    means the free capacity does not absorb the drain.

All candidates share one operand shape bucket (the pod axis floors at
the service ladder's 256 rung; the node axis is the same cluster for
every candidate), so on the torch rung `SolverService.consolidate`
stacks them into ONE batched dispatch and candidate-count jitter meets
no new dispatch key; on the card's cuda rung each candidate is one
launch of each CUDA kernel, at its own pod count.

The verdict is SUFFICIENT, not necessary: assignment routes each pod to
its single best feasible receiver and sizes quantize UP into buckets, so
a drain that only fits by SPLITTING a pod set across receivers that each
individually overflow can be vetoed spuriously. A spurious veto keeps a
node; a spurious approval would strand pods — the planner only errs in
the safe direction, the same posture as the scale-up signal's
conservative group profiles (encoder._group_profile).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.api.core import (
    Taint,
    affinity_shape,
    is_ready_and_schedulable,
    matches_affinity_shape,
    matches_selector,
)
from karpenter_tpu_torch.metrics.producers.pendingcapacity.constants import (
    DEFAULT_PODS_PER_NODE,
)
from karpenter_tpu_torch.ops.binpack import BinPackInputs
from karpenter_tpu_torch.store.columnar import RESOURCE_PODS, is_counted

# Pods (or nodes) carrying this annotation with value "true" are never
# disrupted by consolidation (the karpenter.sh operator contract).
DO_NOT_DISRUPT = "karpenter.sh/do-not-disrupt"

_BASE_RESOURCES = ("cpu", "memory")


@dataclass
class NodeView:
    """One node's consolidation-relevant state, computed once per plan."""

    name: str
    node: object
    pods: List[object]  # bound, non-terminal (the occupancy set)
    free: Dict[str, float]  # allocatable minus reserved, >= 0
    group: Optional[Tuple[str, str, str]] = None  # (ns, producer, ref)
    receiver: bool = True  # ready + schedulable: may absorb drains
    do_not_disrupt: bool = False  # node or any pod opted out


@dataclass
class ClusterView:
    """The columnar consolidation snapshot: every node with its bound
    pods, free capacity, and group membership."""

    nodes: List[NodeView] = field(default_factory=list)

    def by_name(self) -> Dict[str, NodeView]:
        return {v.name: v for v in self.nodes}


def discover_groups(store) -> List[Tuple[str, str, dict, str]]:
    """(namespace, producer name, node selector, nodeGroupRef) for every
    pendingCapacity producer, in deterministic key order — the same
    group axis the scale-up solve uses. The ref names the
    ScalableNodeGroup (in the producer's namespace) that consolidation
    shrinks; groups without a ref are observed but never actuated."""
    groups = []
    for mp in sorted(
        store.list("MetricsProducer"),
        key=lambda m: (m.metadata.namespace, m.metadata.name),
    ):
        if mp.spec.pending_capacity is None:
            continue
        selector = mp.spec.pending_capacity.node_selector
        if not isinstance(selector, dict):
            continue  # poisoned spec: row-isolated out, like solve_pending
        groups.append(
            (
                mp.metadata.namespace,
                mp.metadata.name,
                selector,
                getattr(mp.spec.pending_capacity, "node_group_ref", ""),
            )
        )
    return groups


def _opted_out(obj) -> bool:
    return (
        obj.metadata.annotations.get(DO_NOT_DISRUPT, "").lower() == "true"
    )


def _free_capacity(node, pods) -> Dict[str, float]:
    """allocatable minus the scheduler-effective requests of the bound
    pods (plus their 'pods' slots), clipped at zero — what the node can
    still absorb."""
    free = {r: q.to_float() for r, q in node.status.allocatable.items()}
    if free.get(RESOURCE_PODS, 0.0) <= 0:
        free[RESOURCE_PODS] = float(DEFAULT_PODS_PER_NODE)
    free[RESOURCE_PODS] -= len(pods)
    for pod in pods:
        for r, q in pod.effective_requests().items():
            free[r] = free.get(r, 0.0) - q.to_float()
    return {r: max(0.0, v) for r, v in free.items()}


def cluster_view(store, groups=None) -> ClusterView:
    """Build the snapshot: one store listing for nodes, the pods-by-node
    index for occupancy, host float math for free capacity. Host cost is
    O(nodes + bound pods) per plan — the per-candidate fit math is what
    the device evaluates."""
    if groups is None:
        groups = discover_groups(store)
    view = ClusterView()
    for node in sorted(
        store.list("Node"), key=lambda n: n.metadata.name
    ):
        pods = [
            p
            for p in store.pods_on_node(node.metadata.name)
            if is_counted(p)
        ]
        group = next(
            (
                (ns, name, ref)
                for ns, name, selector, ref in groups
                if matches_selector(node.metadata.labels, selector)
            ),
            None,
        )
        view.nodes.append(
            NodeView(
                name=node.metadata.name,
                node=node,
                pods=pods,
                free=_free_capacity(node, pods),
                group=group,
                receiver=is_ready_and_schedulable(node),
                do_not_disrupt=_opted_out(node)
                or any(_opted_out(p) for p in pods),
            )
        )
    return view


def is_extended_resource(resource: str) -> bool:
    return resource not in _BASE_RESOURCES and resource != RESOURCE_PODS


def resource_universe_for(view: ClusterView, pods) -> List[str]:
    """cpu/memory + every extended resource in the view's node free
    capacity or the given pods' requests, the 'pods' slot axis always
    LAST — THE single universe rule both disruption planners encode
    against (preemption/planner.py reuses it over its candidate +
    victim pod set; a change here moves both in lockstep)."""
    extended = set()
    for nv in view.nodes:
        extended.update(r for r in nv.free if is_extended_resource(r))
    for pod in pods:
        extended.update(
            r for r in pod.effective_requests()
            if is_extended_resource(r)
        )
    return [*_BASE_RESOURCES, *sorted(extended), RESOURCE_PODS]


def request_row(pod, resources: List[str]) -> np.ndarray:
    """f32[R]: the pod's scheduler-effective requests gathered onto the
    universe axis, its one 'pods' slot included — the single per-pod
    row encoding both disruption planners share."""
    row = np.zeros(len(resources), np.float32)
    requests = {
        r: q.to_float() for r, q in pod.effective_requests().items()
    }
    requests[RESOURCE_PODS] = 1.0
    for r, resource in enumerate(resources):
        row[r] = requests.get(resource, 0.0)
    return row


def _resource_universe(view: ClusterView, candidates: List[NodeView]):
    """The consolidation universe: node free capacity + the DRAIN
    candidates' bound pods (the rows that re-pack)."""
    return resource_universe_for(
        view, (pod for nv in candidates for pod in nv.pods)
    )


def _pod_compatible(pod, node_labels: dict, hard_taints: list) -> bool:
    """Host-side feasibility mask for one (pod, receiver) pair: the same
    constraints the scale-up encoder expresses as bitset matmuls, folded
    into the forbidden operand at consolidation scale (pods-on-one-node
    x nodes, KBs not MBs)."""
    if not matches_selector(node_labels, pod.spec.node_selector):
        return False
    for taint in hard_taints:
        if not any(
            tol.tolerates(taint) for tol in pod.spec.tolerations
        ):
            return False
    shape = affinity_shape(pod.spec.affinity)
    if shape and not matches_affinity_shape(node_labels, shape):
        return False
    return True


def build_problems(
    view: ClusterView, candidate_names: List[str]
) -> Tuple[List[str], List[BinPackInputs], List[str]]:
    """One masked BinPackInputs per candidate with bound pods.

    Returns (solved_names, inputs, trivially_drainable): a candidate
    with zero bound pods needs no solve — there is nothing to re-pack —
    so it is split out rather than encoded as a degenerate zero-row
    problem. Every solved candidate's inputs share the node axis and the
    resource universe, so they land in one service shape bucket."""
    by_name = view.by_name()
    candidates = [by_name[n] for n in candidate_names]
    resources = _resource_universe(view, candidates)
    col = {nv.name: t for t, nv in enumerate(view.nodes)}
    free, node_labels, hard_taints, receiver_ok = _node_axis(
        view, resources
    )
    solved, inputs, trivial = [], [], []
    for nv in candidates:
        if not nv.pods:
            trivial.append(nv.name)
            continue
        solved.append(nv.name)
        inputs.append(
            _candidate_inputs(
                nv, resources, free, receiver_ok, col[nv.name],
                node_labels, hard_taints,
            )
        )
    return solved, inputs, trivial


def _node_axis(view: ClusterView, resources):
    """The shared group-axis operands: free-capacity matrix, per-node
    label dicts, per-node hard taints, and the receiver mask."""
    free = np.zeros((len(view.nodes), len(resources)), np.float32)
    for t, nv in enumerate(view.nodes):
        for r, resource in enumerate(resources):
            free[t, r] = nv.free.get(resource, 0.0)
    node_labels = [dict(nv.node.metadata.labels) for nv in view.nodes]
    hard_taints = [
        [
            Taint(key=t.key, value=t.value, effect=t.effect)
            for t in nv.node.spec.taints
            if t.effect in ("NoSchedule", "NoExecute")
        ]
        for nv in view.nodes
    ]
    receiver_ok = np.array([nv.receiver for nv in view.nodes], bool)
    return free, node_labels, hard_taints, receiver_ok


def _candidate_inputs(
    nv, resources, free, receiver_ok, self_col, node_labels, hard_taints
) -> BinPackInputs:
    """The one masked problem for candidate `nv`: its pods as pending
    rows, the shared node axis, its own column (and every incompatible
    pair) forbidden."""
    p, n_groups = len(nv.pods), free.shape[0]
    pod_requests = np.zeros((p, len(resources)), np.float32)
    forbidden = np.zeros((p, n_groups), bool)
    forbidden[:, ~receiver_ok] = True
    forbidden[:, self_col] = True  # never back onto the drain
    for i, pod in enumerate(nv.pods):
        pod_requests[i] = request_row(pod, resources)
        for t in range(n_groups):
            if not forbidden[i, t] and not _pod_compatible(
                pod, node_labels[t], hard_taints[t]
            ):
                forbidden[i, t] = True
    return BinPackInputs(
        pod_requests=pod_requests,
        pod_valid=np.ones(p, bool),
        # taints/selectors/affinity are folded into the forbidden mask
        # above; the bitset operands stay width-1 zeros (the service
        # pads them to its floors)
        pod_intolerant=np.zeros((p, 1), bool),
        pod_required=np.zeros((p, 1), bool),
        group_allocatable=free,
        group_taints=np.zeros((n_groups, 1), bool),
        group_labels=np.zeros((n_groups, 1), bool),
        pod_group_forbidden=forbidden,
    )


def drainable(output) -> bool:
    """The drain verdict for one masked solve: everything re-packed
    (zero unschedulable weight) and no column needs a second node of
    its shape — each column IS one real node's free capacity."""
    return bool(
        int(np.asarray(output.unschedulable)) == 0
        and (np.asarray(output.nodes_needed) <= 1).all()
    )


def evaluate(
    view: ClusterView,
    candidate_names: List[str],
    service,
    buckets: int = 32,
    backend: Optional[str] = None,
) -> Dict[str, bool]:
    """{candidate: drainable} for every named candidate — the batched
    front door: one `service.consolidate` call (one device dispatch per
    shape bucket), trivially-empty candidates short-circuited."""
    solved, inputs, trivial = build_problems(view, candidate_names)
    verdicts = {name: True for name in trivial}
    if inputs:
        outputs = service.consolidate(
            inputs, buckets=buckets, backend=backend
        )
        for name, output in zip(solved, outputs):
            verdicts[name] = drainable(output)
    return verdicts
