"""Core object model: metadata, Nodes, Pods.

These mirror the slices of the k8s core/v1 API the reference consumes — Node
readiness/allocatable (reference: pkg/utils/node/predicates.go:18-25,
pkg/metrics/producers/reservedcapacity/reservations.go:45-56) and Pod
nodeName/requests, extended with the scheduling-constraint fields
(tolerations, nodeSelector, affinity) that the pending-capacity bin-pack
solver consumes (reference design: docs/designs/DESIGN.md "Pending Pods").
"""

from __future__ import annotations

import itertools
import time as _time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from karpenter_tpu_torch.utils.quantity import Quantity, parse_quantity

_uid_counter = itertools.count(1)
_process_id = uuid.uuid4().hex[:8]

RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_PODS = "pods"


@dataclass(slots=True)
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    uid: str = ""
    # int when minted by the local store; may be an opaque string when
    # sourced from a real apiserver (k8s API conventions) — compare only
    # for equality
    resource_version: Union[int, str] = 0
    creation_timestamp: float = 0.0

    def ensure_identity(self):
        if not self.uid:
            # process-unique prefix: a restarted control plane resuming a
            # durable store must never mint a uid already held by a
            # recovered object (the k8s uid contract distinguishes object
            # incarnations)
            self.uid = f"uid-{_process_id}-{next(_uid_counter)}"
        if not self.creation_timestamp:
            self.creation_timestamp = _time.time()


def resource_list(**kwargs) -> Dict[str, Quantity]:
    """Build a {resource: Quantity} map from keyword strings, e.g.
    resource_list(cpu="1100m", memory="1Gi")."""
    return {k: parse_quantity(v) for k, v in kwargs.items()}


@dataclass(slots=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" tolerates all effects

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclass(slots=True)
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass(slots=True)
class NodeSelectorRequirement:
    """One matchExpression (core/v1): key OPERATOR values. Operators are
    the scheduler's set: In, NotIn, Exists, DoesNotExist, Gt, Lt (Gt/Lt
    compare the label value and values[0] as integers)."""

    key: str = ""
    operator: str = "In"
    values: List[str] = field(default_factory=list)


@dataclass(slots=True)
class NodeSelectorTerm:
    # matchFields (metadata.name selection) is not modeled: node groups,
    # not individual nodes, are the scale-up unit here
    match_expressions: List[NodeSelectorRequirement] = field(
        default_factory=list
    )


@dataclass(slots=True)
class NodeSelector:
    node_selector_terms: List[NodeSelectorTerm] = field(default_factory=list)


@dataclass(slots=True)
class PreferredSchedulingTerm:
    weight: int = 1  # 1-100 (core/v1)
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass(slots=True)
class NodeAffinity:
    required_during_scheduling_ignored_during_execution: Optional[
        NodeSelector
    ] = None
    # soft ordering: never makes an infeasible group feasible, but among
    # feasible groups the solver assigns each pod to its highest-scoring
    # group (weight-sum of matching preferences), index tie-break — the
    # kube-scheduler's NodeAffinity scoring plugin semantics
    preferred_during_scheduling_ignored_during_execution: List[
        PreferredSchedulingTerm
    ] = field(default_factory=list)


@dataclass(slots=True)
class LabelSelector:
    """metav1.LabelSelector: matchLabels AND matchExpressions (In/NotIn/
    Exists/DoesNotExist over LABEL values — no Gt/Lt here, matching the
    k8s API). An empty selector matches everything; None (field absent)
    matches nothing in the affinity contexts that use it."""

    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[NodeSelectorRequirement] = field(
        default_factory=list
    )

    def matches(self, labels: Dict[str, str]) -> bool:
        if any(labels.get(k) != v for k, v in self.match_labels.items()):
            return False
        for e in self.match_expressions:
            if e.operator in ("Gt", "Lt"):
                return False  # invalid in label selectors: never matches
            if not _requirement_matches(labels, e.key, e.operator, e.values):
                return False
        return True


@dataclass(slots=True)
class PodAffinityTerm:
    """core/v1 PodAffinityTerm: pods matching label_selector in the
    namespace scope, co-/anti-located by topology_key. namespaces=[]
    means the pod's own namespace (the k8s default).
    matchLabelKeys/mismatchLabelKeys (k8s >= 1.29) merge the INCOMING
    pod's values for those keys into the selector as In/NotIn
    requirements before shape canonicalization — the per-revision
    anti-affinity pattern (pod-template-hash): a mismatch key on the
    pod's own labels turns a self-matching selector into a foreign one
    automatically."""

    label_selector: Optional[LabelSelector] = None
    topology_key: str = ""
    namespaces: List[str] = field(default_factory=list)
    namespace_selector: Optional[LabelSelector] = None
    match_label_keys: List[str] = field(default_factory=list)
    mismatch_label_keys: List[str] = field(default_factory=list)


@dataclass(slots=True)
class WeightedPodAffinityTerm:
    weight: int = 1
    pod_affinity_term: PodAffinityTerm = field(
        default_factory=PodAffinityTerm
    )


@dataclass(slots=True)
class PodAntiAffinity:
    required_during_scheduling_ignored_during_execution: List[
        PodAffinityTerm
    ] = field(default_factory=list)
    # soft anti-affinity is a scheduler preference: the self-matching
    # slice is SCORED (soft_pod_affinity_shape -> pod_group_score),
    # never constrained
    preferred_during_scheduling_ignored_during_execution: List[
        WeightedPodAffinityTerm
    ] = field(default_factory=list)


@dataclass(slots=True)
class PodAffinity:
    required_during_scheduling_ignored_during_execution: List[
        PodAffinityTerm
    ] = field(default_factory=list)
    preferred_during_scheduling_ignored_during_execution: List[
        WeightedPodAffinityTerm
    ] = field(default_factory=list)


@dataclass(slots=True)
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    # inter-pod (anti-)affinity: the SELF-matching required slice is
    # constrained (pod_affinity_shape), the self-matching preferred
    # slice scored (soft_pod_affinity_shape), and required FOREIGN
    # selectors enforced against SCHEDULED state through the occupancy
    # census (_foreign_terms); only pending-vs-pending interactions and
    # namespaceSelector terms stay decode-only (docs/OPERATIONS.md
    # 'Scheduling fidelity')
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


@dataclass(slots=True)
class TopologySpreadConstraint:
    """core/v1 TopologySpreadConstraint. The solver honors DoNotSchedule
    constraints via water-filled domain splitting against the EXISTING
    matching-pod counts per domain — labelSelector (refined by
    matchLabelKeys with the pod's own values) drives the census
    (producers/pendingcapacity.DomainCensus) exactly as the scheduler's
    skew check counts it. ScheduleAnyway is a scheduler preference:
    scored against the same census (soft_spread_shape ->
    pod_group_score), never constrained (docs/OPERATIONS.md
    'Scheduling fidelity')."""

    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = "DoNotSchedule"
    label_selector: Optional[dict] = None
    min_domains: Optional[int] = None
    node_affinity_policy: str = ""
    node_taints_policy: str = ""
    match_label_keys: List[str] = field(default_factory=list)


# hostname spread = at most maxSkew more pods than the emptiest node; a
# fresh scale-up places balanced across the nodes it adds, so the
# constraint is satisfiable at any node count the pack chooses (see
# spread_shape below) — it neither splits nor excludes groups
HOSTNAME_TOPOLOGY_KEY = "kubernetes.io/hostname"


def raw_selector_form(raw: Optional[dict]) -> Optional[tuple]:
    """Canonical hashable form of a RAW (manifest-shaped) LabelSelector
    dict — the TopologySpreadConstraint.label_selector dialect
    (matchLabels/matchExpressions, camelCase keys). Same form as
    _selector_form so both dialects share selector_form_matches. None
    when the field is absent: a spread constraint without a selector
    counts no pods (metav1 semantics: nil selector selects nothing)."""
    if raw is None or not isinstance(raw, dict):
        return None
    return (
        tuple(sorted((raw.get("matchLabels") or {}).items())),
        tuple(
            sorted(
                (
                    e.get("key", ""),
                    e.get("operator", ""),
                    tuple(sorted(e.get("values") or ())),
                )
                for e in (raw.get("matchExpressions") or [])
            )
        ),
    )


def selector_form_matches(form: tuple, labels: Dict[str, str]) -> bool:
    """Evaluate a canonical selector form (_selector_form /
    raw_selector_form) against a label set — LabelSelector.matches
    semantics: matchLabels AND matchExpressions, empty selector matches
    everything, Gt/Lt invalid in label selectors (never match)."""
    match_labels, expressions = form
    if any(labels.get(k) != v for k, v in match_labels):
        return False
    for key, operator, values in expressions:
        if operator in ("Gt", "Lt"):
            return False
        if not _requirement_matches(labels, key, operator, values):
            return False
    return True


def spread_shape(
    constraints: Optional[list],
    namespace: str = "",
    labels: Optional[Dict[str, str]] = None,
) -> tuple:
    """Canonical hashable form of a pod's HARD topology spread:
    (namespace, entries) where entries are sorted (topologyKey, maxSkew,
    minDomains, selectorForm, selfMatch, honorAffinity) tuples for
    DoNotSchedule constraints on non-hostname keys (per (key, selector,
    policy): smallest skew and largest minDomains win — the most
    restrictive combination; differing policies stay separate entries
    since each is enforced independently). () = unconstrained. The namespace and
    the constraint's labelSelector (raw_selector_form; None = counts
    nothing) scope the EXISTING-pod domain counts
    (producers/pendingcapacity.DomainCensus) that the split honors;
    selfMatch records whether the POD ITSELF matches the selector (the
    kube-scheduler's selfMatchNum): only then do placed replicas
    accumulate into the skew the next placement sees. honorAffinity is
    the constraint's nodeAffinityPolicy (default Honor): with Ignore,
    ALL live nodes exposing the key define domains and counts, not just
    the ones passing the pod's nodeSelector + required affinity.

    hostname-keyed constraints are dropped here by design: domains are
    individual nodes, and balanced placement across the nodes a scale-up
    adds satisfies any maxSkew >= 1 — whereas zone/region-like keys bind
    the GROUP choice, which is what the bin-pack decides. ScheduleAnyway
    is soft (scheduler preference), never a constraint."""
    if not constraints:
        return ()
    binding = _bind_spread_constraints(constraints, labels)
    if not binding:
        return ()
    entries = tuple(
        (
            key,
            skew,
            min_domains,
            sel,
            sel is not None and selector_form_matches(sel, labels or {}),
            honor,
        )
        for (key, sel, honor), (skew, min_domains) in sorted(
            binding.items(),
            # None sorts apart from tuple selector forms
            key=lambda kv: (
                kv[0][0],
                kv[0][1] is not None,
                kv[0][1] or (),
                kv[0][2],
            ),
        )
    )
    return (namespace, entries)


def _bind_spread_constraints(
    constraints: list, labels: Optional[Dict[str, str]]
) -> Dict[tuple, Tuple[int, int]]:
    """(key, selectorForm, honorAffinity) -> (maxSkew, minDomains) for the
    binding (DoNotSchedule, non-hostname) constraints.

    Identity is (key, selector, affinityPolicy): constraints differing in
    ANY of those are enforced independently by the scheduler, so they must
    stay separate entries — merging a Honor and an Ignore view of the same
    selector could loosen the caps either view enforces alone. Within
    one identity, smallest skew and largest minDomains
    win — the most restrictive combination."""
    binding: Dict[tuple, Tuple[int, int]] = {}
    for c in constraints:
        if (
            c.when_unsatisfiable == "DoNotSchedule"
            and c.topology_key
            and c.topology_key != HOSTNAME_TOPOLOGY_KEY
        ):
            skew = max(1, int(c.max_skew))
            min_domains = max(0, int(c.min_domains or 0))
            honor = c.node_affinity_policy != "Ignore"
            sel = _spread_selector(c, labels)
            prev = binding.get((c.topology_key, sel, honor))
            if prev is not None:
                skew = min(prev[0], skew)
                min_domains = max(prev[1], min_domains)
            binding[(c.topology_key, sel, honor)] = (skew, min_domains)
    return binding


def _refine_term(term: "PodAffinityTerm", labels: Dict[str, str]):
    """PodAffinityTerm with matchLabelKeys/mismatchLabelKeys (k8s >=
    1.29) merged into the selector: the incoming pod's value for each
    present key becomes an In (match) or NotIn (mismatch) requirement;
    keys the pod doesn't carry are ignored, and the API forbids the
    fields without a labelSelector. Everything downstream (self/foreign
    classification, census matching) then sees the effective
    selector."""
    if not (term.match_label_keys or term.mismatch_label_keys):
        return term
    if term.label_selector is None:
        return term
    extra = []
    for key in sorted(set(term.match_label_keys)):
        if key in labels:
            extra.append(
                NodeSelectorRequirement(
                    key=key, operator="In", values=[labels[key]]
                )
            )
    for key in sorted(set(term.mismatch_label_keys)):
        if key in labels:
            extra.append(
                NodeSelectorRequirement(
                    key=key, operator="NotIn", values=[labels[key]]
                )
            )
    if not extra:
        return term
    return PodAffinityTerm(
        label_selector=LabelSelector(
            match_labels=dict(term.label_selector.match_labels),
            match_expressions=[
                *term.label_selector.match_expressions,
                *extra,
            ],
        ),
        topology_key=term.topology_key,
        namespaces=list(term.namespaces or []),
        namespace_selector=term.namespace_selector,
    )


def _self_matching_terms(
    terms: list,
    labels: Dict[str, str],
    namespace: str,
    assume_ns_selector: bool = False,
) -> list:
    """The PodAffinityTerms whose selector matches the POD'S OWN labels
    with the pod's own namespace in scope — the replica-spread /
    replica-co-location pattern, the only inter-pod slice a group-level
    scale-up signal can honor without pairwise pod state.

    assume_ns_selector (the ANTI call): a namespaceSelector term whose
    selector matches the pod's own labels is ALSO treated as self —
    whether the own namespace's labels match can't be known at shape
    build, and assuming they do only adds the 1-per-domain restriction
    among the pending replicas, which is conservative for an
    anti-affinity. The CO call must NOT assume it: own-in-scope would
    grant the first-replica bootstrap the scheduler may not give."""
    out = []
    for term in terms:
        if term.label_selector is None or not term.topology_key:
            continue
        if term.namespace_selector is not None and not assume_ns_selector:
            continue
        if (
            term.namespace_selector is None
            and term.namespaces
            and namespace not in term.namespaces
        ):
            continue
        if term.label_selector.matches(labels):
            out.append(term)
    return out


def pod_affinity_shape(
    affinity: Optional[Affinity],
    labels: Dict[str, str],
    namespace: str,
) -> tuple:
    """Canonical hashable form of a pod's REQUIRED inter-pod
    (anti-)affinity, restricted to the SELF-matching slice the solver
    models (docs/OPERATIONS.md 'Scheduling fidelity'):

    - anti-affinity on kubernetes.io/hostname -> one replica per node
      (the pod_exclusive solver operand);
    - anti-affinity on zone/region-like keys -> at most one replica per
      topology domain (per-domain cap-1 row expansion);
    - affinity (co-location) on non-hostname keys -> all replicas in
      ONE domain: groups must expose the key single-valued, and the
      solver's whole-row-to-one-group assignment provides the rest.
      hostname co-location (all replicas on one NODE) is modeled
      CONSERVATIVELY: with a matching scheduled pod anywhere in scope,
      new replicas are pinned to its existing node — honestly
      unschedulable on a scale-up (the sign +2 projection below); with
      none, the first-replica bootstrap admits ONE promised replica
      and the rest are reported unschedulable, since replicas beyond
      the first must join the first's node and a group-level pack
      cannot promise single-node co-residence.

    Returns () when unconstrained, else
    (flags, anti_keys, co_keys, ident, foreign) where flags bit 0 is
    hostname anti (exclusive rows) and bit 1 hostname co, and where
    ident is the WORKLOAD IDENTITY: the pod's namespace plus the
    canonical forms of the self-matching domain-relevant selectors. Two
    pods share an anti-group iff they match each other's selectors;
    replicas of one workload share the selector even when their LABELS
    differ per pod (StatefulSets stamp
    statefulset.kubernetes.io/pod-name on each replica — raw labels
    would fragment the group), and two workloads whose
    pods all match one selector genuinely are one mutual anti-group.
    `foreign` is the required terms whose selectors match OTHER
    workloads' pods (_foreign_terms), enforced against SCHEDULED state
    through the occupancy census. Preferred (soft) foreign terms are
    decoded, never constrained.
    """
    if affinity is None:
        return ()
    anti = affinity.pod_anti_affinity
    co = affinity.pod_affinity
    # matchLabelKeys/mismatchLabelKeys refine every term FIRST, so the
    # self/foreign split and the census all see the effective selector
    def refined_required(block):
        if block is None:
            return []
        return [
            _refine_term(t, labels)
            for t in block.required_during_scheduling_ignored_during_execution
        ]

    anti_required = refined_required(anti)
    co_required = refined_required(co)
    anti_terms = _self_matching_terms(
        anti_required, labels, namespace, assume_ns_selector=True
    )
    co_terms = _self_matching_terms(co_required, labels, namespace)
    flags = _hostname_flags(anti_terms, co_terms)
    anti_keys = _domain_keys(anti_terms)
    co_keys = _domain_keys(co_terms)
    foreign = _foreign_terms(
        anti_required, co_required, namespace, anti_terms, co_terms
    )
    if not flags and not anti_keys and not co_keys and not foreign:
        return ()
    ident = _workload_ident(namespace, anti_keys, co_keys, anti_terms, co_terms)
    return (flags, anti_keys, co_keys, ident, foreign)


def _hostname_flags(anti_terms: list, co_terms: list) -> int:
    """shape[0] is a FLAGS field: bit 0 = hostname ANTI (one replica per
    node, the pod_exclusive operand), bit 1 = hostname CO (all replicas
    on one node — census-pinned via the sign +2 foreign projection,
    bootstrap capped to one promised replica)."""
    flags = int(
        any(t.topology_key == HOSTNAME_TOPOLOGY_KEY for t in anti_terms)
    )
    if any(t.topology_key == HOSTNAME_TOPOLOGY_KEY for t in co_terms):
        flags |= 2
    return flags


def _workload_ident(
    namespace: str, anti_keys, co_keys, anti_terms, co_terms
) -> tuple:
    """The WORKLOAD IDENTITY: the pod's namespace plus the canonical
    forms of the self-matching domain-relevant selectors (see
    pod_affinity_shape docstring for why selectors, not raw labels)."""
    if not (anti_keys or co_keys):
        return ()
    return (
        namespace,
        tuple(
            sorted(
                {
                    _selector_form(t.label_selector)
                    for t in (*anti_terms, *co_terms)
                    if t.topology_key != HOSTNAME_TOPOLOGY_KEY
                }
            )
        ),
    )


def _term_ns_scope(t, listed: tuple):
    """The tagged ("selector", ...) scope for a namespaceSelector term;
    None when the term scopes by explicit names / own namespace only."""
    if t.namespace_selector is not None:
        return ("selector", _selector_form(t.namespace_selector), listed)
    return None


def _resolved_scope(scope, listed: tuple, namespace: str):
    """Resolve the k8s default at build time: an empty namespaces list
    means the POD'S OWN namespace."""
    if scope is not None:
        return scope
    return ("names", listed or (namespace,))


def _own_term_entries(sign, t, scope, listed, namespace):
    """Foreign-mask entries projected for a SELF-matching term.

    The self-matching slice is modeled by the self machinery for the
    pod's OWN namespace — but a term reaching ADDITIONAL namespaces (an
    explicit list or a namespaceSelector) also binds on matching pods
    THERE, which only the census-backed foreign mask can enforce. An
    anti term blocks their domains (sign -1). A CO term
    with extra namespaces is pinned by them too: matching pods in a
    foreign in-scope namespace restrict placement to their domains even
    when the own namespace is empty — admitting only own-namespace
    evidence then grants a first-replica bootstrap the scheduler does
    not give. It projects with sign +2 (bootstrap-eligible
    co) over the FULL scope: the pod itself is in scope, so an empty
    census keeps the scheduler's first-replica grace, unlike a true
    foreign co term. Self co terms never carry a namespaceSelector
    (_self_matching_terms filters those for CO), so the +2 scope is
    always an explicit name list. Hostname CO keys ALWAYS project (even
    with no extra namespaces): a matching pod anywhere in scope pins new
    replicas to its EXISTING node, which a scale-up's fresh nodes can
    never satisfy — the census handler marks the row honestly
    unschedulable, while an empty census keeps the first-replica grace
    (the bootstrap itself is capped to ONE promised replica by the anti
    expansion — replicas beyond the first must join the first's node,
    which a group-level pack cannot promise)."""
    extra = tuple(ns for ns in listed if ns != namespace)
    sel = _selector_form(t.label_selector)
    if sign < 0:
        if scope is not None:
            return [(sign, t.topology_key, sel, scope)]
        if extra:
            return [(sign, t.topology_key, sel, ("names", extra))]
        return []
    if extra or t.topology_key == HOSTNAME_TOPOLOGY_KEY:
        return [
            (2, t.topology_key, sel,
             ("names", tuple(sorted((namespace, *extra)))))
        ]
    return []


def _foreign_terms(anti_required, co_required, namespace, anti_terms, co_terms):
    """Canonical FOREIGN required (anti-)affinity terms — selectors that
    do NOT match the pod's own labels, i.e. constraints against OTHER
    workloads' pods. The solver enforces them against SCHEDULED state
    (the occupancy census): an anti term forbids the domains existing
    matching pods occupy; a co term requires one (no first-replica
    bootstrap for foreign selectors — if no matching pod exists, the
    pod is genuinely unschedulable, exactly the scheduler's rule).
    Interactions with the matching workload's PENDING pods (placed in
    the same solve) still need pairwise pod state and remain out of
    scope (docs/OPERATIONS.md). Returns sorted (sign, topologyKey,
    selectorForm, scope) tuples, sign -1 anti / +1 co. The scope is
    TAGGED: ("names", namesTuple) — the term's explicit list, or the
    pod's own namespace when empty — or ("selector", nsSelectorForm,
    explicitNames): namespaceSelector terms resolve to the matching
    namespaces at ENCODE time against the live Namespace set, unioned
    with any explicit list (the k8s combination rule). The tag makes
    the two shapes self-describing — discrimination must never lean on
    namespace-name syntax. Skipped (never constrained): hostname ANTI
    terms — a scale-up's fresh nodes host nothing, so they can never
    be blocked. Hostname CO terms are kept: a fresh node can never
    satisfy "must run beside an existing pod on one node", so the row
    is honestly unschedulable."""
    out = set()
    own_anti = set(map(id, anti_terms))
    own_co = set(map(id, co_terms))
    for sign, terms, own in (
        (-1, anti_required, own_anti),
        (1, co_required, own_co),
    ):
        for t in terms:
            if t.label_selector is None or not t.topology_key:
                continue
            if sign < 0 and t.topology_key == HOSTNAME_TOPOLOGY_KEY:
                continue
            listed = tuple(sorted(t.namespaces or ()))
            scope = _term_ns_scope(t, listed)
            if id(t) in own:
                out.update(
                    _own_term_entries(sign, t, scope, listed, namespace)
                )
                continue
            out.add(
                (
                    sign,
                    t.topology_key,
                    _selector_form(t.label_selector),
                    _resolved_scope(scope, listed, namespace),
                )
            )
    return tuple(sorted(out))


def soft_spread_shape(
    constraints: Optional[list],
    namespace: str = "",
    labels: Optional[Dict[str, str]] = None,
) -> tuple:
    """Canonical hashable form of a pod's SOFT topology spread
    (whenUnsatisfiable=ScheduleAnyway, non-hostname keys): (namespace,
    sorted (topologyKey, selectorForm) pairs). () = none. The kube-
    scheduler SCORES these — domains with fewer matching pods rank
    higher, nodes missing the key rank lowest — so the solver models
    them as a pod_group_score contribution (PodTopologySpread scoring
    plugin, default weight 2), never as a constraint. The selector is
    refined by matchLabelKeys exactly like the hard shape."""
    if not constraints:
        return ()
    pairs = {
        (c.topology_key, _spread_selector(c, labels))
        for c in constraints
        if c.when_unsatisfiable == "ScheduleAnyway"
        and c.topology_key
        and c.topology_key != HOSTNAME_TOPOLOGY_KEY
    }
    if not pairs:
        return ()
    entries = tuple(
        sorted(pairs, key=lambda p: (p[0], p[1] is not None, p[1] or ()))
    )
    return (namespace, entries)


def soft_pod_affinity_shape(
    affinity: Optional[Affinity],
    labels: Dict[str, str],
    namespace: str,
) -> tuple:
    """Canonical hashable form of a pod's PREFERRED inter-pod
    (anti-)affinity, restricted to the SELF-matching slice (the
    spread-replicas-apart / pack-replicas-together preferences):
    (namespace, sorted (sign, weight, topologyKey, selectorForm)
    entries), sign +1 for affinity, -1 for anti-affinity. () = none.
    The kube-scheduler SCORES these (InterPodAffinity plugin, default
    weight 1): each existing matching pod in a candidate's domain adds
    sign x weight — the solver models the same sum over the census.
    Hostname-keyed terms are dropped: a scale-up's new nodes are fresh
    hostnames, so their domains hold no existing pods either way."""
    if affinity is None:
        return ()
    entries = []
    for sign, block in (
        (1, affinity.pod_affinity),
        (-1, affinity.pod_anti_affinity),
    ):
        if block is None:
            continue
        for wt in block.preferred_during_scheduling_ignored_during_execution:
            term = _refine_term(wt.pod_affinity_term, labels)
            if (
                term.topology_key
                and term.topology_key != HOSTNAME_TOPOLOGY_KEY
                and _self_matching_terms([term], labels, namespace)
            ):
                entries.append(
                    (
                        sign,
                        max(1, min(100, int(wt.weight))),
                        term.topology_key,
                        _selector_form(term.label_selector),
                    )
                )
    if not entries:
        return ()
    return (namespace, tuple(sorted(entries)))


def _spread_selector(c, labels: Optional[Dict[str, str]]) -> Optional[tuple]:
    """A spread constraint's canonical selector form, refined by
    matchLabelKeys (k8s >= 1.27): the incoming pod's values for those
    keys are ANDed into the selector (the pod-template-hash
    per-revision-spread pattern). Keys the pod doesn't carry are
    ignored, and the API forbids matchLabelKeys without labelSelector."""
    sel = raw_selector_form(c.label_selector)
    if c.match_label_keys and sel is not None and labels:
        extra = tuple(
            (k, labels[k])
            for k in sorted(set(c.match_label_keys))
            if k in labels
        )
        if extra:
            sel = (tuple(sorted({*sel[0], *extra})), sel[1])
    return sel


def _domain_keys(terms: list) -> tuple:
    """Sorted distinct non-hostname topology keys of PodAffinityTerms."""
    return tuple(
        sorted(
            {
                t.topology_key
                for t in terms
                if t.topology_key != HOSTNAME_TOPOLOGY_KEY
            }
        )
    )


def _selector_form(sel: "LabelSelector") -> tuple:
    """Canonical hashable form of a label selector — the workload
    identity unit for pod_affinity_shape's ident."""
    return (
        tuple(sorted(sel.match_labels.items())),
        tuple(
            sorted(
                (e.key, e.operator, tuple(sorted(e.values)))
                for e in sel.match_expressions
            )
        ),
    )


def affinity_shape(affinity: Optional[Affinity]) -> tuple:
    """Canonical hashable form of a pod's REQUIRED node affinity: a tuple
    of terms, each a sorted tuple of (key, operator, sorted values). () =
    unconstrained. The dedup/encode layers key on this (two pods with the
    same shape are interchangeable to the solver)."""
    if affinity is None or affinity.node_affinity is None:
        return ()
    required = (
        affinity.node_affinity.required_during_scheduling_ignored_during_execution
    )
    if required is None or not required.node_selector_terms:
        return ()
    return tuple(
        tuple(
            sorted(
                (e.key, e.operator, tuple(sorted(e.values)))
                for e in term.match_expressions
            )
        )
        for term in required.node_selector_terms
    )


def preferred_shape(affinity: Optional[Affinity]) -> tuple:
    """Canonical hashable form of a pod's PREFERRED node affinity: sorted
    (weight, term) pairs where term is the same canonical tuple
    affinity_shape uses. () = no preferences. Terms with no expressions
    are dropped (they can never match, k8s empty-term semantics)."""
    if affinity is None or affinity.node_affinity is None:
        return ()
    preferred = (
        affinity.node_affinity.preferred_during_scheduling_ignored_during_execution
    )
    if not preferred:
        return ()
    shape = []
    for p in preferred:
        term = tuple(
            sorted(
                (e.key, e.operator, tuple(sorted(e.values)))
                for e in p.preference.match_expressions
            )
        )
        if term:
            shape.append((int(p.weight), term))
    return tuple(sorted(shape))


def preference_score(labels: Dict[str, str], shape: tuple) -> int:
    """Weight-sum of matching preference terms (the NodeAffinity scoring
    plugin's per-node sum, before normalization — ordering is all the
    solver needs)."""
    return sum(
        weight
        for weight, term in shape
        if all(
            _requirement_matches(labels, key, operator, values)
            for key, operator, values in term
        )
    )


def _numeric_requirement(labels, key, operator, values) -> bool:
    """Gt/Lt: integer comparison; missing key, empty values, or
    non-integer text never match (upstream nodeaffinity semantics)."""
    if key not in labels or not values:
        return False
    try:
        have, want = int(labels[key]), int(values[0])
    except ValueError:
        return False
    return have > want if operator == "Gt" else have < want


def _requirement_matches(labels: Dict[str, str], key, operator, values) -> bool:
    present = key in labels
    if operator == "In":
        return present and labels[key] in values
    if operator == "NotIn":
        # k8s semantics: a missing key satisfies NotIn
        return not present or labels[key] not in values
    if operator == "Exists":
        return present
    if operator == "DoesNotExist":
        return not present
    if operator in ("Gt", "Lt"):
        return _numeric_requirement(labels, key, operator, values)
    return False  # unknown operator: never matches (validation's job)


def matches_affinity_shape(labels: Dict[str, str], shape: tuple) -> bool:
    """Scheduler semantics over a label assignment: terms are ORed; the
    matchExpressions within a term are ANDed; an empty term matches
    nothing (upstream nodeaffinity helpers). () = no constraint."""
    if not shape:
        return True
    return any(
        term
        and all(
            _requirement_matches(labels, key, operator, values)
            for key, operator, values in term
        )
        for term in shape
    )


@dataclass(slots=True)
class Container:
    name: str = "main"
    requests: Dict[str, Quantity] = field(default_factory=dict)


@dataclass(slots=True)
class PodSpec:
    node_name: str = ""
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    # RuntimeClass pod overhead (core/v1 PodSpec.overhead): added on top of
    # the container maximum by the scheduler's fit check
    overhead: Dict[str, Quantity] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)
    # required node affinity (matchExpressions); ANDs with node_selector,
    # exactly as the kube-scheduler treats the two fields
    affinity: Optional[Affinity] = None
    # hard spread constraints partition the pending weight across topology
    # domains (producers/pendingcapacity balanced split); soft ones are
    # decoded but not constrained
    topology_spread_constraints: List[TopologySpreadConstraint] = field(
        default_factory=list
    )
    # PriorityClass value resolved by admission (core/v1 PodSpec.priority);
    # None = unresolved — effective_priority() then falls back to the
    # named class (well-known system classes) or the fleet default
    priority: Optional[int] = None
    priority_class_name: str = ""


@dataclass(slots=True)
class PodStatus:
    phase: str = "Pending"


@dataclass(slots=True)
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    KIND = "Pod"

    def requests(self) -> Dict[str, Quantity]:
        """Sum of container resource requests (container-level only, matching
        reference reservations.go:45-56 — no init containers or overhead).
        This is the RESERVED-CAPACITY accounting semantics; the scheduler's
        fit-check semantics is effective_requests()."""
        totals: Dict[str, Quantity] = {}
        for container in self.spec.containers:
            for name, quantity in container.requests.items():
                current = totals.get(name)
                # first occurrence aliases the (immutable) quantity
                # instead of Quantity(0).add(q): same value AND format
                # (a zero receiver adopts the operand's format anyway),
                # minus two Fraction constructions per pod resource —
                # this runs for every watch-delivered pod
                totals[name] = (
                    quantity if current is None else current.add(quantity)
                )
        return totals

    def effective_requests(self) -> Dict[str, Quantity]:
        """The Kubernetes scheduler's effective resource request, per
        resource: max(sum over containers, max over init containers) +
        pod overhead. Init containers run sequentially BEFORE the main
        containers, so the pod needs the larger of the two phases; the
        RuntimeClass overhead rides on top unconditionally (upstream
        k8s.io/kubernetes resource helpers' PodRequests semantics,
        restartable-sidecar cases excluded — init restartPolicy isn't
        modeled). Used by the pending-pods bin-pack (OUR signal — the
        reference stubs it, pendingcapacity/producer.go:29-31 — so
        fidelity here follows the real scheduler, not reservations.go).
        """
        totals = self.requests()
        for container in self.spec.init_containers:
            for name, quantity in container.requests.items():
                current = totals.get(name)
                if current is None or quantity.value > current.value:
                    totals[name] = quantity
        for name, quantity in self.spec.overhead.items():
            current = totals.get(name)
            totals[name] = quantity if current is None else current.add(quantity)
        return totals


@dataclass(slots=True)
class NodeSpec:
    unschedulable: bool = False
    taints: List[Taint] = field(default_factory=list)


@dataclass(slots=True)
class NodeCondition:
    type: str
    status: str


@dataclass(slots=True)
class NodeStatus:
    allocatable: Dict[str, Quantity] = field(default_factory=dict)
    conditions: List[NodeCondition] = field(default_factory=list)


@dataclass(slots=True)
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    KIND = "Node"


@dataclass(slots=True)
class Namespace:
    """core/v1 Namespace (metadata only): the labels resolve
    namespaceSelector terms in inter-pod (anti-)affinity — which
    namespaces' pods a foreign term censuses."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    KIND = "Namespace"


# Well-known PriorityClass values (the kube-scheduler's built-in system
# classes); any other named class without a resolved spec.priority falls
# back to the caller-supplied fleet default.
SYSTEM_PRIORITY_CLASSES = {
    "system-cluster-critical": 2_000_000_000,
    "system-node-critical": 2_000_001_000,
}


def effective_priority(pod: Pod, default: int = 0) -> int:
    """The pod's scheduling priority — the value the packing/eviction
    kernels compare (ops/binpack pod_priority, ops/preempt): a resolved
    spec.priority always wins, then the well-known system classes by
    name, then `default` (the --default-priority knob) for pods NAMING
    an unknown class. Class-less pods are plain priority 0 — the
    default must never lift the whole fleet into nonzero-priority
    encoding (that would disable the encoder's delta path and make
    every pending pod a preemption candidate)."""
    if pod.spec.priority is not None:
        return int(pod.spec.priority)
    name = pod.spec.priority_class_name
    if not name:
        return 0
    return SYSTEM_PRIORITY_CLASSES.get(name, default)


# Capacity-tier node labels every major provider stamps on
# spot/preemptible capacity; the packing kernels treat any match as
# tier 1 (preemptible — ops/binpack group_tier, ops/preempt node_tier).
PREEMPTIBLE_CAPACITY_LABELS = frozenset(
    {
        ("karpenter.sh/capacity-type", "spot"),
        ("cloud.google.com/gke-spot", "true"),
        ("cloud.google.com/gke-preemptible", "true"),
        ("eks.amazonaws.com/capacityType", "SPOT"),
        ("kubernetes.azure.com/scalesetpriority", "spot"),
    }
)


def capacity_tier_of(labels) -> int:
    """0 = on-demand, 1 = preemptible/spot, from a node/group label set
    (a dict or an iterable of (key, value) items — group profiles carry
    the latter)."""
    items = labels.items() if isinstance(labels, dict) else labels
    return (
        1
        if any(item in PREEMPTIBLE_CAPACITY_LABELS for item in items)
        else 0
    )


# Zone topology label (the well-known key kube schedulers spread on) and
# the reservation label the constraint plane fences reserved capacity
# with (same label-precedent family as karpenter.sh/capacity-type above).
ZONE_LABEL = "topology.kubernetes.io/zone"
RESERVATION_LABEL = "karpenter.sh/reservation"


def domain_of(labels, topology_key: str) -> str:
    """Topology-domain name for an ARBITRARY node label axis — the value
    of `topology_key` in a node/group label set (a dict or an iterable
    of (key, value) items — group profiles carry the latter); "" when
    the label is absent. The spread constraint plane balances over
    whatever axis the spec names (zone, hostname, rack, ...); zone is
    merely the default key."""
    items = labels.items() if isinstance(labels, dict) else labels
    for key, value in items:
        if key == topology_key:
            return value
    return ""


def zone_of(labels) -> str:
    """Zone name from a node/group label set; "" when the group carries
    no zone label (capacity_tier_of idiom)."""
    return domain_of(labels, ZONE_LABEL)


def reservation_of(labels) -> str:
    """Reservation name a node/group is fenced under ("" = unreserved),
    from the karpenter.sh/reservation label (dict or (key, value)
    items)."""
    items = labels.items() if isinstance(labels, dict) else labels
    for key, value in items:
        if key == RESERVATION_LABEL:
            return value
    return ""


def is_ready_and_schedulable(node: Node) -> bool:
    """reference: pkg/utils/node/predicates.go:18-25"""
    for condition in node.status.conditions:
        if condition.type == "Ready":
            return condition.status == "True" and not node.spec.unschedulable
    return False


def matches_selector(labels: Dict[str, str], selector: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())
