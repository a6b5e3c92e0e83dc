"""The port's full-size inputs as numpy arrays drawn from a seed
(counterparts of bench.py's input functions, without importing them).

- `build_inputs`: the pending-pods problem, drawn from
  np.random.default_rng(seed) in exactly the bench's order, one numpy
  array per BinPackInputs field (feed it to ops.binpack.inputs_from_numpy).
  The bench's main-path shape is build_inputs(100_000, 300, 64, 64, seed=0).
- `build_decision_inputs`: a DecisionInputs fleet, with the decision's
  edge rows and optionally forecast operands.
- `build_fused_tick_inputs`: a FusedTickInputs batch with every stage
  present, optionally pool groups.
- `build_reconcile_cluster` / `churn_reconcile`: bench.py::run_e2e's
  cluster (pending pods, one node and one pendingCapacity producer per
  group) in a Store with its PendingFeed, and its per-tick churn.
- `build_kube_world` / `seed_apiserver` / `churn_apiserver`
  (`churn_pods` + `apply_churn`) / `wait_mirrored`: the same cluster (plus node groups an autoscaler
  scales) served by fake kube-apiservers, its churn as watch events,
  and the wait until a KubeStore mirrors the server.
- `build_ha_fleet`: runtime.py's HorizontalAutoscaler world.
- `build_runtime_world`: the controller binary's world (the reconcile
  cluster and the HA fleet, read through queue MetricsProducers), as
  objects in a store, for a KarpenterRuntime to run.
- `build_disruption_world`: the `--consolidate --preempt` world
  (bench.py's fragmented consolidation cluster with node groups, a fake
  provider, pending critical pods, and the engines behind the
  ScalableNodeGroup controller); `build_preempt_inputs`: bench.py's
  eviction-planning fleet.
- `build_deployment_world` / `FakeClusterManager`: the shipped
  Deployment's world (config/manager/manager.yaml: the controller with
  --cloud-provider tpu beside a solver sidecar): the reconcile cluster
  plus GKE TPU pod-slice pools, one with no live node (scale from zero,
  docs/examples/pending-capacity-binpack.yaml), behind a fake GKE
  cluster manager.
- `write_reconcile_dir` / `write_disruption_dir`: the reconcile cluster
  and the disruption world written into a durable store, the data dirs
  `--simulate` and `--simulate --consolidate` read; `what_if_specs`: a
  `--what-if` list; `simlab_trails` (bench.py's cost theme) and
  `build_sim_rollout_inputs` (a SimLab fleet drawn in bulk).

The decision and tick builders return dicts of numpy arrays (nested for
the operand groups) that the operand dataclasses' `from_numpy` take.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


def build_inputs(
    pods: int, types: int, taints: int, labels: int, seed: int,
    affinity: float = 0.0, anti: float = 0.0,
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    # pod requests: cpu in cores, memory in GiB, 1 pod slot
    req = np.stack(
        [
            rng.uniform(0.05, 8.0, pods),
            rng.uniform(0.1, 32.0, pods),
            np.ones(pods),
        ],
        axis=1,
    ).astype(np.float32)
    # instance types: cpu 2..128 cores, proportional memory, 110 pod slots
    cpu = rng.choice([2, 4, 8, 16, 32, 64, 96, 128], types).astype(np.float32)
    mem = cpu * rng.choice([2.0, 4.0, 8.0], types).astype(np.float32)
    alloc = np.stack([cpu, mem, np.full(types, 110.0, np.float32)], axis=1)
    fields = {
        "pod_requests": req,
        "pod_valid": np.ones((pods,), bool),
        "pod_intolerant": rng.random((pods, taints)) < 0.05,
        "group_taints": rng.random((types, taints)) < 0.1,
        "pod_required": rng.random((pods, labels)) < 0.03,
        "group_labels": rng.random((types, labels)) < 0.8,
        "group_allocatable": alloc,
    }
    if affinity > 0:
        # a fraction `affinity` of pods carry required node affinity, drawn
        # from a handful of shared prototype forbidden rows
        prototypes = rng.random((4, types)) < 0.3
        which = rng.integers(0, prototypes.shape[0], pods)
        fields["pod_group_forbidden"] = prototypes[which] & (
            rng.random((pods, 1)) < affinity
        )
    if anti > 0:
        # a fraction `anti` of pods carry hostname self-anti-affinity
        fields["pod_exclusive"] = rng.random(pods) < anti
    return fields


def _decision_fields(r: np.random.RandomState, n: int, m: int, now: float):
    """A DecisionInputs fleet in bench.py::_fusedtick_inputs's draw order
    (also tests/test_fusedtick.py::mk_decision's): K = 2 policy slots."""
    k = 2
    return {
        "metric_value": r.uniform(0, 100, (n, m)).astype(np.float32),
        "target_value": r.uniform(1, 80, (n, m)).astype(np.float32),
        "target_type": r.randint(0, 3, (n, m)).astype(np.int32),
        "metric_valid": r.rand(n, m) > 0.2,
        "spec_replicas": r.randint(1, 20, n).astype(np.int32),
        "status_replicas": r.randint(1, 20, n).astype(np.int32),
        "min_replicas": r.randint(0, 3, n).astype(np.int32),
        "max_replicas": r.randint(20, 40, n).astype(np.int32),
        "up_window": r.randint(0, 60, n).astype(np.int32),
        "down_window": r.randint(0, 120, n).astype(np.int32),
        "up_policy": r.randint(0, 2, n).astype(np.int32),
        "down_policy": r.randint(0, 2, n).astype(np.int32),
        "last_scale_time": (now - r.uniform(0, 300, n)).astype(np.float32),
        "has_last_scale": r.rand(n) > 0.3,
        "now": np.float32(now),
        "up_ptype": r.randint(0, 3, (n, k)).astype(np.int32),
        "up_pvalue": r.randint(1, 10, (n, k)).astype(np.int32),
        "up_pperiod": r.randint(15, 120, (n, k)).astype(np.int32),
        "up_pvalid": r.rand(n, k) > 0.4,
        "down_ptype": r.randint(0, 3, (n, k)).astype(np.int32),
        "down_pvalue": r.randint(1, 10, (n, k)).astype(np.int32),
        "down_pperiod": r.randint(15, 120, (n, k)).astype(np.int32),
        "down_pvalid": r.rand(n, k) > 0.4,
    }


def with_edge_rows(fields: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A copy of decision fields whose rows 0-3 are the decision's edge
    cases: 0 a zero target; 1 a recommendation past 2**31 - 128 (it must
    saturate, not wrap); 2 a Percent policy at spec 0 (the one-replica
    floor of the budget); 3 min > max (the clamp gives max)."""
    f = {k: np.array(v, copy=True) for k, v in fields.items()}
    now = float(f["now"])
    # 0: zero target on every metric
    f["target_value"][0] = 0.0
    f["metric_valid"][0] = True
    # 1: a huge Value-type recommendation, unbounded, no hold
    f["metric_value"][1] = 1e30
    f["target_value"][1] = 1.0
    f["target_type"][1] = 0
    f["metric_valid"][1] = True
    f["max_replicas"][1] = np.iinfo(np.int32).max
    f["has_last_scale"][1] = False
    f["up_policy"][1] = 0
    # 2: Percent policies at spec 0, periods elapsed, a move up wanted
    f["spec_replicas"][2] = 0
    f["status_replicas"][2] = 3
    f["target_type"][2] = 1
    f["metric_valid"][2] = True
    f["has_last_scale"][2] = True
    f["last_scale_time"][2] = np.float32(now - 1000.0)
    f["up_window"][2] = 0
    f["up_ptype"][2] = 1
    f["up_pvalue"][2] = (50, 200)
    f["up_pvalid"][2] = True
    # 3: min > max
    f["min_replicas"][3] = 30
    f["max_replicas"][3] = 5
    return f


def build_decision_inputs(
    seed: int, n: int, m: int, forecast: bool = False, now: float = 1000.0
) -> Dict[str, np.ndarray]:
    """DecisionInputs fields for n autoscalers x m metrics, with the edge
    rows of `with_edge_rows` (n >= 4); with `forecast`, also predicted
    metric values for about 70% of the cells."""
    r = np.random.RandomState(seed)
    fields = with_edge_rows(_decision_fields(r, n, m, now))
    if forecast:
        fields["forecast_value"] = r.uniform(0, 150, (n, m)).astype(np.float32)
        fields["forecast_valid"] = r.rand(n, m) > 0.3
    return fields


def _poolgroup_fields(r: np.random.RandomState, n, m, groups, pools):
    """PoolGroupOperands fields: per-pool fields drawn like
    bench.py::build_poolgroup_inputs, members on distinct fleet rows, and
    (unlike the bench, which keeps every coupling slack) a live ratio band
    on about half the groups and a shared budget on about a third, so the
    repair selection runs."""
    from karpenter_tpu_torch.ops.poolgroup import RATIO_SLOTS

    g, p = groups, pools
    shape, shape_m = (g, p), (g, p, m)
    ratio_a = np.zeros((g, RATIO_SLOTS), np.int32)
    ratio_b = np.zeros((g, RATIO_SLOTS), np.int32)
    ratio_valid = np.zeros((g, RATIO_SLOTS), bool)
    # slot 0: pool 1 : pool 0 within [2:1, 4:1]; slot 1 (P >= 3): pool 2 :
    # pool 0 at least 1:1
    ratio_a[:, 0], ratio_b[:, 0] = 1, 0
    ratio_valid[:, 0] = r.rand(g) < 0.5
    if p >= 3:
        ratio_a[:, 1], ratio_b[:, 1] = 2, 0
        ratio_valid[:, 1] = r.rand(g) < 0.3
    min_num = np.zeros((g, RATIO_SLOTS), np.int32)
    max_num = np.zeros((g, RATIO_SLOTS), np.int32)
    max_den = np.zeros((g, RATIO_SLOTS), np.int32)
    min_num[:, 0], max_num[:, 0], max_den[:, 0] = 2, 4, 1
    min_num[:, 1] = 1
    return {
        "member_row": r.choice(n, g * p, replace=False)
        .reshape(shape).astype(np.int32),
        "pg_min": r.randint(0, 3, shape).astype(np.int32),
        "pg_max": r.randint(20, 40, shape).astype(np.int32),
        "unit_cost": r.choice([0.07, 0.19, 1.0, 4.8], shape).astype(np.float32),
        "slo_weight": r.choice([0.0, 5.0, 50.0, 500.0], shape).astype(np.float32),
        "max_hourly_cost": r.choice([0.0, 25.0, 250.0], shape).astype(np.float32),
        "tier_penalty": r.choice([0.0, 0.1, 2.0], shape).astype(np.float32),
        "pool_valid": r.rand(*shape) > 0.05,
        "slo_target": r.uniform(0.5, 10, shape_m).astype(np.float32),
        "observed": r.uniform(0, 1000, shape_m).astype(np.float32),
        "demand_base_valid": r.rand(*shape_m) > 0.1,
        "prior_point": r.uniform(0, 1000, shape_m).astype(np.float32),
        "prior_sigma2": r.choice([0.0, 25.0, 2500.0], shape_m).astype(np.float32),
        "prior_valid": r.rand(*shape_m) > 0.5,
        "ratio_a": ratio_a,
        "ratio_b": ratio_b,
        "ratio_min_num": min_num,
        "ratio_min_den": np.ones((g, RATIO_SLOTS), np.int32),
        "ratio_max_num": max_num,
        "ratio_max_den": max_den,
        "ratio_valid": ratio_valid,
        "group_budget": np.where(
            r.rand(g) < 0.35, r.uniform(50, 400, g), 0.0
        ).astype(np.float32),
        "group_valid": r.rand(g) > 0.05,
    }


def build_fused_tick_inputs(
    seed: int, n: int, m: int, s: int, t: int, groups: int = 0, pools: int = 4
) -> dict:
    """FusedTickInputs fields with every stage present: a fleet of n
    autoscalers x m metrics, s forecast series of t samples, the cost
    group, and `groups` pool groups of `pools` pools (none when 0).

    Drawn like bench.py::_fusedtick_inputs (np.random.RandomState(seed),
    the same calls in the same order), except that the live series take
    DISTINCT (row, col) cells, drawn without replacement, as production's
    forecast engine emits one series per (autoscaler, metric): the bench
    draws rows and columns independently, so two series may share a cell
    (s <= n * m is required here)."""
    r = np.random.RandomState(seed)
    now = 1000.0
    decision = _decision_fields(r, n, m, now)
    forecast = {
        "values": r.uniform(0, 100, (s, t)).astype(np.float32),
        "valid": r.rand(s, t) > 0.2,
        "times": np.cumsum(r.uniform(10, 20, (s, t)), 1).astype(np.float32),
        "weights": np.ones((s, t), np.float32),
        "horizon": np.full(s, 60.0, np.float32),
        "step_s": np.full(s, 15.0, np.float32),
        "model": r.randint(0, 2, s).astype(np.int32),
        "season": np.full(s, 4, np.int32),
        "alpha": np.full(s, 0.5, np.float32),
        "beta": np.full(s, 0.1, np.float32),
        "gamma": np.full(s, 0.1, np.float32),
    }
    cells = r.choice(n * m, s, replace=False)
    fields = {
        "decision": decision,
        "forecast": forecast,
        "series_row": (cells // m).astype(np.int32),
        "series_col": (cells % m).astype(np.int32),
        "series_need": np.full(s, 2, np.int32),
        "series_blend": r.rand(s) > 0.3,
        "ha_min": r.randint(0, 3, n).astype(np.int32),
        "ha_max": r.randint(20, 40, n).astype(np.int32),
        "unit_cost": r.uniform(0.1, 3.0, n).astype(np.float32),
        "slo_weight": r.uniform(0, 2, n).astype(np.float32),
        "max_hourly_cost": r.uniform(5, 50, n).astype(np.float32),
        "slo_valid": r.rand(n) > 0.4,
        "slo_target": r.uniform(1, 80, (n, m)).astype(np.float32),
        "observed": r.uniform(0, 100, (n, m)).astype(np.float32),
        "demand_base_valid": r.rand(n, m) > 0.3,
        "prior_point": r.uniform(0, 100, (n, m)).astype(np.float32),
        "prior_sigma2": r.uniform(0, 10, (n, m)).astype(np.float32),
        "prior_valid": r.rand(n, m) > 0.5,
        "poolgroup": None,
    }
    if groups:
        fields["poolgroup"] = _poolgroup_fields(r, n, m, groups, pools)
    return fields


# -- the reconcile tick's cluster (bench.py::run_e2e) -------------------------

# What the cluster draw needs, by module under the package root. The draw
# takes these classes as an argument (`reconcile_api` gives this package's),
# so the same routine fills a store from any package with this layout.
RECONCILE_API = {
    "api.core": (
        "Affinity", "Container", "LabelSelector", "Node", "NodeAffinity",
        "NodeCondition", "NodeSelector", "NodeSelectorRequirement",
        "NodeSelectorTerm", "NodeStatus", "ObjectMeta", "Pod",
        "PodAffinityTerm", "PodAntiAffinity", "PodSpec",
        "PreferredSchedulingTerm", "TopologySpreadConstraint",
    ),
    "api.metricsproducer": (
        "MetricsProducer", "MetricsProducerSpec", "PendingCapacitySpec",
    ),
    "metrics.producers.pendingcapacity": (
        "group_profile", "register_gauges", "solve_pending",
    ),
    "metrics.registry": ("GaugeRegistry",),
    "store": ("Store",),
    "store.columnar": ("PendingFeed", "PendingPodCache"),
    "utils.quantity": ("Quantity",),
}


class ReconcileAPI:
    """The classes and functions of RECONCILE_API, as attributes."""

    def __init__(self, **names):
        self.__dict__.update(names)


def _namespace(spec: Dict[str, tuple], modules: Dict[str, object]
               ) -> ReconcileAPI:
    """The names of `spec` ({module key: names}) taken from `modules`,
    which maps each of its keys to a module object."""
    return ReconcileAPI(
        **{
            attr: getattr(modules[module], attr)
            for module, attrs in spec.items()
            for attr in attrs
        }
    )


def api_namespace(modules: Dict[str, object]) -> ReconcileAPI:
    """The names of RECONCILE_API taken from `modules`, which maps each
    of its keys to a module object."""
    return _namespace(RECONCILE_API, modules)


def reconcile_api() -> ReconcileAPI:
    """RECONCILE_API from this package."""
    from karpenter_tpu_torch import store
    from karpenter_tpu_torch.api import core, metricsproducer
    from karpenter_tpu_torch.metrics import registry
    from karpenter_tpu_torch.metrics.producers import pendingcapacity
    from karpenter_tpu_torch.store import columnar
    from karpenter_tpu_torch.utils import quantity

    return api_namespace({
        "api.core": core,
        "api.metricsproducer": metricsproducer,
        "metrics.producers.pendingcapacity": pendingcapacity,
        "metrics.registry": registry,
        "store": store,
        "store.columnar": columnar,
        "utils.quantity": quantity,
    })


def _affinity_shapes(api) -> list:
    """bench.py::_e2e_affinity_shapes: require ssd, forbid hdd, prefer ssd
    (weight 80)."""

    def term(operator, values):
        return api.NodeSelectorTerm(
            match_expressions=[
                api.NodeSelectorRequirement(
                    key="disk", operator=operator, values=values
                )
            ]
        )

    def required(operator, values):
        return api.Affinity(
            node_affinity=api.NodeAffinity(
                required_during_scheduling_ignored_during_execution=(
                    api.NodeSelector(node_selector_terms=[term(operator, values)])
                )
            )
        )

    prefer_ssd = api.Affinity(
        node_affinity=api.NodeAffinity(
            preferred_during_scheduling_ignored_during_execution=[
                api.PreferredSchedulingTerm(
                    weight=80, preference=term("In", ["ssd"])
                )
            ]
        )
    )
    return [required("In", ["ssd"]), required("NotIn", ["hdd"]), prefer_ssd]


def _anti_affinity(api, app: str):
    """bench.py::_e2e_anti_affinity: required hostname self-anti-affinity
    (one replica per node)."""
    return api.Affinity(
        pod_anti_affinity=api.PodAntiAffinity(
            required_during_scheduling_ignored_during_execution=[
                api.PodAffinityTerm(
                    label_selector=api.LabelSelector(match_labels={"app": app}),
                    topology_key="kubernetes.io/hostname",
                )
            ]
        )
    )


@dataclass
class ReconcileCluster:
    """A populated store with its feed, producers and gauge registry, and
    the draw state the churn continues from."""

    api: ReconcileAPI
    store: object
    feed: object
    producers: List
    registry: object
    pods: int
    types: int
    bound_count: int
    make_pod: Callable
    make_bound: Callable
    next_id: int = 0
    next_bound: int = 0
    # node group -> replicas, for the fake provider of a kube world
    node_replicas: Dict[str, int] = field(default_factory=dict)

    def tick(self, solver=None):
        """One reconcile tick: solve_pending over every producer through
        the feed."""
        return self.api.solve_pending(
            self.store, self.producers, self.registry, solver=solver,
            feed=self.feed,
        )


def build_reconcile_cluster(
    pods: int, types: int, seed: int, affinity: float = 0.0,
    anti: float = 0.0, spread: float = 0.0,
    api: Optional[ReconcileAPI] = None,
) -> ReconcileCluster:
    """bench.py::run_e2e's cluster, draw for draw from
    np.random.default_rng(seed): `pods` pending pods (cpu from 100m..4,
    memory from 128Mi..4Gi; fractions `affinity`, `anti` and `spread`
    carry required/preferred node affinity on the disk label, hostname
    self-anti-affinity, and a zone topology spread), `types` groups of
    one Ready node each (8-96 cores, 4 GiB per core, disk alternating
    hdd/ssd, 16 zones under `spread`), a slab of bound pods under
    `spread`, and one pendingCapacity MetricsProducer per group selecting
    its node. `api` (reconcile_api) names the classes; the port's by
    default."""
    api = api if api is not None else reconcile_api()
    rng = np.random.default_rng(seed)
    store = api.Store()
    feed = api.PendingFeed(store, api.group_profile)
    cluster = _draw_reconcile(api, store, rng, pods, types, affinity, anti,
                              spread)
    cluster.feed = feed
    cluster.registry = api.GaugeRegistry()
    api.register_gauges(cluster.registry)
    return cluster


def _draw_reconcile(api, store, rng, pods: int, types: int, affinity: float,
                    anti: float, spread: float) -> ReconcileCluster:
    """build_reconcile_cluster's draw, written into `store` (feed and
    registry left None)."""
    cpu_choices = [
        api.Quantity.parse(q) for q in ("100m", "250m", "500m", "1", "2", "4")
    ]
    mem_choices = [api.Quantity.parse(q) for q in ("128Mi", "512Mi", "1Gi", "4Gi")]
    affinity_shapes = _affinity_shapes(api) if affinity else []

    def make_pod(name):
        # independent draws, in run_e2e's order: a pod may carry both node
        # affinity and pod anti-affinity
        pod_affinity = None
        labels = {}
        constraints = []
        if affinity_shapes and rng.random() < affinity:
            pod_affinity = affinity_shapes[
                int(rng.integers(0, len(affinity_shapes)))
            ]
        if anti and rng.random() < anti:
            app = f"svc{int(rng.integers(0, 8))}"
            labels = {"app": app}
            pod_affinity = api.Affinity(
                node_affinity=(
                    pod_affinity.node_affinity if pod_affinity else None
                ),
                pod_anti_affinity=_anti_affinity(api, app).pod_anti_affinity,
            )
        if spread and rng.random() < spread:
            app = f"web{int(rng.integers(0, 8))}"
            labels = {**labels, "spread-app": app}
            constraints = [
                api.TopologySpreadConstraint(
                    max_skew=1,
                    topology_key="topology.kubernetes.io/zone",
                    when_unsatisfiable="DoNotSchedule",
                    label_selector={"matchLabels": {"spread-app": app}},
                )
            ]
        return api.Pod(
            metadata=api.ObjectMeta(name=name, labels=labels),
            spec=api.PodSpec(
                containers=[
                    api.Container(
                        requests={
                            "cpu": rng.choice(cpu_choices),
                            "memory": rng.choice(mem_choices),
                        }
                    )
                ],
                affinity=pod_affinity,
                topology_spread_constraints=constraints,
            ),
        )

    def make_bound(name):
        # a bound pod with a per-pod-unique label (the StatefulSet
        # pod-name pattern) feeding the occupancy census
        app = f"web{int(rng.integers(0, 8))}"
        return api.Pod(
            metadata=api.ObjectMeta(
                name=name,
                labels={
                    "spread-app": app,
                    "statefulset.kubernetes.io/pod-name": name,
                },
            ),
            spec=api.PodSpec(
                node_name=f"n{int(rng.integers(0, types))}",
                containers=[api.Container(requests={"cpu": cpu_choices[0]})],
            ),
        )

    for i in range(pods):
        store.create(make_pod(f"p{i}"))
    for g in range(types):
        cores = int(rng.choice([8, 16, 32, 64, 96]))
        node_labels = {"group": f"g{g}", "disk": "ssd" if g % 2 else "hdd"}
        if spread:
            node_labels["topology.kubernetes.io/zone"] = f"z{g % 16}"
        store.create(
            api.Node(
                metadata=api.ObjectMeta(name=f"n{g}", labels=node_labels),
                status=api.NodeStatus(
                    allocatable={
                        "cpu": api.Quantity.parse(str(cores)),
                        "memory": api.Quantity.parse(f"{cores * 4}Gi"),
                    },
                    conditions=[
                        api.NodeCondition(type="Ready", status="True")
                    ],
                ),
            )
        )
    bound_count = min(max(pods // 10, 1), 10000) if spread else 0
    for i in range(bound_count):
        store.create(make_bound(f"b{i}"))
    producers = [
        store.create(
            api.MetricsProducer(
                metadata=api.ObjectMeta(name=f"mp{g}"),
                spec=api.MetricsProducerSpec(
                    pending_capacity=api.PendingCapacitySpec(
                        node_selector={"group": f"g{g}"}
                    )
                ),
            )
        )
        for g in range(types)
    ]
    return ReconcileCluster(
        api=api, store=store, feed=None, producers=producers,
        registry=None, pods=pods, types=types, bound_count=bound_count,
        make_pod=make_pod, make_bound=make_bound, next_id=pods,
        next_bound=bound_count,
    )


def churn_reconcile(
    cluster: ReconcileCluster, churn: Optional[int] = None
) -> Callable[[], None]:
    """One churned tick of run_e2e: draws `churn` replacement pods
    (default max(1, pods // 100)) and, under `spread`, a tenth as many
    bound pods, then returns the mutation that applies them: it deletes
    the oldest pods and creates the fresh ones through the store, whose
    watch events feed the incremental caches. Drawing is the load
    generator's cost, so it happens here, outside the mutation."""
    c = cluster
    pairs = churn_pods(c, churn)

    def apply() -> None:
        for victim, pod in pairs:
            c.store.delete("Pod", "default", victim)
            c.store.create(pod)

    return apply


def churn_pods(c: ReconcileCluster, churn: Optional[int] = None
               ) -> List[tuple]:
    """churn_reconcile's draw, continuing the cluster's draw state:
    (victim name, fresh pod) pairs, the pending ones first, then the
    bound ones."""
    churn = churn if churn is not None else max(1, c.pods // 100)
    bound_churn = (
        min(c.bound_count, max(1, churn // 10))
        if (c.bound_count and churn)
        else 0
    )
    fresh = [c.make_pod(f"p{c.next_id + j}") for j in range(churn)]
    victims = [f"p{c.next_id - c.pods + j}" for j in range(churn)]
    c.next_id += churn
    fresh_bound = [
        c.make_bound(f"b{c.next_bound + j}") for j in range(bound_churn)
    ]
    bound_victims = [
        f"b{c.next_bound - c.bound_count + j}" for j in range(bound_churn)
    ]
    c.next_bound += bound_churn
    return list(zip(victims, fresh)) + list(zip(bound_victims, fresh_bound))


# -- the HorizontalAutoscaler reconcile tick's world (runtime.py's wiring) ----

# What the HA world needs, by module under the package root; `api=` takes
# these names from either package (ha_api gives this package's).
HA_API = {
    "api.core": ("ObjectMeta",),
    "api.horizontalautoscaler": (
        "Behavior", "CrossVersionObjectReference", "ForecastSpec",
        "HorizontalAutoscaler", "HorizontalAutoscalerSpec", "Metric",
        "MetricTarget", "PrometheusMetricSource", "SLOSpec",
        "ScalingPolicy", "ScalingRules",
    ),
    "api.poolgroup": (
        "PoolGroup", "PoolGroupSpec", "PoolMember", "RatioConstraint",
    ),
    "api.scalablenodegroup": ("ScalableNodeGroup", "ScalableNodeGroupSpec"),
    "autoscaler": ("BatchAutoscaler",),
    "controllers.horizontalautoscaler": ("HorizontalAutoscalerController",),
    "cost": ("CostEngine", "CostModel", "WarmPoolEngine"),
    "forecast": ("FleetForecaster",),
    "metrics.clients": ("MetricsClientFactory",),
    "metrics.registry": ("GaugeRegistry",),
    "poolgroups": ("PoolGroupEngine",),
    "store": ("Store",),
}


def ha_api_namespace(modules: Dict[str, object]) -> ReconcileAPI:
    """The names of HA_API taken from `modules`, which maps each of its
    keys to a module object."""
    return _namespace(HA_API, modules)


def ha_api() -> ReconcileAPI:
    """HA_API from this package."""
    from karpenter_tpu_torch import autoscaler, cost, forecast, poolgroups, store
    from karpenter_tpu_torch.api import (
        core,
        horizontalautoscaler,
        poolgroup,
        scalablenodegroup,
    )
    from karpenter_tpu_torch.controllers import (
        horizontalautoscaler as ha_controller,
    )
    from karpenter_tpu_torch.metrics import clients, registry

    return ha_api_namespace({
        "api.core": core,
        "api.horizontalautoscaler": horizontalautoscaler,
        "api.poolgroup": poolgroup,
        "api.scalablenodegroup": scalablenodegroup,
        "autoscaler": autoscaler,
        "controllers.horizontalautoscaler": ha_controller,
        "cost": cost,
        "forecast": forecast,
        "metrics.clients": clients,
        "metrics.registry": registry,
        "poolgroups": poolgroups,
        "store": store,
    })


# seconds between ticks (the HA controller's interval)
TICK_S = 10.0
# catalog instance types the world's node groups are priced at
# (cost/model.py DEFAULT_CATALOG keys)
_INSTANCE_TYPES = ("m5.large", "m5.xlarge", "m5.2xlarge", "n2-standard-8",
                   "g5.xlarge", "ct5lp-hightpu-4t")


@dataclass
class HAFleet:
    """A store of HorizontalAutoscalers and their ScalableNodeGroups, the
    queue gauges they read, and the engines wired as runtime.py wires
    them around one BatchAutoscaler (fields as built by build_ha_fleet).

    `tick()` is one controller interval: `step_world()` moves the clock
    and the queues and applies last tick's scale writes to the node
    groups' status (the cloud provider's actuation), then `reconcile()`
    hands the fleet to the controller (BatchAutoscaler.reconcile_batch)
    and writes every HA's status back to the store."""

    api: ReconcileAPI
    store: object
    registry: object
    service: object
    clock: dict
    autoscaler: object
    controller: object
    forecaster: object
    cost_engine: object
    pool_engine: object
    warmpool: object
    has: List
    queues: np.ndarray  # f32[n_has, metrics] current queue values
    base: np.ndarray  # f32[n_has, metrics] level of each queue's walk
    rng: object
    gauge_of: List  # per HA: (gauge vector, [series name per metric])
    actuate: set
    ticks: int = 0

    def step_world(self) -> None:
        """The world between two reconciles: the clock advances one
        interval, each queue takes a seeded random-walk step around its
        level (with a slow daily-ish swell), and node groups whose
        spec.replicas moved report it as status.replicas."""
        self.clock["now"] += TICK_S
        self.ticks += 1
        n, m = self.queues.shape
        swell = 1.0 + 0.3 * np.sin(self.ticks / 9.0 + np.arange(n) % 7)
        step = self.rng.normal(0.0, 0.08, (n, m)) * self.base
        self.queues = np.maximum(
            0.0, 0.7 * self.queues + 0.3 * self.base * swell[:, None] + step
        ).astype(np.float32)
        for i, (vec, names) in enumerate(self.gauge_of):
            ns = self.has[i].metadata.namespace
            for j, name in enumerate(names):
                vec.set(name, ns, float(self.queues[i, j]))
        pending = sorted(self.actuate)
        self.actuate.clear()
        for ns, name in pending:
            sng = self.store.get("ScalableNodeGroup", ns, name)
            if sng.status.replicas != sng.spec.replicas:
                sng.status.replicas = sng.spec.replicas
                self.store.patch_status(sng)

    def reconcile(self) -> dict:
        """One HA reconcile over the fleet: {(namespace, name): error or
        None}, every HA's status then written to the store. A failure of
        the whole batch is every row's error, as the controller manager
        records it (karpenter_tpu/controllers/engine.py `_dispatch`)."""
        try:
            errors = self.controller.reconcile_batch(self.has)
        except Exception as error:  # noqa: BLE001 — batch-wide failure
            errors = {
                (ha.metadata.namespace, ha.metadata.name): error
                for ha in self.has
            }
        for ha in self.has:
            self.store.patch_status(ha)
        return errors

    def tick(self) -> dict:
        self.step_world()
        return self.reconcile()

    def trail(self) -> List[int]:
        """Every node group's spec.replicas, in HA order."""
        return [
            self.store.get(
                "ScalableNodeGroup", ha.metadata.namespace,
                ha.spec.scale_target_ref.name,
            ).spec.replicas
            for ha in self.has
        ]

    def statuses(self) -> List[tuple]:
        """Every HA's status as plain values, in HA order."""
        out = []
        for ha in self.has:
            st = ha.status
            out.append((
                st.desired_replicas, st.current_replicas, st.last_scale_time,
                tuple(
                    (c.type, c.status, c.reason, c.message)
                    for c in st.conditions
                ),
                tuple(
                    (
                        ms.prometheus.query,
                        ms.prometheus.current.value,
                        ms.prometheus.current.average_value,
                        ms.prometheus.current.average_utilization,
                    )
                    for ms in st.current_metrics
                ),
            ))
        return out


def _draw_ha(api, store, rng, n_has: int, metrics: int,
             forecast_share: float, slo_share: float, groups: int,
             pools: int, query_of: Callable):
    """build_ha_fleet's draw of the fleet's objects, written into `store`:
    the node groups, the HorizontalAutoscalers (metric j of HA i in
    namespace ns reads the series `ha-<i>-m<j>` through the query
    `query_of(i, ns, series)` gives) and the PoolGroups. Returns (the HAs
    as stored, the queue levels f32[n_has, metrics], which HAs forecast,
    each HA's series names)."""
    forecasting = rng.random(n_has) < forecast_share
    with_slo = rng.random(n_has) < slo_share
    replicas = rng.integers(1, 21, n_has)
    spot = rng.random(n_has) < 0.2
    itype = rng.integers(0, len(_INSTANCE_TYPES), n_has)
    kinds = rng.integers(0, 3, (n_has, metrics))  # AverageValue/Value/Util
    # queue levels; a Utilization metric reads a fraction of capacity
    base = rng.uniform(10.0, 200.0, (n_has, metrics))
    base = np.where(kinds == 2, base / 250.0, base).astype(np.float32)
    up_window = rng.choice([0, 0, 30], n_has)
    down_window = rng.choice([0, 60, 300], n_has)
    select = rng.integers(0, 3, (n_has, 2))
    policy_mix = rng.integers(0, 4, (n_has, 2))
    models = rng.integers(0, 2, n_has)
    seasonal = rng.random(n_has) < 0.5
    slo_target = rng.uniform(2.0, 12.0, n_has)
    slo_weight = rng.choice([5.0, 25.0, 100.0], n_has)
    slo_budget = rng.choice([0.0, 0.0, 50.0], n_has)
    select_names = (None, "Max", "Min")

    def rules(i, direction):
        window = int(up_window[i] if direction == 0 else down_window[i])
        mix = int(policy_mix[i, direction])
        policies = None
        if mix == 1:
            policies = [api.ScalingPolicy(type="Count", value=4, period_seconds=60)]
        elif mix == 2:
            policies = [api.ScalingPolicy(type="Percent", value=50, period_seconds=60)]
        elif mix == 3:
            policies = [
                api.ScalingPolicy(type="Count", value=2, period_seconds=30),
                api.ScalingPolicy(type="Percent", value=100, period_seconds=60),
            ]
        return api.ScalingRules(
            stabilization_window_seconds=window,
            select_policy=select_names[int(select[i, direction])],
            policies=policies,
        )

    has = []
    names_of = []
    for i in range(n_has):
        ns = f"tenant-{i // 4:04d}"
        name = f"ha-{i:05d}"
        target = f"sng-{i:05d}"
        store.create(api.ScalableNodeGroup(
            metadata=api.ObjectMeta(
                name=target, namespace=ns,
                annotations={
                    "cost.karpenter.sh/instance-type":
                        _INSTANCE_TYPES[int(itype[i])],
                },
            ),
            spec=api.ScalableNodeGroupSpec(
                replicas=int(replicas[i]), type="FakeNodeGroup", id=target,
                preemptible=bool(spot[i]),
            ),
        ))
        sng = store.get("ScalableNodeGroup", ns, target)
        sng.status.replicas = int(replicas[i])
        store.patch_status(sng)
        n_metrics = 1 if forecasting[i] else metrics
        names, specs = [], []
        for j in range(n_metrics):
            series = f"{name}-m{j}"
            names.append(series)
            kind = int(kinds[i, j])
            if kind == 0:
                mt = api.MetricTarget(type="AverageValue", value=float(
                    np.float32(base[i, j] / 6.0)))
            elif kind == 1:
                mt = api.MetricTarget(type="Value", value=float(
                    np.float32(base[i, j] * 2.0)))
            else:
                mt = api.MetricTarget(
                    type="Utilization", average_utilization=70
                )
            specs.append(api.Metric(prometheus=api.PrometheusMetricSource(
                query=query_of(i, ns, series),
                target=mt,
            )))
        names_of.append(names)
        behavior = api.Behavior(scale_up=rules(i, 0), scale_down=rules(i, 1))
        if forecasting[i]:
            behavior.forecast = api.ForecastSpec(
                horizon_seconds=60.0,
                model="holt-winters" if models[i] else "linear",
                season_seconds=120.0 if seasonal[i] else 0.0,
                min_samples=6,
            )
        if with_slo[i]:
            behavior.slo = api.SLOSpec(
                target_value=float(np.float32(slo_target[i])),
                violation_cost_weight=float(slo_weight[i]),
                max_hourly_cost=float(slo_budget[i]),
            )
        has.append(api.HorizontalAutoscaler(
            metadata=api.ObjectMeta(name=name, namespace=ns),
            spec=api.HorizontalAutoscalerSpec(
                scale_target_ref=api.CrossVersionObjectReference(
                    kind="ScalableNodeGroup", name=target
                ),
                min_replicas=1,
                max_replicas=int(100 if i % 3 else 40),
                metrics=specs,
                behavior=behavior,
            ),
        ))
    for ha in has:
        store.create(ha)
    has = store.list("HorizontalAutoscaler")

    # pool groups: one tenant's HAs each, spread over the fleet
    n_tenants = (n_has + 3) // 4
    for g, t in enumerate(
        sorted(rng.choice(n_tenants, min(groups, n_tenants), replace=False))
    ):
        members = [h for h in has if h.metadata.namespace == f"tenant-{t:04d}"]
        members = members[:pools]
        if len(members) < 2:
            continue
        ratios = []
        if rng.random() < 0.5:
            ratios.append(api.RatioConstraint(
                numerator=members[1].metadata.name,
                denominator=members[0].metadata.name,
                min_numerator=1, min_denominator=1,
                max_numerator=4, max_denominator=1,
            ))
        store.create(api.PoolGroup(
            metadata=api.ObjectMeta(
                name=f"pg-{g:03d}", namespace=f"tenant-{t:04d}"
            ),
            spec=api.PoolGroupSpec(
                pools=[api.PoolMember(name=h.metadata.name) for h in members],
                ratios=ratios,
                max_hourly_cost=float(
                    rng.choice([0.0, 400.0]) if rng.random() < 0.35 else 0.0
                ),
            ),
        ))

    return has, base, forecasting, names_of


def build_ha_fleet(
    n_has: int, metrics: int, seed: int, *, service,
    forecast_share: float = 0.5, slo_share: float = 0.6, groups: int = 0,
    pools: int = 4, fused: bool = False, history: int = 64,
    queue_vectors: int = 1, api: Optional[ReconcileAPI] = None,
) -> HAFleet:
    """The world runtime.py:318-410 wires for the HorizontalAutoscaler
    tick, drawn from np.random.default_rng(seed), with `service` (a
    SolverService of either package) behind every device seam:

    - `n_has` HorizontalAutoscalers in tenants of four (namespace
      tenant-NNNN), each scaling its own ScalableNodeGroup (1-20
      replicas, priced at a catalog instance type, a fifth of them spot);
    - `metrics` queue metrics per HA, read by PromQL instant selector
      from a GaugeRegistry through MetricsClientFactory(registry=...),
      every series in the one `karpenter_queue_length` vector the
      reference's runtime test and bench register; `queue_vectors` > 1
      spreads the HAs in blocks over that many vectors
      (`karpenter_queue_length_000`, ...), a layout no source has: the
      in-process client scans the matched vector's series on every
      query, so one vector costs a query time in the fleet's size;
      about `forecast_share` of the HAs forecast instead (one metric,
      with spec.behavior.forecast, `history` samples already observed);
      about `slo_share` carry spec.behavior.slo; scale-up and scale-down
      rules with Count/Percent policies and stabilization windows mixed;
    - `groups` PoolGroups of `pools` members (one tenant's HAs each),
      with a ratio band on about half and a shared budget on a third;
    - FleetForecaster(forecast_fn=service.forecast), CostEngine(cost_fn=
      service.cost), PoolGroupEngine(poolgroup_fn=service.poolgroup)
      when `groups`, WarmPoolEngine, and BatchAutoscaler(decider=
      service.decide, fused_tick_fn=service.fused_tick if `fused`)
      behind a HorizontalAutoscalerController;
    - an injected clock (`fleet.clock["now"]`, seconds).

    `api` (ha_api) names the classes; the port's by default, so a test
    builds the same world from the reference's modules."""
    api = api if api is not None else ha_api()
    rng = np.random.default_rng(seed)
    clock = {"now": 1_000_000.0}
    now = lambda: clock["now"]  # noqa: E731
    store = api.Store()
    registry = api.GaugeRegistry()
    forecaster = api.FleetForecaster(
        forecast_fn=service.forecast, registry=registry, clock=now,
        capacity=history,
    )
    # every observed (HA, metric) series and every query's warm-pool
    # series live in the history store: size it to the fleet (its
    # default of 4,096 series would evict and reseed series every tick)
    forecaster.history.max_series = max(
        forecaster.history.max_series, 4 * n_has * metrics
    )
    clients = api.MetricsClientFactory(
        registry=registry, observer=forecaster.observe_query
    )
    model = api.CostModel()
    cost_engine = api.CostEngine(
        store=store, cost_fn=service.cost, model=model,
        forecaster=forecaster, registry=registry,
    )
    pool_engine = None
    if groups:
        pool_engine = api.PoolGroupEngine(
            store=store, poolgroup_fn=service.poolgroup, model=model,
            forecaster=forecaster, registry=registry,
        )
    warmpool = api.WarmPoolEngine(
        headroom_source=cost_engine.headroom, registry=registry
    )
    autoscaler = api.BatchAutoscaler(
        clients, store, clock=now, decider=service.decide,
        forecaster=forecaster, cost_engine=cost_engine,
        pool_engine=pool_engine,
        fused_tick_fn=service.fused_tick if fused else None,
    )
    controller = api.HorizontalAutoscalerController(autoscaler, service)

    vecs: Dict[int, object] = {}
    vec_of: Dict[int, object] = {}

    def query_of(i, ns, series):
        v = i * queue_vectors // n_has
        vec = vecs.get(v)
        if vec is None:
            vec = vecs[v] = registry.register(
                "queue", "length" if queue_vectors == 1 else f"length_{v:03d}"
            )
        vec_of[i] = vec
        return f'{vec.full_name}{{name="{series}",namespace="{ns}"}}'

    actuate: set = set()

    def on_scale(event, obj):
        if obj.spec.replicas != obj.status.replicas:
            actuate.add((obj.metadata.namespace, obj.metadata.name))

    store.watch("ScalableNodeGroup", on_scale)
    has, base, forecasting, names_of = _draw_ha(
        api, store, rng, n_has, metrics, forecast_share, slo_share, groups,
        pools, query_of,
    )
    gauge_of = [(vec_of[i], names) for i, names in enumerate(names_of)]

    # the forecast series' history, observed before the fleet's first
    # reconcile: `history` samples one interval apart
    queues = base.copy()
    past = np.maximum(
        0.0,
        base[:, :1] * (1.0 + 0.2 * np.sin(np.arange(history)[None, :] / 5.0))
        + rng.normal(0.0, 0.05, (n_has, history)) * base[:, :1],
    ).astype(np.float32)
    for i in np.flatnonzero(forecasting):
        ha = has[i]
        key = ("ha", ha.metadata.namespace, ha.metadata.name, 0)
        for k in range(history):
            forecaster.history.append(
                key, clock["now"] - TICK_S * (history - k), float(past[i, k])
            )
    fleet = HAFleet(
        api=api, store=store, registry=registry, service=service,
        clock=clock, autoscaler=autoscaler, controller=controller,
        forecaster=forecaster, cost_engine=cost_engine,
        pool_engine=pool_engine, warmpool=warmpool, has=has, queues=queues,
        base=base, rng=rng, gauge_of=gauge_of, actuate=actuate,
    )
    for i, (vec, names) in enumerate(gauge_of):
        for j, name in enumerate(names):
            vec.set(name, has[i].metadata.namespace, float(queues[i, j]))
    return fleet


# -- the controller binary's world (runtime.py's three controllers) ----------

# What the runtime world needs, by module under the package root; `api=`
# takes these names from either package (runtime_api gives this package's).
RUNTIME_API = {
    "api.core": RECONCILE_API["api.core"],
    "api.horizontalautoscaler": HA_API["api.horizontalautoscaler"],
    "api.metricsproducer": (
        "MetricsProducer", "MetricsProducerSpec", "PendingCapacitySpec",
        "QueueSpec",
    ),
    "api.poolgroup": HA_API["api.poolgroup"],
    "api.scalablenodegroup": HA_API["api.scalablenodegroup"],
    "utils.quantity": ("Quantity",),
}


def runtime_api_namespace(modules: Dict[str, object]) -> ReconcileAPI:
    """The names of RUNTIME_API taken from `modules`, which maps each of
    its keys to a module object."""
    return _namespace(RUNTIME_API, modules)


def runtime_api() -> ReconcileAPI:
    """RUNTIME_API from this package."""
    from karpenter_tpu_torch.api import (
        core,
        horizontalautoscaler,
        metricsproducer,
        poolgroup,
        scalablenodegroup,
    )
    from karpenter_tpu_torch.utils import quantity

    return runtime_api_namespace({
        "api.core": core,
        "api.horizontalautoscaler": horizontalautoscaler,
        "api.metricsproducer": metricsproducer,
        "api.poolgroup": poolgroup,
        "api.scalablenodegroup": scalablenodegroup,
        "utils.quantity": quantity,
    })


@dataclass
class RuntimeWorld:
    """The objects build_runtime_world wrote, and the draw state its
    per-tick changes continue from: `cluster` is the pending-pods part
    (churn it with churn_reconcile), `queue_ids[i]` the fake queues HA i
    reads, whose lengths `step_queues` walks."""

    cluster: ReconcileCluster
    provider: object
    has: List
    queue_ids: List[List[str]]
    queues: np.ndarray  # f32[n_has, metrics] current queue values
    base: np.ndarray  # f32[n_has, metrics] level of each queue's walk
    rng: object
    steps: int = 0

    def step_queues(self) -> None:
        """Each queue takes HAFleet.step_world's seeded random-walk step
        around its level, and its fake queue reports the new length,
        rounded to a whole message count."""
        self.steps += 1
        n, m = self.queues.shape
        swell = 1.0 + 0.3 * np.sin(self.steps / 9.0 + np.arange(n) % 7)
        step = self.rng.normal(0.0, 0.08, (n, m)) * self.base
        self.queues = np.maximum(
            0.0, 0.7 * self.queues + 0.3 * self.base * swell[:, None] + step
        ).astype(np.float32)
        self._publish()

    def _publish(self) -> None:
        for i, ids in enumerate(self.queue_ids):
            for j, queue_id in enumerate(ids):
                self.provider.queue_lengths[queue_id] = int(
                    np.rint(self.queues[i, j])
                )


def build_runtime_world(
    store, provider, pods: int, types: int, n_has: int, metrics: int,
    seed: int, *, groups: int = 0, pools: int = 4,
    forecast_share: float = 0.5, slo_share: float = 0.6,
    api: Optional[ReconcileAPI] = None,
) -> RuntimeWorld:
    """The world the controller binary runs, written into `store` (an
    empty Store or DurableStore of either package) with `provider` (a
    FakeFactory of the same package) behind its node groups and queues.
    It writes objects only: the runtime builds every engine itself.

    - build_reconcile_cluster(pods, types, seed)'s draw: `pods` pending
      pods, `types` groups of one Ready node each, and one
      pendingCapacity MetricsProducer per group;
    - then, from np.random.default_rng(seed + 1), build_ha_fleet's draw
      of `n_has` HorizontalAutoscalers (tenants of four, `metrics` queue
      metrics each, forecasting ones one) with their ScalableNodeGroups
      and `groups` PoolGroups of `pools` members. Metric j of HA i reads
      `karpenter_queue_length{name="ha-<i>-m<j>",namespace=<tenant>}`,
      which a queue MetricsProducer of that name publishes from the fake
      queue `<tenant>/ha-<i>-m<j>` (the reference's own pipeline,
      tests/test_e2e.py's queue scenario). Each node group's replicas
      are set on the provider.

    The HA part selects no pod and no node of the pending part, so the
    pendingCapacity totals are build_reconcile_cluster's. `api`
    (runtime_api) names the classes; the port's by default."""
    api = api if api is not None else runtime_api()
    cluster = _draw_reconcile(
        api, store, np.random.default_rng(seed), pods, types, 0.0, 0.0, 0.0
    )
    rng = np.random.default_rng(seed + 1)

    def query_of(i, ns, series):
        return f'karpenter_queue_length{{name="{series}",namespace="{ns}"}}'

    has, base, _, names_of = _draw_ha(
        api, store, rng, n_has, metrics, forecast_share, slo_share, groups,
        pools, query_of,
    )
    queue_ids = []
    for ha, names in zip(has, names_of):
        ns = ha.metadata.namespace
        ids = [f"{ns}/{series}" for series in names]
        queue_ids.append(ids)
        for series, queue_id in zip(names, ids):
            store.create(api.MetricsProducer(
                metadata=api.ObjectMeta(name=series, namespace=ns),
                spec=api.MetricsProducerSpec(
                    queue=api.QueueSpec(type="FakeQueue", id=queue_id)
                ),
            ))
        target = ha.spec.scale_target_ref.name
        provider.node_replicas[target] = store.get(
            "ScalableNodeGroup", ns, target
        ).spec.replicas
    world = RuntimeWorld(
        cluster=cluster, provider=provider, has=has, queue_ids=queue_ids,
        queues=base.copy(), base=base, rng=rng,
    )
    world._publish()
    return world


# kinds a runtime world's store holds
RUNTIME_KINDS = ("Pod", "Node", "MetricsProducer", "ScalableNodeGroup",
                 "HorizontalAutoscaler", "PoolGroup")
# exposition families left out of a runtime snapshot: wall-clock timings
# and what is computed from them (the self-SLO monitor burns budget on
# the e2e-latency histogram and dumps the flight recorder when it does;
# the introspection plane's compile seconds), the process-wide tracer's
# span counts (shared by every runtime of one process), the card's
# memory (a CPU runtime reports none), and the shard route's gauge (the
# devices behind each side's mesh: the reference's tests give JAX eight
# virtual CPU devices, the port's runtimes see their own). The plane's
# storm counter and resident-entry gauges are compared: the card and the
# CPU equal there.
SNAPSHOT_SKIP = (
    "karpenter_reconcile_e2e_seconds", "karpenter_runtime_tick_seconds",
    "karpenter_solver_stage_", "karpenter_selfslo_",
    "karpenter_flightrecorder_", "karpenter_trace_spans_",
    "karpenter_device_", "karpenter_solver_compile_seconds",
    "karpenter_solver_shard_devices",
)

# a card runtime against a CPU runtime: the solve service's own counters
# (dispatches, key caches, residency) depend on its rung, so they are
# left out too
RUNG_SKIP = SNAPSHOT_SKIP + ("karpenter_solver_",)


def _family(line: str) -> str:
    if line.startswith("#"):
        parts = line.split()
        return parts[2] if len(parts) > 2 else ""
    return line.split("{", 1)[0].split(" ", 1)[0]


def runtime_snapshot(store, registry, provider, to_dict,
                     skip: tuple = SNAPSHOT_SKIP, pods: str = "manifest") -> dict:
    """What a runtime tick leaves behind, as plain values: every object
    of RUNTIME_KINDS as its manifest dict (`to_dict` of the store's
    package; the uid and the conditions' wall-clock transition times
    left out), the provider's node-group replicas, and the registry's
    exposition_lines. pods="fields" records a Pod as its labels, node
    and container requests instead (a tenth of the time at 100k pods),
    for worlds whose runtime writes no pod."""
    objects = {}
    for kind in RUNTIME_KINDS:
        for obj in store.list(kind):
            if kind == "Pod" and pods == "fields":
                objects[(kind, obj.metadata.namespace, obj.metadata.name)] = (
                    tuple(sorted(obj.metadata.labels.items())),
                    obj.spec.node_name,
                    tuple(tuple((r, str(q)) for r, q in sorted(c.requests.items()))
                          for c in obj.spec.containers),
                )
                continue
            doc = to_dict(obj)
            doc.get("metadata", {}).pop("uid", None)
            for c in (doc.get("status") or {}).get("conditions") or []:
                c.pop("lastTransitionTime", None)
            objects[(kind, obj.metadata.namespace, obj.metadata.name)] = doc
    return {
        "objects": objects,
        "replicas": dict(provider.node_replicas),
        "exposition": exposition_lines(registry, skip),
    }


def exposition_lines(registry, skip: tuple = SNAPSHOT_SKIP) -> List[str]:
    """The registry's exposition lines but those of the families in
    `skip` and those ending in _ms (timings)."""
    return [
        line for line in registry.expose_text().splitlines()
        if not (_family(line).startswith(skip)
                or _family(line).endswith("_ms"))
    ]


# -- the disruption path (consolidation + preemption, runtime.py:409-501) -----

DISRUPTION_API = {
    "api.conditions": ("ACTIVE",),
    "api.core": (
        "Container", "Node", "NodeCondition", "NodeSpec", "NodeStatus",
        "ObjectMeta", "Pod", "PodSpec",
    ),
    "api.metricsproducer": (
        "MetricsProducer", "MetricsProducerSpec", "PendingCapacitySpec",
    ),
    "api.scalablenodegroup": (
        "FAKE_NODE_GROUP", "ScalableNodeGroup", "ScalableNodeGroupSpec",
    ),
    "cloudprovider.fake": ("FakeFactory",),
    "consolidation": ("ConsolidationEngine",),
    "controllers.scalablenodegroup": ("ScalableNodeGroupController",),
    "metrics.registry": ("GaugeRegistry",),
    "preemption": ("PreemptionEngine",),
    "store": ("Store",),
    "utils.quantity": ("Quantity",),
}


def disruption_api_namespace(modules: Dict[str, object]) -> ReconcileAPI:
    """The names of DISRUPTION_API taken from `modules`, which maps each of
    its keys to a module object."""
    return _namespace(DISRUPTION_API, modules)


def disruption_api() -> ReconcileAPI:
    """DISRUPTION_API from this package."""
    from karpenter_tpu_torch import consolidation, preemption, store
    from karpenter_tpu_torch.api import (
        conditions,
        core,
        metricsproducer,
        scalablenodegroup,
    )
    from karpenter_tpu_torch.cloudprovider import fake
    from karpenter_tpu_torch.controllers import scalablenodegroup as sng
    from karpenter_tpu_torch.metrics import registry
    from karpenter_tpu_torch.utils import quantity

    return disruption_api_namespace({
        "api.conditions": conditions,
        "api.core": core,
        "api.metricsproducer": metricsproducer,
        "api.scalablenodegroup": scalablenodegroup,
        "cloudprovider.fake": fake,
        "consolidation": consolidation,
        "controllers.scalablenodegroup": sng,
        "metrics.registry": registry,
        "preemption": preemption,
        "store": store,
        "utils.quantity": quantity,
    })


# node pools of the disruption world; the last one is preemptible (spot).
# No source gives a pool count: four keeps one pool of each engine's cases.
DISRUPTION_POOLS = 4
# seconds between rounds: the ScalableNodeGroup controller's interval
ROUND_S = 60.0
# priorities as bench.py:4069 (build_preempt_inputs) draws them: bound pods
# (its victims) uniform on [0, 500), pending pods (its candidates) on
# [100, 1000)
BOUND_PRIORITY = (0, 500)
PENDING_PRIORITY = (100, 1000)
# exposition lines that carry host wall times (differ run to run)
_TIMED_GAUGES = ("batch_eval_ms",)


@dataclass
class DisruptionWorld:
    """A store of nodes, bound pods and pending critical pods, with one
    pendingCapacity MetricsProducer and one ScalableNodeGroup per pool,
    a FakeFactory whose replicas match the nodes, and the disruption
    engines wired as runtime.py:409-501 wires them around one solve
    service (fields as built by build_disruption_world).

    `round()` is one controller interval: the clock moves ROUND_S, then
    every ScalableNodeGroup (read fresh from the store, in key order) is
    reconciled by the controller — whose first reconcile lets preemption
    and then consolidation plan — and its status written back as the
    controller manager does (Active condition, status patch)."""

    api: ReconcileAPI
    store: object
    registry: object
    service: object
    clock: dict
    provider: object
    consolidation: object
    preemption: object
    controller: object
    # (round, result) of every plan: consolidation verdicts, preemption
    # results, appended by the engines' wrapped `plan`
    verdicts: List = None
    plans: List = None
    rounds: int = 0

    def round(self) -> dict:
        """One interval: {(namespace, name): error or None} per node group."""
        self.clock["now"] += ROUND_S
        self.rounds += 1
        errors = {}
        for key in sorted(self.store.keys("ScalableNodeGroup")):
            sng = self.store.get(*key)
            error = None
            try:
                self.controller.reconcile(sng)
            except Exception as exc:  # noqa: BLE001 — the manager's record
                error = exc
            mgr = sng.status_conditions()
            if error is None:
                mgr.mark_true(self.api.ACTIVE)
            else:
                mgr.mark_false(self.api.ACTIVE, "", str(error))
            self.store.patch_status(sng)
            errors[(key[1], key[2])] = error
        return errors

    def snapshot(self) -> dict:
        """The world's observable state as plain values: nodes (cordon and
        annotations), bound pods, node groups (replicas and conditions,
        transition times aside), provider replicas, both engines' state
        tables, and the registry's exposition without its timed lines."""
        nodes = sorted(
            (n.metadata.name, bool(n.spec.unschedulable),
             tuple(sorted(n.metadata.annotations.items())))
            for n in self.store.list("Node")
        )
        pods = sorted(
            (p.metadata.namespace, p.metadata.name, p.spec.node_name)
            for p in self.store.list("Pod")
        )
        groups = sorted(
            (g.metadata.namespace, g.metadata.name, g.spec.replicas,
             g.status.replicas,
             tuple((c.type, c.status, c.reason, c.message)
                   for c in g.status.conditions))
            for g in self.store.list("ScalableNodeGroup")
        )
        exposition = "\n".join(
            line for line in self.registry.expose_text().splitlines()
            if not any(name in line for name in _TIMED_GAUGES)
        )
        return {
            "nodes": nodes,
            "pods": pods,
            "groups": groups,
            "provider": sorted(self.provider.node_replicas.items()),
            "consolidation": self.consolidation.snapshot_state(),
            "preemption": self.preemption.snapshot_state(),
            "exposition": exposition,
        }


def _recorded(world: DisruptionWorld, engine, log: List) -> None:
    """Wrap `engine.plan` (what maybe_plan calls) so each plan's result
    lands in `log` with its round."""
    plan = engine.plan

    def recorded(now=None):
        out = plan(now)
        log.append((world.rounds, out))
        return out

    engine.plan = recorded


def build_disruption_world(
    nodes: int, pods: int, pending_critical: int, seed: int, *, service,
    api: Optional[ReconcileAPI] = None,
) -> DisruptionWorld:
    """The `--consolidate --preempt` world, with `service` (a
    SolverService of either package) behind both engines:

    - bench.py:3834 (build_consolidation_cluster): `nodes` Ready nodes of
      16 CPU / 64 Gi / 110 pods and `pods` bound pods, node index drawn
      int(nodes * u**2) (the skewed spread: the head runs hot and vetoes,
      the long tail drains) and CPU from {0.25, 0.5, 1, 2} with 2 GiB of
      memory per CPU, drawn from np.random.default_rng(seed) in the
      bench's order;
    - node n in pool n % DISRUPTION_POOLS, each pool with a
      pendingCapacity MetricsProducer (selector pool=<pool>) naming its
      ScalableNodeGroup (replicas = the pool's nodes, no eviction budget
      of its own); the last pool's group is spec.preemptible;
    - from a second stream, np.random.default_rng([seed, 1]): each bound
      pod's priority, uniform on BOUND_PRIORITY, then each pending pod's,
      uniform on PENDING_PRIORITY (bench.py:4069's victims and
      candidates);
    - `pending_critical` pending pods, pod i selecting pool
      i % DISRUPTION_POOLS and requesting a quarter CPU more (on a 0.25
      grid, at most 16) than the largest free CPU in its pool: the pods
      the scheduler cannot place, which are the ones left pending (no
      source sizes them; bench.py:4069 draws its candidates so that most
      need evictions);
    - a FakeFactory with those replicas, the ConsolidationEngine and the
      PreemptionEngine (engine defaults) wired both ways, and the
      ScalableNodeGroupController over them, all on one injected clock
      (`world.clock["now"]`, seconds).

    `api` (disruption_api) names the classes; the port's by default, so a
    test builds the same world from the reference's modules."""
    api = api if api is not None else disruption_api()
    clock = {"now": 1_000_000.0}
    now = lambda: clock["now"]  # noqa: E731
    store = api.Store()
    registry = api.GaugeRegistry()
    provider = api.FakeFactory()
    _draw_disruption(api, store, provider, nodes, pods, pending_critical,
                     seed)
    consolidation = api.ConsolidationEngine(
        store, solver_service=service, registry=registry, clock=now,
    )
    preemption = api.PreemptionEngine(
        store, solver_service=service, consolidation=consolidation,
        registry=registry, clock=now,
    )
    consolidation.node_guard = preemption.active_nodes
    controller = api.ScalableNodeGroupController(
        provider, consolidator=consolidation, preemptor=preemption,
        registry=registry, clock=now,
    )
    world = DisruptionWorld(
        api=api, store=store, registry=registry, service=service,
        clock=clock, provider=provider, consolidation=consolidation,
        preemption=preemption, controller=controller,
        verdicts=[], plans=[],
    )
    _recorded(world, consolidation, world.verdicts)
    _recorded(world, preemption, world.plans)
    return world


def _draw_disruption(api, store, provider, nodes: int, pods: int,
                     pending_critical: int, seed: int) -> None:
    """build_disruption_world's objects, written into `store`, with each
    node group's replicas set on `provider` (the draws of its
    docstring)."""
    rng = np.random.default_rng(seed)
    extra = np.random.default_rng([seed, 1])
    q = api.Quantity.parse
    pool_of = [f"pool-{k}" for k in range(DISRUPTION_POOLS)]
    for k, pool in enumerate(pool_of):
        members = len(range(k, nodes, DISRUPTION_POOLS))
        ref = f"sng-{pool}"
        store.create(api.MetricsProducer(
            metadata=api.ObjectMeta(name=f"pc-{pool}"),
            spec=api.MetricsProducerSpec(
                pending_capacity=api.PendingCapacitySpec(
                    node_selector={"pool": pool}, node_group_ref=ref,
                )
            ),
        ))
        store.create(api.ScalableNodeGroup(
            metadata=api.ObjectMeta(name=ref),
            spec=api.ScalableNodeGroupSpec(
                replicas=members, type=api.FAKE_NODE_GROUP, id=ref,
                preemptible=k == DISRUPTION_POOLS - 1,
            ),
        ))
        provider.node_replicas[ref] = members
    for n in range(nodes):
        store.create(api.Node(
            metadata=api.ObjectMeta(
                name=f"node-{n:04d}",
                labels={"pool": pool_of[n % DISRUPTION_POOLS]},
            ),
            spec=api.NodeSpec(),
            status=api.NodeStatus(
                allocatable={"cpu": q("16"), "memory": q("64Gi"),
                             "pods": q("110")},
                conditions=[api.NodeCondition("Ready", "True")],
            ),
        ))
    used = np.zeros(nodes)
    for i in range(pods):
        n = int(nodes * rng.random() ** 2) % nodes
        cpu = float(rng.choice([0.25, 0.5, 1.0, 2.0]))
        used[n] += cpu
        store.create(api.Pod(
            metadata=api.ObjectMeta(name=f"pod-{i:05d}"),
            spec=api.PodSpec(
                node_name=f"node-{n:04d}",
                containers=[api.Container(requests={
                    "cpu": q(str(cpu)), "memory": q(f"{int(cpu * 2048)}Mi"),
                })],
                priority=int(extra.integers(*BOUND_PRIORITY)),
            ),
        ))
    free = np.maximum(16.0 - used, 0.0)
    for i in range(pending_critical):
        k = i % DISRUPTION_POOLS
        pool_free = free[k::DISRUPTION_POOLS].max() if nodes > k else 0.0
        cpu = min(16.0, (np.floor(pool_free * 4) + 1) / 4)
        store.create(api.Pod(
            metadata=api.ObjectMeta(name=f"critical-{i:03d}"),
            spec=api.PodSpec(
                containers=[api.Container(requests={
                    "cpu": q(str(cpu)), "memory": q(f"{int(cpu * 2048)}Mi"),
                })],
                node_selector={"pool": pool_of[k]},
                priority=int(extra.integers(*PENDING_PRIORITY)),
            ),
        ))


# -- the multi-tenant control plane (tenancy/) --------------------------------


def build_tenant_problems(tenants: int, rows: int = 256, groups: int = 304,
                          seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """One seeded reconcile-size bin-pack per tenant cluster, in the shape
    the pending-capacity encoder hands the solver (phase 15's operands of
    run_e2e's cluster: `rows` deduplicated pod shapes with a multiplicity
    each, `groups` node groups, R = 4 resources — cpu, memory, pods and
    ephemeral storage — and 8 taint and 8 label words). Tenant i draws
    from np.random.default_rng(seed + i): cpu and memory like
    build_inputs, one pod slot per pod, 1-20 GiB of storage; groups of
    2-128 cores with 110 pod slots and 100-400 GiB of storage."""
    problems = []
    for i in range(tenants):
        rng = np.random.default_rng(seed + i)
        req = np.stack([
            rng.uniform(0.05, 8.0, rows),
            rng.uniform(0.1, 32.0, rows),
            np.ones(rows),
            rng.uniform(1.0, 20.0, rows),
        ], axis=1).astype(np.float32)
        cpu = rng.choice([2, 4, 8, 16, 32, 64, 96, 128], groups).astype(
            np.float32)
        mem = cpu * rng.choice([2.0, 4.0, 8.0], groups).astype(np.float32)
        alloc = np.stack([
            cpu, mem, np.full(groups, 110.0, np.float32),
            rng.uniform(100.0, 400.0, groups).astype(np.float32),
        ], axis=1)
        problems.append({
            "pod_requests": req,
            "pod_valid": np.ones(rows, bool),
            "pod_intolerant": rng.random((rows, 8)) < 0.05,
            "group_taints": rng.random((groups, 8)) < 0.1,
            "pod_required": rng.random((rows, 8)) < 0.03,
            "group_labels": rng.random((groups, 8)) < 0.8,
            "group_allocatable": alloc,
            "pod_weight": rng.integers(1, 40, rows).astype(np.int32),
        })
    return problems


def build_preempt_inputs(candidates: int, nodes: int, victims: int,
                         seed: int):
    """bench.py:4069's contended fleet for eviction planning, drawn in its
    order: mostly-full node columns, priority-striped victim occupancy
    sorted by (node, priority) (the program's contract), and
    high-priority candidates big enough that most placements need
    evictions. Returns the port's PreemptInputs holding numpy arrays."""
    from karpenter_tpu_torch.ops.preempt import PreemptInputs

    rng = np.random.default_rng(seed)
    C, N, V, R = candidates, nodes, victims, 4
    node_free = rng.uniform(0.0, 2.0, (N, R)).astype(np.float32)
    node_tier = (rng.random(N) < 0.3).astype(np.int32)
    victim_node = np.sort(rng.integers(0, N, V)).astype(np.int32)
    victim_priority = np.zeros(V, np.int32)
    for n in range(N):
        seg = victim_node == n
        victim_priority[seg] = np.sort(rng.integers(0, 500, seg.sum()))
    return PreemptInputs(
        pod_requests=rng.uniform(1.0, 6.0, (C, R)).astype(np.float32),
        pod_priority=rng.integers(100, 1000, C).astype(np.int32),
        pod_valid=np.ones(C, bool),
        pod_node_forbidden=rng.random((C, N)) < 0.1,
        node_free=node_free,
        node_tier=node_tier,
        victim_requests=rng.uniform(0.1, 2.0, (V, R)).astype(np.float32),
        victim_priority=victim_priority,
        victim_node=victim_node,
        victim_valid=np.ones(V, bool),
        victim_evictable=rng.random(V) < 0.95,
    )


# -- the --simulate dry run and SimLab ----------------------------------------


def _port_open_store(data_dir):
    from karpenter_tpu_torch.store.persistence import open_store

    return open_store(data_dir, compact_every=1 << 62)


def _write_dir(data_dir, open_store, draw) -> int:
    """`draw(store)` into a durable store at `data_dir`, journaled with
    no snapshot (each object is encoded once; a reader replays the WAL).
    Returns the objects written."""
    store = (open_store or _port_open_store)(data_dir)
    try:
        draw(store)
        return sum(len(store.keys(kind)) for kind in (
            "Pod", "Node", "MetricsProducer", "ScalableNodeGroup"))
    finally:
        store.close()


def write_reconcile_dir(data_dir: str, pods: int, types: int, seed: int, *,
                        open_store: Optional[Callable] = None,
                        api: Optional[ReconcileAPI] = None) -> int:
    """build_reconcile_cluster(pods, types, seed)'s draw written into a
    durable store at `data_dir` (the dry run's data dir: `pods` pending
    pods, `types` one-node groups, one pendingCapacity MetricsProducer
    each). `open_store` (data_dir -> an empty durable store) and `api`
    name the package that writes it (the port's by default). Returns the
    objects written."""
    api = api if api is not None else reconcile_api()
    return _write_dir(data_dir, open_store, lambda store: _draw_reconcile(
        api, store, np.random.default_rng(seed), pods, types, 0.0, 0.0, 0.0
    ))


def write_disruption_dir(data_dir: str, nodes: int, pods: int,
                         pending_critical: int, seed: int, *,
                         open_store: Optional[Callable] = None,
                         api: Optional[ReconcileAPI] = None) -> int:
    """build_disruption_world's objects (nodes, bound and pending pods,
    a pendingCapacity MetricsProducer and a ScalableNodeGroup per pool)
    written into a durable store at `data_dir`: the `--simulate
    --consolidate` data dir. Returns the objects written."""
    api = api if api is not None else disruption_api()
    return _write_dir(data_dir, open_store, lambda store: _draw_disruption(
        api, store, api.FakeFactory(), nodes, pods, pending_critical, seed
    ))


def what_if_specs() -> List[dict]:
    """The `--what-if` file's hypothetical node groups (a list, as the
    flag requires): a large ssd-labelled metal group and a small group
    tainted in the cloud-API dialect."""
    return [
        {"name": "metal",
         "allocatable": {"cpu": "96", "memory": "384Gi", "pods": "110"},
         "labels": {"disk": "ssd"}},
        {"name": "spot-small",
         "allocatable": {"cpu": "4", "memory": "16Gi"},
         "taints": [{"key": "spot", "value": "true",
                     "effect": "NO_SCHEDULE"}]},
    ]


# bench.py:2237-2246 (run_simlab): the cost theme, diurnal demand with
# spot spikes and a seeded fault schedule
SIMLAB_COST_THEME = dict(diurnal=True, amplitude=96.0, price_spike=1.5,
                         fault_probability=0.05)


def simlab_trails(ticks: int, rows: int, theme: Optional[dict] = None):
    """`trails(seed)` of simlab/builtin.make_trails at `ticks` x `rows`
    under `theme` (the bench's cost theme by default)."""
    from karpenter_tpu_torch.simlab.builtin import make_trails

    theme = SIMLAB_COST_THEME if theme is None else theme

    def trails(seed: int):
        return make_trails(seed, ticks=ticks, rows=rows, **theme)

    return trails


def build_sim_rollout_inputs(clusters: int, ticks: int, rows: int,
                             seed: int) -> Dict[str, np.ndarray]:
    """A SimRolloutInputs fleet drawn in bulk from
    np.random.default_rng(seed), one numpy array per field: make_trails'
    cost-theme shapes vectorized over the clusters (per-cluster row
    scales and diurnal phase, a one-day wave over `ticks`, next-tick
    forecasts with unit noise, 1 + 1.5 price spikes on ticks // 8 ticks,
    faults with probability 0.05, and a fault-free constant tail of
    ticks // 4), each cluster's knobs drawn from simlab/policy.py's
    search grid. SimParams' defaults give the scalars."""
    from karpenter_tpu_torch.simlab.env import SimParams
    from karpenter_tpu_torch.simlab.policy import _grid_candidates

    p = SimParams()
    rng = np.random.default_rng(seed)
    tail = ticks // 4
    row_scale = 0.5 + rng.random((clusters, 1, rows))
    phase = rng.random((clusters, 1, 1))
    wave = np.clip(np.sin(
        2.0 * np.pi * (np.arange(ticks)[None, :, None] / ticks + phase)
    ), 0.0, None)
    demand = (8.0 + rng.random((clusters, ticks, rows)) * 96.0 * row_scale) \
        * (0.25 + wave)
    demand[:, ticks - tail:] = demand[:, ticks - tail - 1:ticks - tail]
    demand = np.clip(demand, 0.0, 0.85 * p.max_replicas * p.cap)
    forecast = np.empty_like(demand)
    forecast[:, :-1] = demand[:, 1:] + rng.normal(
        0.0, 1.0, (clusters, ticks - 1, rows))
    forecast[:, -1] = demand[:, -1]
    forecast = np.clip(forecast, 0.0, None)
    price = np.ones((clusters, ticks))
    hot = rng.integers(0, ticks - tail, size=(clusters, max(2, ticks // 8)))
    np.put_along_axis(price, hot, 2.5, axis=1)
    fault = (rng.random((clusters, ticks)) < 0.05).astype(np.float64)
    fault[:, ticks - tail:] = 0.0
    grid = _grid_candidates()
    knobs = grid[rng.integers(0, len(grid), size=clusters)]
    replicas0 = np.clip(np.ceil(demand[:, 0] / p.cap), p.min_replicas,
                        p.max_replicas)
    f32 = np.float32
    return dict(
        replicas0=replicas0.astype(f32),
        streak0=np.zeros((clusters, rows), f32),
        demand=demand.astype(f32),
        forecast=forecast.astype(f32),
        price=price.astype(f32),
        fault=fault.astype(f32),
        knobs=knobs.astype(f32),
        cap=f32(p.cap), hourly=f32(p.hourly), step_limit=f32(p.step_limit),
        min_replicas=f32(p.min_replicas), max_replicas=f32(p.max_replicas),
    )


# -- real-cluster mode: the world behind a fake kube-apiserver ---------------

# What the apiserver world needs, by module under the package root; `api=`
# takes these names from either package (kube_api gives this package's).
KUBE_API = {
    **RECONCILE_API,
    "api.horizontalautoscaler": (
        "CrossVersionObjectReference", "HorizontalAutoscaler",
        "HorizontalAutoscalerSpec", "Metric", "MetricTarget",
        "PrometheusMetricSource",
    ),
    "api.scalablenodegroup": ("ScalableNodeGroup", "ScalableNodeGroupSpec"),
    "api.serialization": ("to_dict",),
}

# metadata the apiserver assigns, left out when documents are compared
SERVER_FIELDS = ("resourceVersion", "uid", "creationTimestamp")


def kube_api_namespace(modules: Dict[str, object]) -> ReconcileAPI:
    """The names of KUBE_API taken from `modules`, which maps each of its
    keys to a module object."""
    return _namespace(KUBE_API, modules)


def kube_api() -> ReconcileAPI:
    """KUBE_API from this package."""
    from karpenter_tpu_torch import store
    from karpenter_tpu_torch.api import (
        core,
        horizontalautoscaler,
        metricsproducer,
        scalablenodegroup,
        serialization,
    )
    from karpenter_tpu_torch.metrics import registry
    from karpenter_tpu_torch.metrics.producers import pendingcapacity
    from karpenter_tpu_torch.store import columnar
    from karpenter_tpu_torch.utils import quantity

    return kube_api_namespace({
        "api.core": core,
        "api.horizontalautoscaler": horizontalautoscaler,
        "api.metricsproducer": metricsproducer,
        "api.scalablenodegroup": scalablenodegroup,
        "api.serialization": serialization,
        "metrics.producers.pendingcapacity": pendingcapacity,
        "metrics.registry": registry,
        "store": store,
        "store.columnar": columnar,
        "utils.quantity": quantity,
    })


def seed_apiserver(server, objects, *, api: Optional[ReconcileAPI] = None
                   ) -> int:
    """Load `objects` (API objects, or documents already) into the fake
    kube-apiserver `server` under its lock, as its own writes would
    leave them: each as its `to_dict` document (`api`'s package, the
    port's by default) with the next resourceVersion and a uid. No watch
    event is sent and no history kept: seed before any client watches.
    A document is stored as given (not copied). Returns the objects
    loaded."""
    from karpenter_tpu_torch.store.kube import RESOURCES

    to_dict = (api if api is not None else kube_api()).to_dict
    with server._lock:
        for obj in objects:
            doc = obj if isinstance(obj, dict) else to_dict(obj)
            meta = doc.setdefault("metadata", {})
            ns = meta.setdefault("namespace", "default")
            server._rv += 1
            meta["resourceVersion"] = str(server._rv)
            meta.setdefault("uid", f"uid-seed-{server._rv}")
            server._objects[(RESOURCES[doc["kind"]][1], ns, meta["name"])] = doc
    return len(objects)


def build_kube_world(servers, pods: int, types: int, seed: int, *,
                     node_groups: int = 0,
                     api: Optional[ReconcileAPI] = None) -> ReconcileCluster:
    """build_reconcile_cluster(pods, types, seed)'s draw, plus
    `node_groups` ScalableNodeGroups `ng<g>` (fake provider, 1 replica)
    each scaled by a HorizontalAutoscaler on mp<g>'s additional-nodes
    gauge (docs/examples/pending-capacity-binpack.yaml), seeded into
    every fake kube-apiserver of `servers`. The returned cluster keeps
    the draw state churn_apiserver continues from; its store is the
    plain Store the world was drawn into (no feed, no registry), and
    `node_replicas` the replicas to set on each runtime's fake provider.
    `api` (kube_api) names the classes; the port's by default."""
    from karpenter_tpu_torch.store.kube import WATCHED_KINDS

    api = api if api is not None else kube_api()
    store = api.Store()
    cluster = _draw_reconcile(api, store, np.random.default_rng(seed), pods,
                              types, 0.0, 0.0, 0.0)
    cluster.node_replicas = {}
    for g in range(node_groups):
        name = f"ng{g}"
        store.create(api.ScalableNodeGroup(
            metadata=api.ObjectMeta(name=name),
            spec=api.ScalableNodeGroupSpec(
                replicas=1, type="FakeNodeGroup", id=name),
        ))
        store.create(api.HorizontalAutoscaler(
            metadata=api.ObjectMeta(name=name),
            spec=api.HorizontalAutoscalerSpec(
                scale_target_ref=api.CrossVersionObjectReference(
                    api_version="autoscaling.karpenter.sh/v1alpha1",
                    kind="ScalableNodeGroup", name=name,
                ),
                min_replicas=0, max_replicas=64,
                metrics=[api.Metric(prometheus=api.PrometheusMetricSource(
                    query=("karpenter_pending_capacity_additional_nodes_"
                           f'needed{{name="mp{g}"}}'),
                    target=api.MetricTarget(type="AverageValue", value=1),
                ))],
            ),
        ))
        cluster.node_replicas[name] = 1
    objects = [obj for kind in WATCHED_KINDS for obj in store.list(kind)]
    for server in servers:
        seed_apiserver(server, objects, api=api)
    return cluster


def apply_churn(server, pairs: List[tuple], *,
                api: Optional[ReconcileAPI] = None) -> str:
    """churn_pods' pairs written to the fake kube-apiserver `server`
    through its public delete_object / put_object (each fresh pod as its
    `to_dict` document, `api`'s package, the port's by default), so that
    they reach every mirror as watch events. Returns the resourceVersion
    of the last write."""
    to_dict = (api if api is not None else kube_api()).to_dict
    written = None
    for victim, pod in pairs:
        server.delete_object("pods", "default", victim)
        written = server.put_object("pods", to_dict(pod))
    return written["metadata"]["resourceVersion"] if written else ""


def churn_apiserver(servers, cluster: ReconcileCluster,
                    churn: Optional[int] = None, *,
                    api: Optional[ReconcileAPI] = None
                    ) -> Callable[[], List[str]]:
    """churn_reconcile's draw (churn_pods, drawn here) as the mutation
    that applies it to every fake kube-apiserver of `servers` in turn
    (apply_churn). The mutation returns, per server, the resourceVersion
    of its last write there."""
    pairs = churn_pods(cluster, churn)
    return lambda: [apply_churn(server, pairs, api=api) for server in servers]


def wait_mirrored(server, store, rv: str = "", kind: str = "Pod",
                  timeout: float = 120.0) -> float:
    """Wait until the KubeStore `store` mirrors what the fake
    kube-apiserver `server` holds of `kind`: with `rv`, until it has
    applied the watch event of that resourceVersion and holds exactly
    the server's object names (cheap at 100k pods); without, until every
    object's resourceVersion equals the server's (any KubeStore, the
    reference's too). Returns the seconds waited; raises TimeoutError
    past `timeout`."""
    from karpenter_tpu_torch.store.kube import RESOURCES

    plural = RESOURCES[kind][1]
    t0 = time.perf_counter()
    while True:
        if not rv or store.observed_version(kind) == rv:
            with server._lock:
                want = {(ns, name): doc["metadata"]["resourceVersion"]
                        for (p, ns, name), doc in server._objects.items()
                        if p == plural}
            if rv:
                got = {(ns, name) for _, ns, name in store.keys(kind)}
                settled = got == want.keys()
            else:
                got = {(o.metadata.namespace, o.metadata.name):
                       str(o.metadata.resource_version)
                       for o in store.list(kind)}
                settled = got == want
            if settled:
                return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(
                f"the mirror did not settle on {kind} within {timeout} s")
        time.sleep(0.002)


def server_documents(server, plural: str,
                     skip: tuple = SERVER_FIELDS) -> Dict[tuple, dict]:
    """{(namespace, name): document} of every `plural` object the fake
    kube-apiserver holds, less the metadata in `skip` and the
    conditions' wall-clock transition times."""
    out = {}
    for doc in server.objects(plural):
        meta = doc.get("metadata", {})
        for key in skip:
            meta.pop(key, None)
        for c in (doc.get("status") or {}).get("conditions") or []:
            c.pop("lastTransitionTime", None)
        out[(meta.get("namespace"), meta.get("name"))] = doc
    return out


# -- the shipped Deployment's world (sidecar + the GKE TPU provider) ----------

# What the Deployment world needs, by module under the package root; `api=`
# takes these names from either package (deployment_api gives this one's).
DEPLOYMENT_API = {
    **KUBE_API,
    "api.core": KUBE_API["api.core"] + ("NodeSpec", "Taint", "Toleration"),
    "cloudprovider": ("Options",),
    "cloudprovider.gke_sdk": ("GKEContainerClient",),
    "cloudprovider.tpu": ("TPUFactory", "TPU_TOPOLOGY_LABEL",
                          "NODE_POOL_LABEL", "TPU_CHIP_RESOURCE"),
}

# (pool, topology, machine type, live hosts): GKE TPU node pools. Each
# machine type has 4 chips per host; the last pool has no live node, so
# the bin-pack profiles it from the pool's template (scale from zero).
TPU_POOLS = (
    ("tpu-v5e-2x2", "2x2", "ct5lp-hightpu-4t", 2),
    ("tpu-v5e-4x4", "4x4", "ct5lp-hightpu-4t", 4),
    ("tpu-v4-2x2x2", "2x2x2", "ct4p-hightpu-4t", 2),
    ("tpu-train-pool", "2x4", "ct5lp-hightpu-4t", 0),
)
TPU_POOL_PARENT = "projects/example/locations/us-central2-b/nodePools/"
TPU_ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"
TPU_TAINT = ("google.com/tpu", "present")
# host shape of each machine type: (cpu, memory)
TPU_HOSTS = {"ct5lp-hightpu-4t": ("112", "192Gi"),
             "ct4p-hightpu-4t": ("240", "407Gi")}


def deployment_api_namespace(modules: Dict[str, object]) -> ReconcileAPI:
    """The names of DEPLOYMENT_API taken from `modules`, which maps each
    of its keys to a module object."""
    return _namespace(DEPLOYMENT_API, modules)


def deployment_api() -> ReconcileAPI:
    """DEPLOYMENT_API from this package."""
    from karpenter_tpu_torch import store
    from karpenter_tpu_torch.api import (
        core,
        horizontalautoscaler,
        metricsproducer,
        scalablenodegroup,
        serialization,
    )
    from karpenter_tpu_torch import cloudprovider
    from karpenter_tpu_torch.cloudprovider import gke_sdk, tpu
    from karpenter_tpu_torch.metrics import registry
    from karpenter_tpu_torch.metrics.producers import pendingcapacity
    from karpenter_tpu_torch.store import columnar
    from karpenter_tpu_torch.utils import quantity

    return deployment_api_namespace({
        "api.core": core,
        "api.horizontalautoscaler": horizontalautoscaler,
        "api.metricsproducer": metricsproducer,
        "api.scalablenodegroup": scalablenodegroup,
        "api.serialization": serialization,
        "cloudprovider": cloudprovider,
        "cloudprovider.gke_sdk": gke_sdk,
        "cloudprovider.tpu": tpu,
        "metrics.producers.pendingcapacity": pendingcapacity,
        "metrics.registry": registry,
        "store": store,
        "store.columnar": columnar,
        "utils.quantity": quantity,
    })


def _accelerator(machine_type: str) -> str:
    return ("tpu-v5-lite-podslice" if machine_type.startswith("ct5lp")
            else "tpu-v4-podslice")


class _Record:
    """An attribute bag, as google-cloud's response messages read."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


class FakeClusterManager:
    """The three calls GKEContainerClient (cloudprovider/gke_sdk.py) makes
    of google.cloud.container_v1.ClusterManagerClient, over the node
    pools of `pools` (TPU_POOLS' layout): set_node_pool_size is recorded
    in `resizes` as (pool, size), list_operations answers `operations`,
    get_node_pool answers the pool's config (machine type, the TPU
    labels, the google.com/tpu taint in the API's enum dialect). Thread
    safe: a runtime's controllers call it from their own threads."""

    def __init__(self, pools=TPU_POOLS):
        import threading

        self._lock = threading.Lock()
        self.resizes: List[tuple] = []
        self.operations: List = []
        self.configs = {
            pool: _Record(
                machine_type=machine,
                labels={
                    "cloud.google.com/gke-tpu-topology": topology,
                    TPU_ACCELERATOR_LABEL: _accelerator(machine),
                },
                taints=[_Record(
                    key=TPU_TAINT[0], value=TPU_TAINT[1],
                    effect=_Record(name="NO_SCHEDULE"),
                )],
            )
            for pool, topology, machine, _ in pools
        }

    def set_node_pool_size(self, request):
        with self._lock:
            self.resizes.append(
                (request["name"].rsplit("/", 1)[1], request["node_count"]))

    def list_operations(self, request):
        with self._lock:
            return _Record(operations=list(self.operations))

    def get_node_pool(self, request):
        return _Record(config=self.configs[request["name"].rsplit("/", 1)[1]])

    def take_resizes(self) -> List[tuple]:
        """The resizes recorded since the last call."""
        with self._lock:
            taken, self.resizes = self.resizes, []
        return taken


def tpu_factory(api: ReconcileAPI, manager: FakeClusterManager, store):
    """`api`'s TPUFactory over `manager` through its GKEContainerClient:
    the provider a --cloud-provider tpu runtime gets from a live GKE
    binding, with the fake standing in for Google's client."""
    return api.TPUFactory(api.Options(store=store),
                          container_api=api.GKEContainerClient(manager))


def build_deployment_world(store, pods: int, types: int, seed: int, *,
                           tpu_pods: int = 24, pools=TPU_POOLS,
                           api: Optional[ReconcileAPI] = None
                           ) -> ReconcileCluster:
    """The shipped Deployment's world, written into `store` (objects
    only; a KarpenterRuntime builds every engine itself):

    - build_reconcile_cluster(pods, types, seed)'s draw;
    - for each pool of `pools` (TPU_POOLS' layout) its live hosts
      (Ready, labeled with the pool, topology and accelerator, the
      google.com/tpu=present:NoSchedule taint, 4 chips each), a
      pendingCapacity MetricsProducer `tpu-<pool>` selecting its
      topology with nodeGroupRef = the pool, a TPUPodSlicePool
      ScalableNodeGroup `<pool>` asking for one slice more than its live
      hosts make (so the first reconcile resizes every pool), and a
      HorizontalAutoscaler scaling it on the producer's
      additional-nodes gauge (docs/examples/pending-capacity-binpack.
      yaml);
    - `tpu_pods` x (pool index + 1) pending pods per pool, each asking
      for one host's 4 chips, selecting the pool's topology and
      tolerating the taint. The reconcile draw's pods tolerate no taint,
      so they fit no pool, and these pods fit no other group.

    Returns the reconcile cluster (churn it with churn_reconcile; the
    TPU pods are never churned). `api` (deployment_api) names the
    classes; the port's by default."""
    api = api if api is not None else deployment_api()
    cluster = _draw_reconcile(api, store, np.random.default_rng(seed), pods,
                              types, 0.0, 0.0, 0.0)
    chips = "4"
    taint = api.Taint(key=TPU_TAINT[0], value=TPU_TAINT[1],
                      effect="NoSchedule")
    for index, (pool, topology, machine, hosts) in enumerate(pools):
        labels = {api.NODE_POOL_LABEL: pool,
                  api.TPU_TOPOLOGY_LABEL: topology,
                  TPU_ACCELERATOR_LABEL: _accelerator(machine)}
        cpu, memory = TPU_HOSTS[machine]
        for h in range(hosts):
            store.create(api.Node(
                metadata=api.ObjectMeta(name=f"{pool}-h{h}",
                                        labels=dict(labels)),
                spec=api.NodeSpec(taints=[taint]),
                status=api.NodeStatus(
                    allocatable={
                        "cpu": api.Quantity.parse(cpu),
                        "memory": api.Quantity.parse(memory),
                        api.TPU_CHIP_RESOURCE: api.Quantity.parse(chips),
                    },
                    conditions=[api.NodeCondition(type="Ready",
                                                  status="True")],
                ),
            ))
        slice_chips = int(np.prod([int(d) for d in topology.split("x")]))
        per_slice = max(1, -(-slice_chips // int(chips)))
        store.create(api.MetricsProducer(
            metadata=api.ObjectMeta(name=f"tpu-{pool}"),
            spec=api.MetricsProducerSpec(
                pending_capacity=api.PendingCapacitySpec(
                    node_selector={api.TPU_TOPOLOGY_LABEL: topology},
                    node_group_ref=pool,
                )
            ),
        ))
        store.create(api.ScalableNodeGroup(
            metadata=api.ObjectMeta(name=pool),
            spec=api.ScalableNodeGroupSpec(
                replicas=hosts // per_slice + 1, type="TPUPodSlicePool",
                id=TPU_POOL_PARENT + pool),
        ))
        store.create(api.HorizontalAutoscaler(
            metadata=api.ObjectMeta(name=pool),
            spec=api.HorizontalAutoscalerSpec(
                scale_target_ref=api.CrossVersionObjectReference(
                    api_version="autoscaling.karpenter.sh/v1alpha1",
                    kind="ScalableNodeGroup", name=pool,
                ),
                min_replicas=0, max_replicas=64,
                metrics=[api.Metric(prometheus=api.PrometheusMetricSource(
                    query=("karpenter_pending_capacity_additional_nodes_"
                           f'needed{{name="tpu-{pool}"}}'),
                    target=api.MetricTarget(type="AverageValue", value=1),
                ))],
            ),
        ))
        for k in range(tpu_pods * (index + 1)):
            store.create(api.Pod(
                metadata=api.ObjectMeta(name=f"{pool}-job{k}"),
                spec=api.PodSpec(
                    containers=[api.Container(requests={
                        api.TPU_CHIP_RESOURCE: api.Quantity.parse(chips)})],
                    node_selector={api.TPU_TOPOLOGY_LABEL: topology},
                    tolerations=[api.Toleration(key=TPU_TAINT[0],
                                                operator="Exists")],
                ),
            ))
    return cluster


# -- the replicated control plane (replication/, --partitions) ---------------

REPLICA_API = {
    "runtime": ("KarpenterRuntime", "Options"),
    "cloudprovider.fake": ("FakeFactory",),
    "faults": ("FaultRegistry", "ProcessCrash", "install", "uninstall"),
    "replication": ("crash_plan",),
}

# the cloud's state the replicas of one fleet share (FakeFactory's dicts)
_CLOUD_STATE = ("node_replicas", "node_templates", "queue_lengths",
                "queue_oldest_ages")
# the replication plane's own series, and the journal replay times (wall
# clock: an adoption's, and the boot's of each replica's journal root)
REPLICA_FAMILIES = ("karpenter_replica_", "karpenter_handoff_")
REPLICA_SKIP = ("karpenter_handoff_replay_seconds",
                "karpenter_recovery_replay_seconds")


def replica_api_namespace(modules: Dict[str, object]) -> ReconcileAPI:
    """The names of REPLICA_API taken from `modules`, which maps each of
    its keys to a module object."""
    return _namespace(REPLICA_API, modules)


def replica_api() -> ReconcileAPI:
    """REPLICA_API from this package."""
    from karpenter_tpu_torch import faults, replication, runtime
    from karpenter_tpu_torch.cloudprovider import fake

    return replica_api_namespace({
        "runtime": runtime, "cloudprovider.fake": fake, "faults": faults,
        "replication": replication,
    })


def replica_series(registry) -> List[str]:
    """The registry's exposition lines of the replica and handoff
    families, less the wall-clock replay time."""
    return [
        line for line in registry.expose_text().splitlines()
        if any(family in line for family in REPLICA_FAMILIES)
        and not any(skip in line for skip in REPLICA_SKIP)
    ]


class ReplicaFleet:
    """Replicas of the replicated control plane (`--partitions`) over one
    store, as separate processes run them: one KarpenterRuntime per id in
    `replica_ids`, built with `options` (an Options keyword dict of the
    runtime's package) and its own replica_id, each with its own
    FakeFactory, on one scripted clock. The first factory is `provider`
    (the world's); the others share its cloud state (node-group
    replicas, templates, queues) and keep their own fence validator, as
    each process holds its own. `options["journal_dir"]` is one root for
    all, so the tenants' fence and journal dirs (`<root>/tenants/<id>`)
    are shared and an adoption claims the next generation there.

    `tick()` runs one manager tick on every live replica in replica
    order. `kill(rid)` installs rid's crash plan (replica.crash.<rid>):
    its next tick raises ProcessCrash out of the tick hook, and the fleet
    abandons the replica as a SIGKILL would, releasing no lease and
    checkpointing no journal. `api` (replica_api) names the runtime's
    package; the port's by default."""

    def __init__(self, store, provider, replica_ids, clock, options: dict,
                 api: Optional[ReconcileAPI] = None):
        self.api = api if api is not None else replica_api()
        self.store, self.clock = store, clock
        self.providers: Dict[str, object] = {}
        self.runtimes: Dict[str, object] = {}
        self.dead: Dict[str, object] = {}  # rid -> the abandoned plane
        self.faults = self.api.FaultRegistry(seed=0)
        self.api.install(self.faults)
        try:
            for rid in replica_ids:
                factory = provider
                if self.providers:
                    factory = self.api.FakeFactory()
                    for name in _CLOUD_STATE:
                        setattr(factory, name, getattr(provider, name))
                self.providers[rid] = factory
                self.runtimes[rid] = self.api.KarpenterRuntime(
                    self.api.Options(**dict(options, replica_id=rid)),
                    store=store, cloud_provider_factory=factory,
                    clock=clock,
                )
        except BaseException:
            self.close()
            raise

    def live(self) -> List[str]:
        return [rid for rid in self.runtimes if rid not in self.dead]

    def plane(self, rid: str):
        return self.dead.get(rid) or self.runtimes[rid].replication

    def tick(self, each: Optional[Callable] = None) -> List[str]:
        """One manager tick on every live replica; returns the replicas
        that died in it. `each(rid, run)`, when given, runs the replica's
        tick by calling `run()` (a caller counting or timing per
        replica)."""
        died = []
        for rid in self.live():
            run = self.runtimes[rid].manager.reconcile_all
            try:
                if each is None:
                    run()
                else:
                    each(rid, run)
            except self.api.ProcessCrash:
                self._abandon(rid)
                died.append(rid)
        return died

    def biggest(self) -> str:
        """The live replica owning the most partitions (ties: the
        greatest id), simulate_failover's leader."""
        return max(self.live(), key=lambda rid: (
            len(self.plane(rid).leases.owned), rid))

    def kill(self, rid: str) -> None:
        self.api.crash_plan(self.faults, rid, times=1)

    def _abandon(self, rid: str) -> None:
        runtime = self.runtimes[rid]
        plane, runtime.replication = runtime.replication, None
        self.dead[rid] = plane
        # the zombie's open journals close without the graceful path:
        # its successors own the fences now
        for handoff in plane.handoffs.values():
            if handoff.recovery is not None:
                handoff.recovery.journal.close()
        if runtime.recovery is not None:
            runtime.recovery.journal.close()
            runtime.recovery = None
        runtime.close()

    def state(self) -> dict:
        """Every live replica's ownership, handoffs (state, fence
        generation, warm-up left) and replica/handoff series."""
        out = {}
        for rid in self.live():
            plane = self.plane(rid)
            out[rid] = {
                "owned": sorted(plane.leases.owned),
                "live": list(plane.last_round.live)
                if plane.last_round else [],
                "tenants": {
                    tenant: (h.state, h.generation, h.warmup_remaining)
                    for tenant, h in sorted(plane.handoffs.items())
                },
                "adopted": plane.adopted_total,
                "released": plane.released_total,
                "series": replica_series(self.runtimes[rid].registry),
            }
        return out

    def failover(self, world, before: int, after: int, churn: int,
                 tick_s: float, record: Callable,
                 each: Optional[Callable] = None) -> str:
        """The leader-kill script over a runtime world: `before` ticks,
        then the biggest owner's crash plan and the tick it dies in,
        then `after` more ticks. Each tick steps the clock (`.now`) by
        `tick_s`, and from the second on walks the world's queues and
        replaces `churn` pending pods first; `record(tick, died)` runs
        after it. With 2 * tick_s >= lease + skew the first tick after
        the kill is already lease + skew past the victim's last renew.
        Returns the victim."""
        victim = None
        for tick in range(before + 1 + after):
            self.clock.now += tick_s
            if tick:
                world.step_queues()
                churn_reconcile(world.cluster, churn)()
            if tick == before:
                victim = self.biggest()
                self.kill(victim)
            record(tick, self.tick(each))
        return victim

    def snapshot(self, to_dict, skip: tuple = RUNG_SKIP) -> dict:
        """state(), the store's objects and the cloud's node-group
        replicas (runtime_snapshot with pods="fields", once: the
        replicas share both), and every live replica's exposition, less
        `skip` and the replay time."""
        skip = skip + REPLICA_SKIP
        live = self.live()
        shared = runtime_snapshot(
            self.store, self.runtimes[live[0]].registry,
            self.providers[live[0]], to_dict, skip=skip, pods="fields")
        return {
            "state": self.state(),
            "objects": shared["objects"],
            "replicas": shared["replicas"],
            "exposition": {
                rid: exposition_lines(self.runtimes[rid].registry, skip)
                for rid in live
            },
        }

    def close(self) -> None:
        for rid in self.live():
            self.runtimes[rid].close()
        self.api.uninstall(self.faults)
