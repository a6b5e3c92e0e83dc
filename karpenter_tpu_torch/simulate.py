"""What-if simulation: a dry-run pending-pods solve with per-pod detail.

The production tick computes per-row assignments on the device
(ops/binpack.BinPackOutputs.assigned) but only publishes per-group
aggregates through the MetricsProducer status. This module surfaces the
rows: which pod shapes land where, what stays unschedulable and why the
operator should care — and answers "what would ADDING node group X
change?" by re-running the identical solve with hypothetical groups
appended to the group axis.

reference anchor: the reference has no simulation surface at all (its
pending-capacity producer is a stub, pendingcapacity/producer.go:29-31);
the intent served here is DESIGN.md "Pending Pods" — operators sizing a
scale-up want to see the placement the signal is promising.

Nothing here mutates the store or any status object: the solve runs on a
detached snapshot, making it safe against a live cluster.

Every `simulate_*` replay world in this module is registered as a
SimLab scenario (karpenter_tpu_torch/simlab/builtin.py, docs/simulator.md):
the scenario registry owns the `--simulate` CLI dispatch (`--list`
prints the catalog, `--sim-seed` threads a seed through the seeded
worlds' RNG streams), and pairs each world with seeded trail generators
for the gym-style simulator core. The functions here stay the library
surface — call them directly for programmatic replays; their default
seeds reproduce the digests the acceptance tests pin.

The port's copy of karpenter_tpu/simulate.py. Every world takes
`device`: where its SolverService (or runtime) runs — the CUDA card by
default, raising without one; "cpu" names the host. A world's `backend`
names the port's rung ("torch", "cuda" or "numpy"; the reference's
default "xla" becomes "torch", the tensor programs, except in the
multi-tenant lockstep replay, whose default "auto" is the card's rung).
`simulate_failover` is host code (leases, fences and journals over an
in-process store) and takes no device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.metrics.producers.pendingcapacity import (
    DomainCensus,
    encode_snapshot,
    group_profile,
)
from karpenter_tpu_torch.store.columnar import (
    PendingPodCache,
    is_pending,
    occupancy_from_pods,
)


def _what_if_profile(spec: dict) -> Tuple[Dict[str, float], set, set]:
    """A hypothetical group declared the same way provider node templates
    are: the raw dict goes through cloudprovider.node_template_from_raw
    (quantity parsing, cloud-API taint-effect dialect) and then the SAME
    template->profile conversion the scale-from-zero resolver uses —
    including the pods-resource default, so a spec that only declares
    cpu/memory is not silently infeasible for every pod."""
    from karpenter_tpu_torch.cloudprovider import node_template_from_raw
    from karpenter_tpu_torch.metrics.producers import profile_from_template

    template = node_template_from_raw(
        {
            "allocatable": spec.get("allocatable") or {},
            "labels": spec.get("labels") or {},
            "taints": spec.get("taints") or [],
        }
    )
    return profile_from_template(template)


def simulate(  # lint: allow-complexity — report assembly: one guard per optional report field
    store,
    what_if_groups: Optional[List[dict]] = None,
    solver=None,
    template_resolver=None,
    cost_model=None,
) -> dict:
    """One dry-run solve over the store's pendingCapacity producers plus
    `what_if_groups` (each {"name", "allocatable", "labels", "taints"}).

    Returns a JSON-shaped report:
      groups: per group {pending_pods, additional_nodes_needed,
              lp_lower_bound, what_if: bool, error?: str}
      rows:   per distinct pod shape {pod (ns/name of a representative),
              pods (count), assigned (group name or null)}
      unschedulable_pods: total weight with no feasible group

    `template_resolver` is the scale-from-zero seam solve_pending takes
    (producers.Factory.template_resolver): without it, empty groups with
    a nodeGroupRef encode as infeasible and the baseline drifts from the
    production solve. Per-producer failures are row-isolated exactly
    like the production path — a poisoned selector reports an `error` on
    its own group, never crashes the report.

    Hypothetical groups are appended AFTER the real ones, so first-
    feasible assignment only routes pods to them when no real group
    is feasible earlier in the order — the delta a what-if run shows is
    capacity the existing fleet genuinely lacks."""
    if solver is None:
        # the process-default solve service (solver/service.py): a
        # standalone simulation gets bucketing/backpressure/fallback for
        # free, and callers co-resident with other default-service users
        # (the sidecar server's RPCs) share one queue. A control plane
        # passes its runtime's own service here (__main__.py does).
        from karpenter_tpu_torch.solver import default_service

        solver = default_service().solve

    producers = sorted(
        (
            mp
            for mp in store.list("MetricsProducer")
            if mp.spec.pending_capacity is not None
        ),
        key=lambda mp: (mp.metadata.namespace, mp.metadata.name),
    )
    nodes = store.list("Node")
    names: List[str] = []
    profiles = []
    what_if_names = set()
    group_errors: Dict[str, str] = {}
    for mp in producers:
        # namespace-qualified like the production solve's (ns, name) keys:
        # same-named producers in different namespaces must not collapse
        names.append(f"{mp.metadata.namespace}/{mp.metadata.name}")
        try:
            profile = group_profile(
                nodes, mp.spec.pending_capacity.node_selector
            )
            if not profile[0] and template_resolver is not None:
                ref = getattr(
                    mp.spec.pending_capacity, "node_group_ref", ""
                )
                if ref:
                    resolved = template_resolver(
                        mp.metadata.namespace, ref
                    )
                    if resolved is not None:
                        profile = resolved
        except Exception as e:  # noqa: BLE001 — row-isolated like
            # solve_pending: the dry-run tool must not crash on the
            # degraded clusters an operator most wants to inspect
            group_errors[names[-1]] = f"{type(e).__name__}: {e}"
            profile = ({}, set(), set())
        profiles.append(profile)
    for spec in what_if_groups or []:
        name = spec.get("name") or f"what-if-{len(what_if_names)}"
        n = 2
        while name in names:  # a colliding spec must not overwrite a row
            name = f"{spec.get('name') or 'what-if'}#{n}"
            n += 1
        names.append(name)
        what_if_names.add(name)
        profiles.append(_what_if_profile(spec))

    # detached encode with a slot -> pod-name map for per-row reporting
    # (snapshot rows are arena slots; snapshot_from_pods hides the map)
    all_pods = store.list("Pod")
    pods = [pod for pod in all_pods if is_pending(pod)]
    cache = PendingPodCache(store=None, capacity=max(16, len(pods)))
    slot_pod: Dict[int, str] = {}
    for pod in pods:
        key = (pod.metadata.namespace, pod.metadata.name)
        cache._upsert(key, pod)
        slot_pod[cache._slot[key]] = f"{key[0]}/{key[1]}"
    snap = cache.snapshot()

    # existing-pod domain occupancy, exactly like the production solve:
    # census nodes are the REAL ones (a what-if group's domains hold no
    # existing pods by construction)
    census = DomainCensus(occupancy_from_pods(all_pods), lambda: nodes)
    census.set_namespaces(store.list("Namespace"))
    inputs, row_idx, row_weight = encode_snapshot(
        snap, profiles, with_rows=True, census=census
    )
    if what_if_names and inputs.pod_group_score is not None:
        # preferred node affinity must not STEER pods into hypothetical
        # groups (the solver argmaxes score among feasible groups, which
        # would let a what-if group steal pods a real group serves): zero
        # their score columns, so they absorb only what no real group
        # can take — the invariant the delta report documents
        import dataclasses

        score = np.array(inputs.pod_group_score)
        score[:, len(profiles) - len(what_if_names): len(profiles)] = 0.0
        inputs = dataclasses.replace(inputs, pod_group_score=score)
    # per-group node pricing (cost/model.py): the columnar cost face of
    # the SAME profiles the solve encodes, so the report prices what a
    # scale-up signal would actually cost per hour (`cost_model` lets
    # the CLI's --cost-default-hourly/--cost-spot-multiplier knobs
    # reach the dry-run report)
    if cost_model is None:
        from karpenter_tpu_torch.cost import CostModel

        cost_model = CostModel()
    group_cost = cost_model.group_costs(profiles)
    if len(row_idx) == 0:
        return {
            "groups": {
                name: {
                    "pending_pods": 0,
                    "additional_nodes_needed": 0,
                    "lp_lower_bound": 0,
                    "node_hourly_cost": round(float(group_cost[t]), 4),
                    "scale_up_hourly_cost": 0.0,
                    "what_if": name in what_if_names,
                    **(
                        {"error": group_errors[name]}
                        if name in group_errors
                        else {}
                    ),
                }
                for t, name in enumerate(names)
            },
            "rows": [],
            "unschedulable_pods": 0,
        }
    out = solver(inputs)
    assigned = np.asarray(out.assigned)
    assigned_count = np.asarray(out.assigned_count)
    nodes_needed = np.asarray(out.nodes_needed)
    lp_bound = np.asarray(out.lp_bound)

    rows = []
    for i in range(len(row_idx)):
        group = int(assigned[i])
        rows.append(
            {
                "pod": slot_pod.get(int(row_idx[i]), "<unknown>"),
                "pods": int(row_weight[i]),
                "assigned": (
                    names[group] if 0 <= group < len(names) else None
                ),
            }
        )
    return {
        "groups": {
            name: {
                "pending_pods": int(assigned_count[t]),
                "additional_nodes_needed": int(nodes_needed[t]),
                "lp_lower_bound": int(lp_bound[t]),
                "node_hourly_cost": round(float(group_cost[t]), 4),
                "scale_up_hourly_cost": round(
                    float(nodes_needed[t]) * float(group_cost[t]), 4
                ),
                "what_if": name in what_if_names,
                **(
                    {"error": group_errors[name]}
                    if name in group_errors
                    else {}
                ),
            }
            for t, name in enumerate(names)
        },
        "rows": rows,
        "unschedulable_pods": int(out.unschedulable),
    }


def simulate_consolidation(store, service=None, buckets: int = 32) -> dict:
    """Dry-run consolidation plan: which nodes' pods would re-pack onto
    the remainder of the cluster, and why the rest are ineligible.

    The same candidate generation and batched masked bin-pack the
    production engine runs (karpenter_tpu_torch/consolidation), minus the
    runtime-state safety gates — cooldown clocks and in-flight budgets
    live in the long-running engine, so a fresh dry-run process reports
    STRUCTURAL drainability and leaves pacing to the engine. Nothing is
    cordoned, scaled, or otherwise mutated.

    Report shape:
      nodes: per node {group, pods, drainable | ineligible reason}
      drainable: [node names]
      candidates_evaluated: how many masked solves the batch carried
    """
    from karpenter_tpu_torch.consolidation import (
        DO_NOT_DISRUPT,
        cluster_view,
        discover_groups,
        evaluate,
    )

    if service is None:
        from karpenter_tpu_torch.solver import default_service

        service = default_service()

    def node_entry(nv) -> dict:
        entry: dict = {
            "group": (
                f"{nv.group[0]}/{nv.group[2]}"
                if nv.group is not None and nv.group[2]
                else None
            ),
            "pods": len(nv.pods),
        }
        if nv.group is None or not nv.group[2]:
            entry["ineligible"] = "no nodeGroupRef to actuate"
        elif not nv.receiver:
            entry["ineligible"] = "not ready/schedulable"
        elif nv.do_not_disrupt:
            entry["ineligible"] = f"{DO_NOT_DISRUPT} annotation"
        return entry

    groups = discover_groups(store)
    view = cluster_view(store, groups)
    report: Dict[str, dict] = {
        nv.name: node_entry(nv) for nv in view.nodes
    }
    candidates = [
        name for name, entry in report.items()
        if "ineligible" not in entry
    ]
    verdicts = evaluate(view, candidates, service, buckets=buckets)
    for name, verdict in verdicts.items():
        report[name]["drainable"] = verdict
    return {
        "nodes": report,
        "drainable": sorted(
            name for name, v in verdicts.items() if v
        ),
        "candidates_evaluated": len(candidates),
    }


def simulate_trace(export_path: Optional[str] = None, device=None) -> dict:  # lint: allow-complexity — scenario assembly: world build + FSM-phased replay + report
    """The traced end-to-end replay (docs/observability.md): a seeded
    consolidating world driven tick by tick with the reconcile tracer
    capturing every layer — tick entry, producer solves, the HA fleet
    decide, the COALESCED consolidation dispatch (one solver dispatch
    span linking every candidate request span that rode it), and the
    ScalableNodeGroup actuation that closes the event-observed ->
    actuation-acked window. `export_path` writes the capture as
    Chrome-trace/Perfetto JSONL; the report summarizes what the trace
    must contain (the acceptance pin in tests/test_observability.py).

    Nothing here touches a live store or provider: the world is
    self-contained (fake provider, scripted clock)."""
    from karpenter_tpu_torch.api.core import (
        Container, Node, NodeCondition, NodeSpec, NodeStatus,
        ObjectMeta, Pod, PodSpec, resource_list,
    )
    from karpenter_tpu_torch.api.horizontalautoscaler import (
        CrossVersionObjectReference, HorizontalAutoscaler,
        HorizontalAutoscalerSpec, Metric, MetricTarget,
        PrometheusMetricSource,
    )
    from karpenter_tpu_torch.api.metricsproducer import (
        MetricsProducer, MetricsProducerSpec, PendingCapacitySpec,
    )
    from karpenter_tpu_torch.api.scalablenodegroup import (
        FAKE_NODE_GROUP, ScalableNodeGroup, ScalableNodeGroupSpec,
    )
    from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
    from karpenter_tpu_torch.observability import default_tracer
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
    from karpenter_tpu_torch.utils.quantity import Quantity

    tracer = default_tracer()
    tracer.clear()
    clock = {"now": 1_000_000.0}
    provider = FakeFactory()
    provider.node_replicas["grp-id"] = 3
    runtime = KarpenterRuntime(
        Options(consolidate=True, device=device),
        cloud_provider_factory=provider,
        clock=lambda: clock["now"],
    )
    store = runtime.store
    for i in range(3):
        store.create(Node(
            metadata=ObjectMeta(name=f"n{i}", labels={"pool": "a"}),
            spec=NodeSpec(),
            status=NodeStatus(
                allocatable=resource_list(
                    cpu="8", memory="16Gi", pods="16"
                ),
                conditions=[NodeCondition("Ready", "True")],
            ),
        ))
    for i in range(3):
        # one small pod per node: every candidate needs a REAL masked
        # bin-pack (empty nodes short-circuit as trivially drainable and
        # would never ride the coalesced dispatch this replay exists to
        # trace)
        store.create(Pod(
            metadata=ObjectMeta(name=f"p{i}"),
            spec=PodSpec(
                node_name=f"n{i}",
                containers=[Container(requests={
                    "cpu": Quantity.parse("1"),
                    "memory": Quantity.parse("1Gi"),
                })],
            ),
        ))
    store.create(MetricsProducer(
        metadata=ObjectMeta(name="pending"),
        spec=MetricsProducerSpec(
            pending_capacity=PendingCapacitySpec(
                node_selector={"pool": "a"}, node_group_ref="grp",
            )
        ),
    ))
    store.create(ScalableNodeGroup(
        metadata=ObjectMeta(name="grp"),
        spec=ScalableNodeGroupSpec(
            replicas=3, type=FAKE_NODE_GROUP, id="grp-id",
        ),
    ))
    store.create(HorizontalAutoscaler(
        metadata=ObjectMeta(name="ha"),
        spec=HorizontalAutoscalerSpec(
            scale_target_ref=CrossVersionObjectReference(
                kind="ScalableNodeGroup", name="grp"
            ),
            min_replicas=2, max_replicas=100,
            metrics=[Metric(prometheus=PrometheusMetricSource(
                query='karpenter_queue_length{name="q"}',
                target=MetricTarget(type="AverageValue", value=4),
            ))],
        ),
    ))
    # queue length 8 / target 4 -> the HA computes desired 2 against the
    # observed 3: the decide patches spec.replicas, the watch event
    # stamps the e2e observation, and the next tick's SNG reconcile
    # actuates — the event-observed -> actuation-acked chain the trace
    # and karpenter_reconcile_e2e_seconds must both capture
    runtime.registry.register("queue", "length").set("q", "default", 8.0)

    engine = runtime.consolidation
    e2e_before = tracer.e2e_observed
    try:
        # tick through the consolidation FSM: first sight starts the
        # churn clock, cooldown expiry plans (the COALESCED candidate
        # dispatch), verify soaks, drain decrements spec.replicas, and
        # the watch-requeued SNG reconcile actuates the provider write
        runtime.manager.converge(1)
        clock["now"] += engine.config.cooldown_s + 1
        runtime.manager.converge(1)
        clock["now"] += engine.config.verify_s + 1
        runtime.manager.converge(1)
        runtime.manager.converge(2)
        actuated = provider.node_replicas["grp-id"]
    finally:
        runtime.close()

    spans = tracer.snapshot()
    dispatches = [
        s for s in spans if s["name"].startswith("solver.dispatch")
    ]
    max_links = max((len(s["links"]) for s in dispatches), default=0)
    report = {
        "replicas_after": actuated,
        "spans": len(spans),
        "traces": len({s["trace"] for s in spans}),
        "dispatch_spans": len(dispatches),
        "max_dispatch_links": max_links,
        "actuation_spans": sum(
            1 for s in spans if s["name"] == "actuate.set_replicas"
        ),
        "tick_spans": sum(
            1 for s in spans if s["name"] == "reconcile.tick"
        ),
        "e2e_samples": tracer.e2e_observed - e2e_before,
    }
    if export_path:
        report["trace_export"] = export_path
        report["trace_events"] = tracer.export_jsonl(export_path)
    return report


def _recording_provider():
    """FakeFactory that records every provider write as (group_id,
    count) in `.writes` — the shared actuation ledger of the eventloop
    and restart-storm replays (one definition, so the two replays'
    write accounting can never drift apart)."""
    from karpenter_tpu_torch.cloudprovider.fake import (
        FakeFactory, FakeNodeGroup,
    )

    class _RecordingGroup(FakeNodeGroup):
        def set_replicas(self, count, token=None):
            super().set_replicas(count, token=token)
            self._factory.writes.append((self._id, count))

    class _RecordingFactory(FakeFactory):
        def __init__(self):
            super().__init__()
            self.writes = []

        def node_group_for(self, spec):
            return _RecordingGroup(self, spec.id)

    return _RecordingFactory()


def _eventloop_world(event_driven: bool, debounce_s: float, clock_fn,
                     device=None):
    """One seeded autoscaling world for the event-loop replay: a node
    pool, a pendingCapacity producer, a queue-driven autoscaler, and a
    fake provider. `event_thread=False` — the replay drives event
    passes itself on the scripted clock, so both arms are wall-free."""
    from karpenter_tpu_torch.api.core import (
        Node, NodeCondition, NodeSpec, NodeStatus, ObjectMeta,
        resource_list,
    )
    from karpenter_tpu_torch.api.horizontalautoscaler import (
        CrossVersionObjectReference, HorizontalAutoscaler,
        HorizontalAutoscalerSpec, Metric, MetricTarget,
        PrometheusMetricSource,
    )
    from karpenter_tpu_torch.api.metricsproducer import (
        MetricsProducer, MetricsProducerSpec, PendingCapacitySpec,
    )
    from karpenter_tpu_torch.api.scalablenodegroup import (
        FAKE_NODE_GROUP, ScalableNodeGroup, ScalableNodeGroupSpec,
    )
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options

    provider = _recording_provider()
    provider.node_replicas["grp-id"] = 3
    runtime = KarpenterRuntime(
        Options(
            event_driven=event_driven,
            event_debounce_s=debounce_s,
            event_thread=False,
            device=device,
        ),
        cloud_provider_factory=provider,
        clock=clock_fn,
    )
    store = runtime.store
    store.create(Node(
        metadata=ObjectMeta(name="n0", labels={"pool": "a"}),
        spec=NodeSpec(),
        status=NodeStatus(
            allocatable=resource_list(cpu="8", memory="16Gi", pods="16"),
            conditions=[NodeCondition("Ready", "True")],
        ),
    ))
    store.create(MetricsProducer(
        metadata=ObjectMeta(name="pending"),
        spec=MetricsProducerSpec(
            pending_capacity=PendingCapacitySpec(
                node_selector={"pool": "a"}, node_group_ref="grp",
            )
        ),
    ))
    store.create(ScalableNodeGroup(
        metadata=ObjectMeta(name="grp"),
        spec=ScalableNodeGroupSpec(
            replicas=3, type=FAKE_NODE_GROUP, id="grp-id",
        ),
    ))
    store.create(HorizontalAutoscaler(
        metadata=ObjectMeta(name="ha"),
        spec=HorizontalAutoscalerSpec(
            scale_target_ref=CrossVersionObjectReference(
                kind="ScalableNodeGroup", name="grp"
            ),
            min_replicas=2, max_replicas=400,
            metrics=[Metric(prometheus=PrometheusMetricSource(
                query='karpenter_queue_length{name="q"}',
                target=MetricTarget(type="AverageValue", value=4),
            ))],
        ),
    ))
    gauge = runtime.registry.register("queue", "length")
    gauge.set("q", "default", 12.0)
    return runtime, provider, gauge


def simulate_eventloop(  # lint: allow-complexity — scenario assembly: two arms + churn-storm arm + report
    ticks: int = 40,
    interval_s: float = 10.0,
    arrivals: int = 60,
    storm_events: int = 1000,
    debounce_s: float = 0.05,
    demand_step: float = 4.0,
    seed: int = 0,
    device=None,
) -> dict:
    """The event-driven-reconcile proof replay (docs/solver-service.md
    "Event-driven reconcile"): ONE seeded pod-arrival trace — `arrivals`
    pending pods at uniform-random times over `ticks` backstop
    intervals, each bumping queue demand by `demand_step` — replayed
    through two otherwise-identical worlds:

      tick-paced    the pre-PR loop: watch events mark objects due-now
                    but every reconcile waits for the next `interval_s`
                    tick, so the karpenter_reconcile_e2e_seconds sample
                    for each actuation is ~one full interval;
      event-driven  watch events cascade through debounced coalesced
                    event passes (pod -> producer solve -> autoscaler
                    decide -> node-group actuation), each hop one
                    `debounce_s` window — sub-second end to end.

    Both arms read e2e p50/p99 off the SAME histogram the live plane
    serves (HistogramVec.percentile — the number an operator's
    histogram_quantile() shows), count their solver work (bin-pack
    requests + fleet decides) for the amplification column, and must
    land on the SAME fleet fixed point. The event world then takes a
    CHURN STORM — `storm_events` pod events inside one debounce window —
    which must coalesce into a handful of passes (not one per event)
    with solve amplification bounded vs one backstop tick's work.

    Wall-clock-free and fully deterministic under `seed`: scripted
    clock, manual event passes (Options.event_thread=False), seeded
    arrival times."""
    from karpenter_tpu_torch.api.core import ObjectMeta, Pod, PodSpec
    from karpenter_tpu_torch.observability import (
        Tracer, reset_default_tracer, set_default_tracer,
    )

    rng = np.random.RandomState(seed)
    times = np.sort(
        rng.uniform(0.0, ticks * interval_s, size=arrivals)
    ).tolist()
    epoch = 1_000_000.0

    def replay(event_driven: bool) -> dict:
        clock = {"now": epoch}
        # the e2e histogram must measure SIMULATED lead time (ticks are
        # replayed far faster than the interval they model), so the
        # tracer runs on the scripted clock for this arm
        set_default_tracer(Tracer(clock=lambda: clock["now"]))
        runtime, provider, gauge = _eventloop_world(
            event_driven, debounce_s, lambda: clock["now"], device
        )
        manager = runtime.manager
        store = runtime.store
        stats = runtime.solver_service.stats

        def solves() -> int:
            return stats.requests + stats.decide_calls

        def passes() -> float:
            value = runtime.registry.gauge(
                "runtime", "event_passes_total"
            ).get("manager", "-")
            return float(value or 0.0)

        def drain(limit: int = 6) -> None:
            """The debounce thread's job, on the scripted clock: each
            pending pass costs one debounce window of simulated time."""
            for _ in range(limit):
                if manager.dirty_count() == 0:
                    return
                clock["now"] += debounce_s
                manager.run_event_pass()

        demand = 12.0
        next_arrival = 0
        try:
            for k in range(1, ticks + 1):
                while (
                    next_arrival < len(times)
                    and times[next_arrival] < k * interval_s
                ):
                    clock["now"] = max(
                        clock["now"], epoch + times[next_arrival]
                    )
                    demand += demand_step
                    gauge.set("q", "default", demand)
                    store.create(Pod(
                        metadata=ObjectMeta(
                            name=f"arrival-{next_arrival}"
                        ),
                        spec=PodSpec(),
                    ))
                    if event_driven:
                        drain()
                    next_arrival += 1
                clock["now"] = max(clock["now"], epoch + k * interval_s)
                manager.reconcile_all()
                if event_driven:
                    drain()
            # settle: the trace's tail actuations need one more hop
            for _ in range(3):
                clock["now"] += interval_s
                manager.reconcile_all()
                if event_driven:
                    drain()
            trace_solves = solves()
            hist = runtime.registry.gauge("reconcile", "e2e_seconds")
            arm = {
                "e2e_seconds": {
                    "p50_s": hist.percentile(
                        "ScalableNodeGroup", "-", 50
                    ),
                    "p99_s": hist.percentile(
                        "ScalableNodeGroup", "-", 99
                    ),
                    "n": hist.count("ScalableNodeGroup", "-"),
                },
                "solves": trace_solves,
                "replicas_after": provider.node_replicas["grp-id"],
                "provider_writes": len(provider.writes),
            }
            if not event_driven:
                return arm
            arm["event_passes"] = passes()
            # -- churn-storm arm: storm_events pod events, ONE window --
            storm_t0 = clock["now"]
            s0, p0 = solves(), passes()
            for i in range(storm_events):
                store.create(Pod(
                    metadata=ObjectMeta(name=f"storm-{i}"),
                    spec=PodSpec(),
                ))
            drain(limit=8)
            storm_solves = solves() - s0
            storm_passes = passes() - p0
            # measured BEFORE the comparator tick advances the clock:
            # this is the simulated time the storm's passes spanned
            storm_window = round(clock["now"] - storm_t0, 3)
            # the tick-paced comparator: ONE backstop tick over a
            # freshly-churned world is the work a tick-paced loop would
            # have spent reacting to the storm (the extra pod keeps the
            # encoder's unchanged-cluster memo from eliding the tick's
            # solve, which would flatter the storm ratio)
            s1 = solves()
            store.create(Pod(
                metadata=ObjectMeta(name="storm-comparator"),
                spec=PodSpec(),
            ))
            clock["now"] += interval_s
            manager.reconcile_all()
            tick_solves = max(1, solves() - s1)
            arm["storm"] = {
                "events": storm_events,
                "passes": storm_passes,
                "solves": storm_solves,
                "window_s": storm_window,
                "amplification": round(storm_solves / tick_solves, 2),
            }
            return arm
        finally:
            runtime.close()

    try:
        tick_arm = replay(False)
        event_arm = replay(True)
    finally:
        # never leak a scripted-clock tracer into the process default
        reset_default_tracer()

    tick_p99 = tick_arm["e2e_seconds"]["p99_s"] or 0.0
    event_p99 = event_arm["e2e_seconds"]["p99_s"] or 0.0
    return {
        "config": {
            "ticks": ticks,
            "interval_s": interval_s,
            "arrivals": arrivals,
            "storm_events": storm_events,
            "debounce_s": debounce_s,
            "demand_step": demand_step,
            "seed": seed,
        },
        "tick_paced": tick_arm,
        "event_driven": event_arm,
        "e2e_p99_s": {
            "tick_paced": tick_p99,
            "event_driven": event_p99,
            "speedup": round(tick_p99 / event_p99, 1)
            if event_p99 else None,
        },
        "solve_amplification": round(
            event_arm["solves"] / max(1, tick_arm["solves"]), 2
        ),
        "fixed_point_match": (
            tick_arm["replicas_after"] == event_arm["replicas_after"]
        ),
    }


def simulate_forecast(  # lint: allow-complexity — scenario assembly: world build + two replays + report
    ticks: int = 90,
    interval_s: float = 10.0,
    horizon_s: float = 60.0,
    model: str = "holt-winters",
    base: float = 8.0,
    amplitude: float = 120.0,
    ramp_start: int = 10,
    ramp_ticks: int = 24,
    target: float = 4.0,
    min_samples: int = 4,
    seed: int = 0,
    backend: str = "torch",
    device=None,
) -> dict:
    """Dry-run the predictive subsystem against a synthetic diurnal
    ramp (docs/forecasting.md "Dry-running"): the same scripted metric —
    flat overnight base, a smooth morning surge of `amplitude` over
    `ramp_ticks`, then a daytime plateau — is replayed through two
    otherwise-identical autoscalers, one with spec.behavior.forecast and
    one reactive-only, and the report quantifies the PROVISIONING LEAD:
    how many ticks earlier the forecast-enabled autoscaler reached each
    capacity milestone, i.e. how much node-provisioning latency a real
    node group would have hidden. Nothing here touches a store or a
    cloud provider — both worlds are built from scratch in memory.
    """
    import math as _math

    from karpenter_tpu_torch.api.core import ObjectMeta
    from karpenter_tpu_torch.api.horizontalautoscaler import (
        Behavior,
        CrossVersionObjectReference,
        ForecastSpec,
        HorizontalAutoscaler,
        HorizontalAutoscalerSpec,
        Metric,
        MetricTarget,
        PrometheusMetricSource,
    )
    from karpenter_tpu_torch.api.scalablenodegroup import (
        ScalableNodeGroup,
        ScalableNodeGroupSpec,
    )
    from karpenter_tpu_torch.autoscaler import BatchAutoscaler
    from karpenter_tpu_torch.forecast import FleetForecaster
    from karpenter_tpu_torch.metrics.clients import MetricsClientFactory
    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.solver import SolverService

    rng = np.random.RandomState(seed)
    noise = rng.normal(0.0, 0.01 * amplitude, size=ticks)

    def metric_at(tick: int) -> float:
        # the morning side of a diurnal wave: smooth cosine S-ramp from
        # base to base+amplitude, then plateau
        progress = min(max(tick - ramp_start, 0) / max(ramp_ticks, 1), 1.0)
        level = base + amplitude * 0.5 * (1.0 - _math.cos(_math.pi * progress))
        return max(0.0, level + float(noise[tick]))

    def replay(forecast_spec):
        from karpenter_tpu_torch.store import Store as _Store

        store = _Store()
        registry = GaugeRegistry()
        gauge = registry.register("queue", "length")
        store.create(
            ScalableNodeGroup(
                metadata=ObjectMeta(name="g"),
                spec=ScalableNodeGroupSpec(
                    replicas=1, type="FakeNodeGroup", id="g"
                ),
            )
        )
        store.create(
            HorizontalAutoscaler(
                metadata=ObjectMeta(name="ha"),
                spec=HorizontalAutoscalerSpec(
                    scale_target_ref=CrossVersionObjectReference(
                        kind="ScalableNodeGroup", name="g"
                    ),
                    min_replicas=1,
                    max_replicas=10_000,
                    metrics=[
                        Metric(
                            prometheus=PrometheusMetricSource(
                                query='karpenter_queue_length{name="q"}',
                                target=MetricTarget(
                                    type="AverageValue", value=target
                                ),
                            )
                        )
                    ],
                    behavior=Behavior(forecast=forecast_spec),
                ),
            )
        )
        clock = {"now": 1_000_000.0}
        service = SolverService(backend=backend, device=device)
        forecaster = (
            FleetForecaster(
                forecast_fn=service.forecast,
                clock=lambda: clock["now"],
                capacity=64,
            )
            if forecast_spec is not None
            else None
        )
        autoscaler = BatchAutoscaler(
            MetricsClientFactory(registry=registry),
            store,
            clock=lambda: clock["now"],
            decider=service.decide,
            forecaster=forecaster,
        )
        desired: List[int] = []
        try:
            for tick in range(ticks):
                gauge.set("q", "default", metric_at(tick))
                ha = store.get("HorizontalAutoscaler", "default", "ha")
                errors = autoscaler.reconcile_batch([ha])
                error = errors[("default", "ha")]
                if error is not None:
                    raise error
                store.patch_status(ha)
                desired.append(
                    store.get_scale(
                        "ScalableNodeGroup", "default", "g"
                    ).spec_replicas
                )
                clock["now"] += interval_s
        finally:
            service.close()
        dispatches = (
            service.stats.forecast_dispatches if forecaster else 0
        )
        return desired, dispatches

    spec = ForecastSpec(
        horizon_seconds=horizon_s, model=model, min_samples=min_samples
    )
    proactive, dispatches = replay(spec)
    reactive, _ = replay(None)

    peak = max(reactive)

    def first_at(seq, level):
        return next(
            (i for i, v in enumerate(seq) if v is not None and v >= level),
            None,
        )

    milestones = {}
    leads = []
    for pct in (25, 50, 75, 100):
        level = max(1, int(round(peak * pct / 100.0)))
        p, r = first_at(proactive, level), first_at(reactive, level)
        milestones[f"{pct}%"] = {
            "replicas": level,
            "proactive_tick": p,
            "reactive_tick": r,
            "lead_ticks": (r - p) if p is not None and r is not None else None,
        }
        if p is not None and r is not None:
            leads.append(r - p)
    mean_lead = (sum(leads) / len(leads)) if leads else 0.0
    return {
        "config": {
            "ticks": ticks,
            "interval_s": interval_s,
            "horizon_s": horizon_s,
            "model": model,
            "ramp": f"{base} -> {base + amplitude} over ticks "
                    f"[{ramp_start}, {ramp_start + ramp_ticks}]",
            "target": target,
            "seed": seed,
        },
        "proactive_desired": proactive,
        "reactive_desired": reactive,
        "milestones": milestones,
        "mean_lead_ticks": round(mean_lead, 2),
        "mean_lead_seconds": round(mean_lead * interval_s, 1),
        "fixed_point": {
            "proactive": proactive[-1],
            "reactive": reactive[-1],
            "identical": proactive[-1] == reactive[-1],
        },
        "forecast_dispatches": dispatches,
    }


# -- spot-reclaim storm replay (--simulate --preempt) -------------------------


def _storm_world(
    on_demand_nodes: int, spot_nodes: int, node_cpu: float,
    default_priority: int,
):
    """The pre-storm fleet: an on-demand pool and a spot pool, each with
    its own pendingCapacity producer + ScalableNodeGroup; spot nodes run
    priority-0 batch, on-demand nodes run priority-100 services beside
    some batch, everything ~75% utilized."""
    from karpenter_tpu_torch.api.core import (
        Container,
        Node,
        NodeCondition,
        NodeSpec,
        NodeStatus,
        ObjectMeta,
        Pod,
        PodSpec,
    )
    from karpenter_tpu_torch.api.metricsproducer import (
        MetricsProducer,
        MetricsProducerSpec,
        PendingCapacitySpec,
    )
    from karpenter_tpu_torch.api.scalablenodegroup import (
        ScalableNodeGroup,
        ScalableNodeGroupSpec,
    )
    from karpenter_tpu_torch.store import Store
    from karpenter_tpu_torch.utils.quantity import Quantity

    q = lambda v: Quantity.parse(str(v))  # noqa: E731

    def make_node(name, labels):
        return Node(
            metadata=ObjectMeta(name=name, labels=dict(labels)),
            spec=NodeSpec(),
            status=NodeStatus(
                allocatable={
                    "cpu": q(node_cpu),
                    "memory": q(f"{int(node_cpu * 2)}Gi"),
                    "pods": q(64),
                },
                conditions=[NodeCondition("Ready", "True")],
            ),
        )

    def make_pod(name, node_name, priority):
        return Pod(
            metadata=ObjectMeta(name=name),
            spec=PodSpec(
                node_name=node_name,
                priority=priority,
                containers=[
                    Container(
                        requests={"cpu": q(1), "memory": q("1Gi")}
                    )
                ],
            ),
        )

    store = Store()
    pools = {
        "od": ({"pool": "od"}, on_demand_nodes),
        "spot": (
            {"pool": "spot", "karpenter.sh/capacity-type": "spot"},
            spot_nodes,
        ),
    }
    per_node = max(2, int(node_cpu))  # fully-packed nodes: the storm
    # must CONTEND — free slack would let the bind pass absorb the
    # displaced services and the eviction path would never exercise
    for pool, (labels, count) in pools.items():
        store.create(
            MetricsProducer(
                metadata=ObjectMeta(name=pool),
                spec=MetricsProducerSpec(
                    pending_capacity=PendingCapacitySpec(
                        node_selector={"pool": pool},
                        node_group_ref=f"{pool}-group",
                    )
                ),
            )
        )
        store.create(
            ScalableNodeGroup(
                metadata=ObjectMeta(name=f"{pool}-group"),
                spec=ScalableNodeGroupSpec(
                    replicas=count, type="FakeNodeGroup",
                    id=f"{pool}-group",
                    preemptible=(pool == "spot"),
                ),
            )
        )
        for n in range(count):
            node_name = f"{pool}-{n:03d}"
            store.create(make_node(node_name, labels))
            for i in range(per_node):
                # on-demand nodes run mostly services (2/3) over batch;
                # spot nodes run a couple of cost-optimized services
                # (the pods the storm displaces and preemption rescues)
                # over batch
                if pool == "od":
                    is_service = i < (2 * per_node) // 3
                else:
                    is_service = i < 2
                priority = 100 if is_service else default_priority
                store.create(
                    make_pod(
                        f"{pool}-{n:03d}-p{i}", node_name, priority
                    )
                )
    return store, pools, make_node


def _reclaim_wave(store, spot_nodes: int, fraction: float, rng):
    """Seeded spot reclaim: the provider takes `fraction` of the spot
    pool; each taken node vanishes and its pods go pending (the
    workload controllers re-create them unbound)."""
    taken = sorted(
        rng.choice(
            spot_nodes,
            size=max(1, int(round(spot_nodes * fraction))),
            replace=False,
        )
    )
    displaced = 0
    for n in taken:
        name = f"spot-{int(n):03d}"
        for pod in store.pods_on_node(name):
            pod.spec.node_name = ""
            pod.status.phase = "Pending"
            store.update(pod)
            displaced += 1
        key = next(
            (k for k in store.keys("Node") if k[2] == name), None
        )
        if key is not None:
            store.delete(*key)
    return len(taken), displaced


def _node_takes(labels: dict, cap: dict, pod, needs: dict) -> bool:
    """One (pod, node) first-fit check: selector match + capacity."""
    selector = pod.spec.node_selector
    if selector and any(
        labels.get(k) != v for k, v in selector.items()
    ):
        return False
    return all(cap.get(r, 0.0) >= v for r, v in needs.items())


def _bind_state(store, default_priority: int):
    """(free capacity by node, labels by node, pending pods in
    priority-then-name order) — the deterministic inputs of one bind
    pass."""
    from karpenter_tpu_torch.api.core import effective_priority
    from karpenter_tpu_torch.consolidation.planner import cluster_view

    view = cluster_view(store)
    free = {
        nv.name: dict(nv.free) for nv in view.nodes if nv.receiver
    }
    labels = {
        nv.name: dict(nv.node.metadata.labels) for nv in view.nodes
    }
    pending = sorted(
        (p for p in store.list("Pod") if is_pending(p)),
        key=lambda p: (
            -effective_priority(p, default=default_priority),
            p.metadata.name,
        ),
    )
    return free, labels, pending


def _bind_pending(store, default_priority: int) -> int:
    """Toy first-fit scheduler pass: bind pending pods (highest
    priority first) onto pool-matching nodes with free capacity —
    deterministic, so the replay's recovery ticks are reproducible."""
    free, labels, pending = _bind_state(store, default_priority)
    bound = 0
    for pod in pending:
        needs = {
            r: quant.to_float()
            for r, quant in pod.effective_requests().items()
        }
        needs["pods"] = 1.0
        for name in sorted(free):
            if not _node_takes(labels[name], free[name], pod, needs):
                continue
            for r, v in needs.items():
                free[name][r] = free[name].get(r, 0.0) - v
            pod.spec.node_name = name
            pod.status.phase = "Running"
            store.update(pod)
            bound += 1
            break
    return bound


def simulate_preempt(  # lint: allow-complexity — scenario assembly: storm + replay loop + report
    on_demand_nodes: int = 4,
    spot_nodes: int = 8,
    node_cpu: float = 8.0,
    ticks: int = 24,
    interval_s: float = 10.0,
    reclaim_tick: int = 3,
    reclaim_fraction: float = 0.5,
    provision_lag: int = 4,
    preempt_budget: int = 8,
    default_priority: int = 0,
    seed: int = 0,
    backend: str = "torch",
    device=None,
) -> dict:
    """Seeded spot-reclaim-storm replay (docs/preemption.md
    "Dry-running"): a mixed on-demand/spot fleet loses a seeded
    fraction of its spot pool in one wave; displaced priority-100
    services and priority-0 batch go pending together. Each tick runs
    the REAL preemption engine (budgeted evictions through
    SolverService.preempt), a deterministic first-fit bind pass (the
    scheduler stand-in), and the pending-capacity scale-up signal with
    `provision_lag`-tick node arrivals — so the report shows the
    trade the subsystem exists for: services recover via eviction in
    ~1 tick while batch waits for provisioned capacity. Self-contained
    and mutation-free toward any real cluster (own in-memory store)."""
    from karpenter_tpu_torch.preemption import (
        PreemptionConfig,
        PreemptionEngine,
    )
    from karpenter_tpu_torch.solver import SolverService

    rng = np.random.RandomState(seed)
    store, pools, make_node = _storm_world(
        on_demand_nodes, spot_nodes, node_cpu, default_priority
    )
    clock = {"now": 1_000_000.0}
    service = SolverService(backend=backend, device=device)
    engine = PreemptionEngine(
        store,
        service,
        config=PreemptionConfig(
            plan_interval_s=0.0,
            budget_per_group=preempt_budget,
            hold_s=2 * interval_s,
            default_priority=default_priority,
            backend=backend,
        ),
        clock=lambda: clock["now"],
    )
    trail = []
    evictions_total = 0
    scale_ups_total = 0
    arrivals = []  # (due_tick, pool)
    reclaimed = displaced = 0
    service_recovery = full_recovery = None
    try:
        for tick in range(ticks):
            if tick == reclaim_tick:
                reclaimed, displaced = _reclaim_wave(
                    store, spot_nodes, reclaim_fraction, rng
                )
            for due, pool in [a for a in arrivals if a[0] == tick]:
                labels, _ = pools[pool]
                scale_ups_total += 1
                store.create(
                    make_node(f"{pool}-new-{tick:02d}-{scale_ups_total:03d}", labels)
                )
            arrivals = [a for a in arrivals if a[0] > tick]

            bound_before = {
                (p.metadata.namespace, p.metadata.name): p
                for p in store.list("Pod")
                if p.spec.node_name
            }
            plans = engine.plan(clock["now"])
            evicted_keys = [
                key
                for p in plans.values()
                if p
                for key in p["evictions"]
            ]
            evictions_total += len(evicted_keys)
            # the workload-controller analog: an evicted pod's owner
            # re-creates it unbound — it re-enters the pending set and
            # rides the ordinary bind/scale-up path
            import dataclasses as _dc

            for key in evicted_keys:
                old = bound_before[key]
                replacement = _dc.replace(old)
                replacement.metadata = _dc.replace(
                    old.metadata, name=f"{key[1]}-r{tick}",
                    resource_version="",
                )
                replacement.spec = _dc.replace(
                    old.spec, node_name=""
                )
                replacement.status = _dc.replace(
                    old.status, phase="Pending"
                )
                store.create(replacement)
            _bind_pending(store, default_priority)

            report = simulate(store, solver=service.solve)
            needed = {
                pool: report["groups"][f"default/{pool}"][
                    "additional_nodes_needed"
                ]
                for pool in pools
            }
            for pool, n in needed.items():
                outstanding = sum(1 for _, p in arrivals if p == pool)
                for _ in range(max(0, n - outstanding)):
                    arrivals.append((tick + provision_lag, pool))

            pending = [
                p for p in store.list("Pod") if is_pending(p)
            ]
            high = sum(
                1 for p in pending if (p.spec.priority or 0) > 0
            )
            if service_recovery is None and tick >= reclaim_tick and high == 0:
                service_recovery = tick
            if full_recovery is None and tick >= reclaim_tick and not pending:
                full_recovery = tick
            trail.append(
                {
                    "tick": tick,
                    "pending": len(pending),
                    "pending_high_priority": high,
                    "evictions": len(evicted_keys),
                    "scale_up_signal": dict(needed),
                }
            )
            clock["now"] += interval_s
    finally:
        service.close()
    return {
        "config": {
            "on_demand_nodes": on_demand_nodes,
            "spot_nodes": spot_nodes,
            "node_cpu": node_cpu,
            "reclaim": f"{reclaimed} spot nodes at tick {reclaim_tick} "
                       f"({displaced} pods displaced)",
            "provision_lag_ticks": provision_lag,
            "preempt_budget": preempt_budget,
            "seed": seed,
        },
        "ticks": trail,
        "evictions_total": evictions_total,
        "scale_ups_total": scale_ups_total,
        "service_recovery_tick": service_recovery,
        "full_recovery_tick": full_recovery,
        "recovery_ticks_after_reclaim": (
            None
            if full_recovery is None
            else full_recovery - reclaim_tick
        ),
        "preempt_dispatches": service.stats.preempt_dispatches,
    }


def simulate_restart_storm(  # lint: allow-complexity — scenario assembly: crash/reboot cycles + convergence + report
    nodes: int = 5,
    crashes: int = 3,
    seed: int = 0,
    journal_dir: Optional[str] = None,
    warmup_ticks: int = 1,
    device=None,
) -> dict:
    """Seeded restart-storm replay (docs/resilience.md "Crash
    recovery"): a consolidating fleet is repeatedly SIGKILLed
    mid-drain — alternating (seeded) between a kill after the replica
    decrement landed and a kill inside actuation before it — and
    rebooted from the protective-state journal each time. The report
    pins the crash-safety contract end to end: every completed drain
    actuated EXACTLY once across all incarnations (no duplicate cloud
    writes), restored nodes resumed their FSM phase instead of being
    re-cordoned, the fence generation climbed once per boot, and a
    stale-incarnation replay probe at the end was fence-rejected
    instead of applied. Self-contained: own in-memory store, fake
    provider, fake clock, and (by default) a temporary journal dir."""
    import contextlib
    import shutil
    import tempfile

    from karpenter_tpu_torch.api.core import (
        Container,
        Node,
        NodeCondition,
        NodeSpec,
        NodeStatus,
        ObjectMeta,
        Pod,
        PodSpec,
    )
    from karpenter_tpu_torch.api.metricsproducer import (
        MetricsProducer,
        MetricsProducerSpec,
        PendingCapacitySpec,
    )
    from karpenter_tpu_torch.api.scalablenodegroup import (
        ScalableNodeGroup,
        ScalableNodeGroupSpec,
    )
    from karpenter_tpu_torch.faults import (
        FaultRegistry,
        ProcessCrash,
        install,
        uninstall,
    )
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
    from karpenter_tpu_torch.store import Store
    from karpenter_tpu_torch.utils.quantity import Quantity

    rng = np.random.RandomState(seed)
    own_dir = journal_dir is None
    journal_dir = journal_dir or tempfile.mkdtemp(prefix="karpenter-storm-")

    q = Quantity.parse
    store = Store()
    provider = _recording_provider()
    provider.node_replicas["grp-id"] = nodes
    clock = {"now": 1_000_000.0}
    store.create(
        MetricsProducer(
            metadata=ObjectMeta(name="pc"),
            spec=MetricsProducerSpec(
                pending_capacity=PendingCapacitySpec(
                    node_selector={"pool": "a"}, node_group_ref="grp"
                )
            ),
        )
    )
    store.create(
        ScalableNodeGroup(
            metadata=ObjectMeta(name="grp"),
            spec=ScalableNodeGroupSpec(
                replicas=nodes, type="FakeNodeGroup", id="grp-id"
            ),
        )
    )
    for i in range(nodes):
        store.create(
            Node(
                metadata=ObjectMeta(name=f"n{i}", labels={"pool": "a"}),
                spec=NodeSpec(),
                status=NodeStatus(
                    allocatable={
                        "cpu": q("8"), "memory": q("16Gi"),
                        "pods": q("16"),
                    },
                    conditions=[NodeCondition("Ready", "True")],
                ),
            )
        )
    store.create(  # one bound pod anchors n0: only empty nodes drain
        Pod(
            metadata=ObjectMeta(name="p0"),
            spec=PodSpec(
                node_name="n0",
                containers=[Container(requests={"cpu": q("1")})],
            ),
        )
    )

    def boot():
        return KarpenterRuntime(
            Options(
                consolidate=True,
                journal_dir=journal_dir,
                recovery_warmup_ticks=warmup_ticks,
                device=device,
            ),
            store=store,
            cloud_provider_factory=provider,
            clock=lambda: clock["now"],
        )

    def kill(rt):  # SIGKILL analog: no graceful checkpoint
        rt.solver_service.close()
        rt.recovery.journal.close()

    def tick(rt, advance=61.0):
        clock["now"] += advance
        rt.manager._due = {k: 0.0 for k in rt.manager._due}
        rt.manager.reconcile_all()

    cordons_planned = 0  # across ALL incarnations (re-cordon detector)
    crash_sites = []
    rt = boot()
    try:
        for crash in range(crashes):
            engine = rt.consolidation
            engine.plan(clock["now"])  # first sight starts churn clocks
            clock["now"] += engine.config.cooldown_s + 1
            engine.plan(clock["now"])
            clock["now"] += engine.config.verify_s + 1
            site = rng.choice(["after-decrement", "mid-actuate"])
            crash_sites.append(str(site))
            if site == "mid-actuate":
                install(FaultRegistry(seed=seed + crash))
                from karpenter_tpu_torch.faults import active

                active().plan(
                    "process.crash.drain", mode="crash", times=1
                )
                try:
                    engine.plan(clock["now"])
                except ProcessCrash:
                    pass
                uninstall()
            else:
                engine.plan(clock["now"])  # decrement lands, then "die"
            cordons_planned += int(
                rt.registry.gauge(
                    "consolidation", "drains_planned_total"
                ).get("-", "-")
                or 0
            )
            kill(rt)
            rt = boot()
            # drain the FULL warm-up (however many ticks were asked
            # for) so the next cycle's planning is actually admitted
            for _ in range(max(1, warmup_ticks)):
                tick(rt)
            if site == "mid-actuate":
                # the decrement never landed: the restored DRAINING
                # entry times out and the node returns to service
                clock["now"] += rt.consolidation.config.drain_timeout_s + 1
            tick(rt)
        # run the final incarnation clean to convergence: every empty
        # node drains, only the pod's node remains
        for _ in range(8 * nodes):
            if provider.node_replicas["grp-id"] <= 1:
                break
            engine = rt.consolidation
            clock["now"] += engine.config.cooldown_s + 1
            engine.plan(clock["now"])
            clock["now"] += engine.config.verify_s + 1
            engine.plan(clock["now"])
            tick(rt)
        cordons_planned += int(
            rt.registry.gauge(
                "consolidation", "drains_planned_total"
            ).get("-", "-")
            or 0
        )

        drains_completed = nodes - provider.node_replicas["grp-id"]

        # stale-incarnation probe: a NEW incarnation boots (bumping the
        # fence) and actuates a fresh decision; then the prior
        # incarnation — now a split-brain zombie — replays a dead one.
        # The provider must fence-reject the stale stamp, not apply it.
        successor = boot()  # `rt` is now the stale incarnation
        fresh = store.get("ScalableNodeGroup", "default", "grp")
        fresh.spec.replicas = provider.node_replicas["grp-id"] + 1
        store.update(fresh)
        tick(successor)  # the successor's write records its generation
        replicas_after_successor = provider.node_replicas["grp-id"]
        stale_ctrl = rt.manager._controllers[1]
        probe = store.get("ScalableNodeGroup", "default", "grp")
        probe.spec.replicas = nodes  # a long-dead scale-up decision
        try:
            stale_ctrl.reconcile(probe)
        except Exception:  # noqa: BLE001 — the rejection surfaces as a
            pass  # reconcile failure; the provider state is the proof
        stale_applied = (
            provider.node_replicas["grp-id"] != replicas_after_successor
        )
        fence_generation = successor.recovery.fence.generation
        successor.close()
        return {
            "config": {
                "nodes": nodes,
                "crashes": crashes,
                "seed": seed,
                "warmup_ticks": warmup_ticks,
            },
            "crash_sites": crash_sites,
            "restarts": crashes + 1,
            "fence_generation": fence_generation,
            "fence_rejections": provider.fence_validator.rejections,
            "stale_replay_applied": stale_applied,
            "actuations": list(provider.writes),
            # a duplicate is the SAME (group, count) write landing again
            # with no other transition in between — a replayed decision,
            # not a later legitimate return to a previous size
            "duplicate_actuations": sum(
                1
                for a, b in zip(
                    provider.writes, provider.writes[1:]
                )
                if a == b
            ),
            "drains_completed": drains_completed,
            "cordons_planned": cordons_planned,
            "resumed_not_recordoned": cordons_planned == drains_completed
            + sum(1 for s in crash_sites if s == "mid-actuate"),
            "final_replicas": provider.node_replicas["grp-id"],
            "nodes_remaining": sorted(
                n.metadata.name for n in store.list("Node")
            ),
        }
    finally:
        with contextlib.suppress(Exception):
            rt.close()
        if own_dir:
            shutil.rmtree(journal_dir, ignore_errors=True)


def simulate_failover(  # lint: allow-complexity — scenario assembly: replica fleet + leader kill + handoff audit + report
    tenants: int = 16,
    replicas: int = 3,
    partitions: Optional[int] = None,
    ticks: int = 40,
    kill_tick: int = 12,
    seed: int = 0,
    lease_duration: float = 5.0,
    tick_s: float = 1.0,
    warmup_ticks: int = 1,
    journal_dir: Optional[str] = None,
) -> dict:
    """Seeded leader-kill failover replay (docs/resilience.md
    "Replicated control plane"): N tenants partitioned across R
    leader-elected replicas, each tenant's demand a seeded random walk,
    each owner journaling its scale intent and actuating through a
    fence-validated per-tenant cloud. Mid-storm the biggest owner (the
    "leader") is SIGKILLed via the `replica.crash.*` chaos point — no
    graceful release, its leases must expire. The report pins the
    failover contract end to end: survivors adopt the victim's
    partitions (fenced handoff: fence generation bump + journal replay
    + per-tenant warm-up), every tenant reconverges to the no-fault
    fixed point (demand is a pure function of the tick, so the
    no-fault state IS the desired trace), zero duplicate and zero lost
    `set_replicas` writes across the handoff (journal-audited), and
    the deposed replica's late write is fence-rejected — not applied.
    Self-contained: own store, scripted clock, temp journal root."""
    import contextlib
    import hashlib
    import json
    import shutil
    import tempfile

    from karpenter_tpu_torch.faults import (
        FaultRegistry,
        ProcessCrash,
        install,
        uninstall,
    )
    from karpenter_tpu_torch.recovery.fence import (
        FenceRejectedError,
        FenceValidator,
    )
    from karpenter_tpu_torch.replication import (
        ReplicatedControlPlane,
        crash_plan,
    )
    from karpenter_tpu_torch.store import Store

    partitions = partitions or max(4, 2 * replicas)
    rng = np.random.RandomState(seed)
    own_dir = journal_dir is None
    journal_root = journal_dir or tempfile.mkdtemp(
        prefix="karpenter-failover-"
    )

    tenant_ids = [f"t{i:03d}" for i in range(tenants)]
    replica_ids = [f"replica-{i}" for i in range(replicas)]
    # seeded per-tenant demand walk: desired[tenant][tick], the pure
    # function both arms (and the convergence check) share
    desired = {}
    for tenant in tenant_ids:
        level = int(rng.randint(1, 9))
        walk = []
        for _ in range(ticks + 1):
            if rng.rand() < 0.35:
                level = int(np.clip(level + rng.randint(-2, 3), 1, 12))
            walk.append(level)
        desired[tenant] = walk

    class _TenantCloud:
        """One tenant's provider edge: fence-validated writes, the
        exactly-once ledger the audit reads."""

        def __init__(self):
            self.validator = FenceValidator()
            self.replicas = 0
            self.writes = []

        def set_replicas(self, count, token=None):
            self.validator.admit(token)
            self.replicas = count
            self.writes.append(count)

    clouds = {tenant: _TenantCloud() for tenant in tenant_ids}
    clock = {"now": 1_000_000.0}

    def journal_dir_for(tenant):
        import os as _os

        path = _os.path.join(journal_root, "tenants", tenant)
        _os.makedirs(path, exist_ok=True)
        return path

    def build_plane(replica_id):
        return ReplicatedControlPlane(
            store,
            replica_id=replica_id,
            partitions=partitions,
            lease_duration=lease_duration,
            tenants_source=lambda: tenant_ids,
            journal_dir_for=journal_dir_for,
            validator_for=lambda tenant: clouds[tenant].validator,
            warmup_ticks=warmup_ticks,
            clock=lambda: clock["now"],
        )

    store = Store()
    planes = {rid: build_plane(rid) for rid in replica_ids}
    dead = set()
    registry = FaultRegistry(seed=seed)
    install(registry)

    def serve(plane, tick):
        """One replica's serving pass: journal intent, then actuate
        every owned tenant toward this tick's desired level. Reading
        the cloud before writing is the exactly-once seam: a handoff
        adopter skips writes its predecessor already landed."""
        for tenant in tenant_ids:
            handoff = plane.handoff_for(tenant)
            if handoff is None or handoff.released:
                continue
            want = desired[tenant][tick]
            cloud = clouds[tenant]
            if cloud.replicas == want:
                continue
            if handoff.recovery is not None:
                handoff.recovery.handle("intent").set(
                    (tenant,), {"desired": int(want)}
                )
            cloud.set_replicas(want, token=handoff.token())

    victim = None
    victim_partitions = []
    victim_tenants = []
    victim_handoffs = {}
    adoption_tick = {}  # tenant -> first tick a survivor adopted it
    recovered_tick = {}  # tenant -> first post-kill tick back at desired
    stale_probe = {"done": False, "rejected": False, "applied": False}
    fence_rejections = 0
    try:
        for tick in range(1, ticks + 1):
            clock["now"] += tick_s
            if tick == kill_tick:
                # the leader: the replica owning the most partitions
                victim = max(
                    (rid for rid in replica_ids if rid not in dead),
                    key=lambda rid: (
                        len(planes[rid].leases.owned), rid
                    ),
                )
                victim_partitions = sorted(planes[victim].leases.owned)
                victim_tenants = sorted(
                    t for t in tenant_ids if planes[victim].owns(t)
                )
                # retain the victim's handoffs: the zombie's stale
                # fence tokens are the late-write probe's ammunition
                victim_handoffs = dict(planes[victim].handoffs)
                crash_plan(registry, victim, times=1)
            for rid in replica_ids:
                if rid in dead:
                    continue
                try:
                    planes[rid].on_tick()
                except ProcessCrash:
                    dead.add(rid)  # SIGKILL: no release, no checkpoint
                    continue
                serve(planes[rid], tick)
                for tenant in victim_tenants:
                    if (
                        tenant not in adoption_tick
                        and planes[rid].handoff_for(tenant) is not None
                    ):
                        adoption_tick[tenant] = tick
            # blackout ends when a survivor has adopted the tenant AND
            # its cloud is back at this tick's desired level
            for tenant in victim_tenants:
                if (
                    tenant not in recovered_tick
                    and tenant in adoption_tick
                    and clouds[tenant].replicas == desired[tenant][tick]
                ):
                    recovered_tick[tenant] = tick
            # the deposed replica's in-flight write lands AFTER a
            # survivor claimed the tenant's fence generation: it must
            # be rejected, not applied
            if (
                victim_tenants
                and not stale_probe["done"]
                and victim_tenants[0] in adoption_tick
            ):
                stale_probe["done"] = True
                probe_tenant = victim_tenants[0]
                cloud = clouds[probe_tenant]
                before = cloud.replicas
                stale = victim_handoffs.get(probe_tenant)
                try:
                    cloud.set_replicas(
                        desired[probe_tenant][kill_tick],
                        token=stale.token() if stale else None,
                    )
                except FenceRejectedError:
                    stale_probe["rejected"] = True
                    if stale is not None and stale.recovery is not None:
                        stale.recovery.count_fence_rejection()
                stale_probe["applied"] = cloud.replicas != before

        # -- audits --------------------------------------------------------
        from karpenter_tpu_torch.recovery.journal import key_str

        fence_rejections = sum(
            cloud.validator.rejections for cloud in clouds.values()
        )
        converged = all(
            clouds[t].replicas == desired[t][ticks] for t in tenant_ids
        )
        # journal audit: every tenant's LAST journaled intent must have
        # landed exactly once — the live owner's replayed+mirrored table
        # IS what a successor would replay, so compare it to the cloud
        lost = 0
        for tenant in tenant_ids:
            owner = next(
                (
                    rid for rid in replica_ids
                    if rid not in dead
                    and planes[rid].handoff_for(tenant) is not None
                ),
                None,
            )
            if owner is None:
                lost += 1  # nobody serves this tenant: its writes stop
                continue
            recovery = planes[owner].handoffs[tenant].recovery
            if recovery is None:
                continue  # unfenced world: no journal to audit
            intent = recovery.table("intent").get(key_str((tenant,)))
            if intent is None:
                continue
            if clouds[tenant].replicas != intent["desired"]:
                lost += 1
        duplicates = sum(
            sum(1 for a, b in zip(c.writes, c.writes[1:]) if a == b)
            for c in clouds.values()
        )
        digest = hashlib.sha256(
            json.dumps(
                {t: clouds[t].writes for t in tenant_ids},
                sort_keys=True,
            ).encode()
        ).hexdigest()
        blackouts = sorted(
            recovered_tick.get(t, ticks) - kill_tick
            for t in victim_tenants
        ) or [0]
        p99_idx = max(0, int(np.ceil(0.99 * len(blackouts))) - 1)
        return {
            "config": {
                "tenants": tenants,
                "replicas": replicas,
                "partitions": partitions,
                "ticks": ticks,
                "kill_tick": kill_tick,
                "seed": seed,
                "lease_duration_s": lease_duration,
                "tick_s": tick_s,
                "warmup_ticks": warmup_ticks,
            },
            "victim": victim,
            "victim_partitions": victim_partitions,
            "victim_tenants": victim_tenants,
            "tenants_reassigned": sorted(adoption_tick),
            "adopters": {
                tenant: next(
                    (
                        rid for rid in replica_ids
                        if rid not in dead
                        and planes[rid].handoff_for(tenant) is not None
                    ),
                    None,
                )
                for tenant in sorted(adoption_tick)
            },
            "reconverge_ticks": (
                max(blackouts)
                if converged
                and len(recovered_tick) == len(victim_tenants)
                else None
            ),
            "converged": converged,
            "blackout_ticks_p99": blackouts[p99_idx],
            "blackout_s_p99": blackouts[p99_idx] * tick_s,
            "duplicate_actuations": duplicates,
            "lost_actuations": lost,
            "fence_rejections": fence_rejections,
            "stale_write_rejected": stale_probe["rejected"],
            "stale_write_applied": stale_probe["applied"],
            "handoffs_after_kill": len(adoption_tick),
            "fence_generations": {
                tenant: max(
                    (
                        planes[rid].handoffs[tenant].generation
                        for rid in replica_ids
                        if rid not in dead
                        and tenant in planes[rid].handoffs
                    ),
                    default=0,
                )
                for tenant in victim_tenants
            },
            "writes_digest": digest,
        }
    finally:
        uninstall(registry)
        for rid, plane in planes.items():
            with contextlib.suppress(Exception):
                if rid in dead:
                    # the zombie's open journals: close without the
                    # graceful release path (its successors own the
                    # fence now; close() would checkpoint over them)
                    for handoff in plane.handoffs.values():
                        if handoff.recovery is not None:
                            handoff.recovery.journal.close()
                else:
                    plane.close()
        if own_dir:
            shutil.rmtree(journal_root, ignore_errors=True)


def _why_report(ledger, sample: int = 8) -> dict:
    """The WHY column of a provenance-recording replay
    (docs/observability.md "Decision provenance"): stage totals over
    every recorded decision plus compact rows — the first record of
    each distinct winning stage and the last `sample` records — each
    answering "why did this group scale to N" in one line."""
    records = ledger.query()

    def row(index: int, record: dict) -> dict:
        return {
            "tick_record": index,
            "tenant": record["tenant"] or None,
            "group": record["group"],
            "why": record["winning_stage"],
            "desired": record["final_desired"],
            "base": record["base_desired"],
            "observed": record["observed"],
            "forecast": record["forecast_value"],
            "rung": record["solver_rung"] or None,
            "trace": record["trace"] or None,
        }

    by_stage: Dict[str, int] = {}
    firsts: Dict[str, dict] = {}
    for index, record in enumerate(records):
        stage = record["winning_stage"]
        by_stage[stage] = by_stage.get(stage, 0) + 1
        if stage not in firsts:
            firsts[stage] = row(index, record)
    tail = [
        row(len(records) - len(records[-sample:]) + i, record)
        for i, record in enumerate(records[-sample:])
    ]
    return {
        "records": len(records),
        "dropped": ledger.records_dropped,
        "by_stage": by_stage,
        "first_by_stage": firsts,
        "why": tail,
    }


# -- cost / warm-pool replay (--simulate --cost) ------------------------------


def _cost_world(
    warm_on: bool, initial: int, target: float, provision_lag: int,
    horizon_s: float, min_samples: int, violation_weight: float,
    max_hourly_cost: float, min_warm: int, max_warm: int, clock, backend,
    options=None, device=None,
):
    """One self-contained cost-replay world: a spot-tier node group
    behind a LAGGED provider (resizes ack immediately, PROVISIONED
    capacity trails scale-ups by `provision_lag` ticks — the lead time
    warm pools exist to hide), an SLO- and forecast-enabled autoscaler,
    and a full KarpenterRuntime so the warm target rides the real
    fenced SNG actuation path and the reconcile tracer's e2e histogram
    fills. Returns (runtime, provider, group_id)."""
    from karpenter_tpu_torch.api.core import ObjectMeta
    from karpenter_tpu_torch.api.horizontalautoscaler import (
        Behavior,
        CrossVersionObjectReference,
        ForecastSpec,
        HorizontalAutoscaler,
        HorizontalAutoscalerSpec,
        Metric,
        MetricTarget,
        PrometheusMetricSource,
        SLOSpec,
    )
    from karpenter_tpu_torch.api.scalablenodegroup import (
        ScalableNodeGroup,
        ScalableNodeGroupSpec,
        WarmPoolSpec,
    )
    from karpenter_tpu_torch.cloudprovider.fake import FakeFactory, FakeNodeGroup
    from karpenter_tpu_torch.cost import INSTANCE_TYPE_ANNOTATION
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
    from karpenter_tpu_torch.store import Store

    class _LaggedGroup(FakeNodeGroup):
        def set_replicas(self, count, token=None):
            super().set_replicas(count, token=token)
            f = self._factory
            f.writes.append((f.tick_now, self._id, count))
            have = f.provisioned.get(self._id, 0)
            # ANY write supersedes in-flight grows above its target —
            # including a shrink that still lands above provisioned
            # capacity, which must not leave a larger stale grow alive
            # to overshoot later
            f.pending = [
                p for p in f.pending
                if p[1] != self._id or p[2] <= count
            ]
            if count <= have:
                # shrinks release capacity immediately
                f.provisioned[self._id] = count
            else:
                f.pending.append((f.tick_now + f.lag, self._id, count))

    class _LaggedFactory(FakeFactory):
        def __init__(self, lag):
            super().__init__()
            self.lag = lag
            self.tick_now = 0
            self.provisioned = {}
            self.pending = []  # (due_tick, group_id, count)
            self.writes = []

        def node_group_for(self, spec):
            return _LaggedGroup(self, spec.id)

        def advance(self):
            self.tick_now += 1
            for due, gid, count in list(self.pending):
                if due <= self.tick_now:
                    self.provisioned[gid] = max(
                        self.provisioned.get(gid, 0), count
                    )
            self.pending = [
                p for p in self.pending if p[0] > self.tick_now
            ]

    gid = "cost-group"
    store = Store()
    provider = _LaggedFactory(provision_lag)
    provider.node_replicas[gid] = initial
    provider.provisioned[gid] = initial
    store.create(ScalableNodeGroup(
        metadata=ObjectMeta(
            name="grp",
            # spot-tier m5.xlarge pricing (cost/model.py): the replay's
            # spot-price step multiplies the model's spot multiplier
            annotations={INSTANCE_TYPE_ANNOTATION: "m5.xlarge"},
        ),
        spec=ScalableNodeGroupSpec(
            replicas=initial, type="FakeNodeGroup", id=gid,
            preemptible=True,
            warm_pool=(
                WarmPoolSpec(min_warm=min_warm, max_warm=max_warm)
                if warm_on
                else None
            ),
        ),
    ))
    store.create(HorizontalAutoscaler(
        metadata=ObjectMeta(name="ha"),
        spec=HorizontalAutoscalerSpec(
            scale_target_ref=CrossVersionObjectReference(
                kind="ScalableNodeGroup", name="grp"
            ),
            min_replicas=1,
            max_replicas=10_000,
            metrics=[Metric(prometheus=PrometheusMetricSource(
                query='karpenter_queue_length{name="q"}',
                target=MetricTarget(type="AverageValue", value=target),
            ))],
            behavior=Behavior(
                forecast=ForecastSpec(
                    horizon_seconds=horizon_s, model="linear",
                    min_samples=min_samples,
                ),
                slo=SLOSpec(
                    violation_cost_weight=violation_weight,
                    max_hourly_cost=max_hourly_cost,
                ),
            ),
        ),
    ))
    runtime = KarpenterRuntime(
        options if options is not None else Options(device=device),
        store=store, cloud_provider_factory=provider,
        clock=clock,
    )
    runtime.solver_service.backend = backend
    return runtime, provider, gid


def simulate_cost(  # lint: allow-complexity — scenario assembly: two replays + milestone/violation/e2e accounting
    ticks: int = 110,
    interval_s: float = 10.0,
    horizon_s: float = 60.0,
    target: float = 4.0,
    base: float = 8.0,
    amplitude: float = 120.0,
    ramp_start: int = 25,
    ramp_ticks: int = 20,
    spot_step_tick: int = 70,
    spot_step_factor: float = 3.0,
    provision_lag: int = 6,
    min_warm: int = 2,
    max_warm: int = 8,
    violation_weight: float = 50.0,
    max_hourly_cost: float = 0.0,
    min_samples: int = 4,
    seed: int = 0,
    backend: str = "torch",
    default_hourly: float = 1.0,
    spot_multiplier: float = 0.35,
    provenance: bool = False,
    device=None,
) -> dict:
    """Seeded cost/warm-pool replay (docs/cost.md "Dry-running"): the
    same scripted load — flat overnight base, a diurnal morning ramp,
    a mid-run SPOT-PRICE STEP (the model's spot multiplier jumps
    `spot_step_factor`x) — is driven through two otherwise-identical
    cost-aware worlds, warm pool ON vs OFF, behind a provider whose
    provisioned capacity trails accepted resizes by `provision_lag`
    ticks. The report quantifies the trade the subsystem exists for:
    the warm pool's extra hourly cost vs the PROVISIONING LEAD TIME it
    removes (capacity-coverage milestones) at equal-or-lower
    SLO-violation count, plus the karpenter_reconcile_e2e_seconds
    p50/p99 each world measured. Self-contained and mutation-free
    toward any real cluster (own stores, fake lagged provider).

    `provenance=True` additionally records the decision ledger
    (observability/provenance.py) through the warm-on world and renders
    the WHY column: per recorded tick, the winning stage (reactive /
    forecast_blend / cost_raise / cost_clamp / ...), the chosen count,
    and the solver rung — the operator-facing answer `/debug/decisions`
    serves on a live process."""
    import math as _math

    from karpenter_tpu_torch.observability import reset_default_tracer

    rng = np.random.RandomState(seed)
    noise = rng.normal(0.0, 0.01 * amplitude, size=ticks)

    def metric_at(tick: int) -> float:
        progress = min(
            max(tick - ramp_start, 0) / max(ramp_ticks, 1), 1.0
        )
        level = base + amplitude * 0.5 * (
            1.0 - _math.cos(_math.pi * progress)
        )
        return max(0.0, level + float(noise[tick]))

    initial = max(1, int(_math.ceil(base / target)))

    def replay(warm_on: bool) -> dict:
        from karpenter_tpu_torch.observability import reset_default_ledger
        from karpenter_tpu_torch.runtime import Options

        reset_default_tracer()
        # the WHY column rides the warm-on world only (one ledger, one
        # narrative); provenance=False never touches the ledger, so the
        # replay stays byte-identical to previous releases
        record_why = provenance and warm_on
        if provenance:
            reset_default_ledger(enabled=record_why)
        clock = {"now": 1_000_000.0}
        runtime, provider, gid = _cost_world(
            warm_on, initial, target, provision_lag, horizon_s,
            min_samples, violation_weight, max_hourly_cost,
            min_warm, max_warm, lambda: clock["now"], backend,
            options=Options(
                cost_default_hourly=default_hourly,
                cost_spot_multiplier=spot_multiplier,
                device=device,
            ),
        )
        gauge = runtime.registry.register("queue", "length")
        sng = runtime.store.get("ScalableNodeGroup", "default", "grp")
        provisioned_trail, hourly_trail = [], []
        violations = shortfall = 0
        try:
            for tick in range(ticks):
                if tick == spot_step_tick:
                    runtime.cost_model.spot_multiplier *= spot_step_factor
                demand = metric_at(tick)
                gauge.set("q", "default", demand)
                runtime.manager._due = {
                    k: 0.0 for k in runtime.manager._due
                }
                runtime.manager.reconcile_all()
                provider.advance()
                clock["now"] += interval_s
                have = provider.provisioned[gid]
                provisioned_trail.append(have)
                hourly_trail.append(
                    have * runtime.cost_model.unit_cost(sng)
                )
                if have * target < demand:
                    violations += 1
                    # replica-ticks of uncovered demand: a finer,
                    # deterministic lead measure than tick counts
                    shortfall += int(
                        _math.ceil(demand / target)
                    ) - have
            hist = runtime.registry.gauge("reconcile", "e2e_seconds")
            e2e = {
                "p50_s": hist.percentile("ScalableNodeGroup", "-", 50),
                "p99_s": hist.percentile("ScalableNodeGroup", "-", 99),
                "n": hist.count("ScalableNodeGroup", "-"),
            }
            stats = runtime.solver_service.stats
            report = {
                "provisioned": provisioned_trail,
                "mean_hourly_cost": round(
                    float(np.mean(hourly_trail)), 4
                ),
                "slo_violation_ticks": violations,
                "shortfall_replica_ticks": shortfall,
                "e2e_seconds": e2e,
                "cost_dispatches": stats.cost_dispatches,
                "provider_writes": len(provider.writes),
            }
            if record_why:
                report["provenance"] = _why_report(
                    runtime.decision_ledger
                )
            return report
        finally:
            runtime.close()

    # restore the process-default ledger even if a replay raises: an
    # ENABLED default leaking out would turn on provenance for a
    # co-resident runtime that never opted in (the multi-tenant
    # replay takes the same care)
    saved_ledger = None
    if provenance:
        from karpenter_tpu_torch.observability import (
            default_ledger,
            set_default_ledger,
        )

        saved_ledger = default_ledger()
    try:
        on = replay(True)
        off = replay(False)
    finally:
        if saved_ledger is not None:
            set_default_ledger(saved_ledger)

    # capacity-coverage milestones: how many ticks after demand reached
    # a level did PROVISIONED capacity cover it — the end-to-end
    # provisioning lead the warm pool attacks
    demand_trail = [metric_at(t) for t in range(ticks)]
    peak_needed = int(_math.ceil(max(demand_trail) / target))

    def coverage_lag(provisioned, pct: int):
        level = max(1, int(round(peak_needed * pct / 100.0)))
        demand_tick = next(
            (
                t for t, d in enumerate(demand_trail)
                if _math.ceil(d / target) >= level
            ),
            None,
        )
        cover_tick = next(
            (t for t, p in enumerate(provisioned) if p >= level), None
        )
        if demand_tick is None or cover_tick is None:
            return None
        return max(0, cover_tick - demand_tick)

    milestones, lags_on, lags_off = {}, [], []
    for pct in range(10, 101, 10):
        lag_on = coverage_lag(on["provisioned"], pct)
        lag_off = coverage_lag(off["provisioned"], pct)
        milestones[f"{pct}%"] = {
            "warm_on_lag_ticks": lag_on,
            "warm_off_lag_ticks": lag_off,
        }
        if lag_on is not None and lag_off is not None:
            lags_on.append(lag_on)
            lags_off.append(lag_off)
    mean_on = (sum(lags_on) / len(lags_on)) if lags_on else 0.0
    mean_off = (sum(lags_off) / len(lags_off)) if lags_off else 0.0
    return {
        "config": {
            "ticks": ticks,
            "interval_s": interval_s,
            "horizon_s": horizon_s,
            "target": target,
            "ramp": f"{base} -> {base + amplitude} over ticks "
                    f"[{ramp_start}, {ramp_start + ramp_ticks}]",
            "spot_step": f"x{spot_step_factor} at tick {spot_step_tick}",
            "provision_lag_ticks": provision_lag,
            "warm_pool": f"[{min_warm}, {max_warm}]",
            "violation_cost_weight": violation_weight,
            "max_hourly_cost": max_hourly_cost,
            "seed": seed,
        },
        "runs": {"warm_on": on, "warm_off": off},
        "hourly_cost": {
            "warm_on_mean": on["mean_hourly_cost"],
            "warm_off_mean": off["mean_hourly_cost"],
            "warm_premium": round(
                on["mean_hourly_cost"] - off["mean_hourly_cost"], 4
            ),
        },
        "slo_violations": {
            "warm_on": on["slo_violation_ticks"],
            "warm_off": off["slo_violation_ticks"],
            "warm_on_shortfall_replica_ticks": on[
                "shortfall_replica_ticks"
            ],
            "warm_off_shortfall_replica_ticks": off[
                "shortfall_replica_ticks"
            ],
        },
        "provisioning_lead": {
            "milestones": milestones,
            "warm_on_mean_lag_ticks": round(mean_on, 2),
            "warm_off_mean_lag_ticks": round(mean_off, 2),
            "reduction_ticks": round(mean_off - mean_on, 2),
            "reduction_seconds": round(
                (mean_off - mean_on) * interval_s, 1
            ),
        },
        "e2e_seconds": {
            "warm_on": on["e2e_seconds"],
            "warm_off": off["e2e_seconds"],
        },
    }


def _poolgroup_world(grouped: bool, target: float, budget: float, clock,
                     backend: str, device=None):
    """One self-contained disaggregated-serving world: a prefill pool
    and a decode pool (two SNG/HA pairs), one PoolGroup declaring the
    decode:prefill ratio band [2:1, 4:1] and a shared hourly budget,
    behind a full KarpenterRuntime. `grouped` toggles --poolgroups; the
    PoolGroup object is created either way, so the uncoordinated arm is
    the exact byte-identical ungrouped plane ignoring it. Returns
    (runtime, ratio) where ratio is the declared band for the caller's
    violation accounting."""
    from karpenter_tpu_torch.api.core import ObjectMeta
    from karpenter_tpu_torch.api.horizontalautoscaler import (
        Behavior,
        CrossVersionObjectReference,
        HorizontalAutoscaler,
        HorizontalAutoscalerSpec,
        Metric,
        MetricTarget,
        PrometheusMetricSource,
        SLOSpec,
    )
    from karpenter_tpu_torch.api.poolgroup import (
        PoolGroup,
        PoolGroupSpec,
        PoolMember,
        RatioConstraint,
    )
    from karpenter_tpu_torch.api.scalablenodegroup import (
        ScalableNodeGroup,
        ScalableNodeGroupSpec,
    )
    from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
    from karpenter_tpu_torch.store import Store

    store = Store()
    provider = FakeFactory()
    for name, queue, initial in (("prefill", "qp", 10), ("decode", "qd", 20)):
        gid = f"g-{name}"
        provider.node_replicas[gid] = initial
        store.create(ScalableNodeGroup(
            metadata=ObjectMeta(name=gid),
            spec=ScalableNodeGroupSpec(
                replicas=initial, type="FakeNodeGroup", id=gid,
            ),
        ))
        store.create(HorizontalAutoscaler(
            metadata=ObjectMeta(name=name),
            spec=HorizontalAutoscalerSpec(
                scale_target_ref=CrossVersionObjectReference(
                    kind="ScalableNodeGroup", name=gid
                ),
                min_replicas=1,
                max_replicas=10_000,
                metrics=[Metric(prometheus=PrometheusMetricSource(
                    query=f'karpenter_queue_length{{name="{queue}"}}',
                    target=MetricTarget(type="AverageValue", value=target),
                ))],
                behavior=Behavior(slo=SLOSpec(violation_cost_weight=100.0)),
            ),
        ))
    ratio = RatioConstraint(
        numerator="decode", denominator="prefill",
        min_numerator=2, min_denominator=1,
        max_numerator=4, max_denominator=1,
    )
    store.create(PoolGroup(
        metadata=ObjectMeta(name="serving"),
        spec=PoolGroupSpec(
            pools=[
                PoolMember(name="prefill", role="prefill"),
                PoolMember(name="decode", role="decode"),
            ],
            ratios=[ratio],
            max_hourly_cost=budget,
        ),
    ))
    runtime = KarpenterRuntime(
        Options(poolgroups=grouped, device=device),
        store=store, cloud_provider_factory=provider, clock=clock,
    )
    runtime.solver_service.backend = backend
    return runtime, ratio


def simulate_poolgroups(  # lint: allow-complexity — scenario assembly: two replays + band/budget accounting
    ticks: int = 60,
    interval_s: float = 10.0,
    target: float = 4.0,
    prefill_queue: float = 40.0,
    decode_base: float = 80.0,
    decode_peak: float = 240.0,
    ramp_start: int = 15,
    ramp_ticks: int = 20,
    budget: float = 90.0,
    seed: int = 0,
    backend: str = "torch",
    device=None,
) -> dict:
    """Seeded traffic-mix-shift replay (docs/poolgroups.md): the same
    scripted DECODE-HEAVY STORM — prefill demand flat, decode demand
    ramping 3x over `ramp_ticks` ticks, the disaggregated-serving mix
    shift "Taming the Chaos" studies — is driven through two otherwise
    identical prefill/decode worlds, --poolgroups ON vs OFF. The
    declared coupling is a decode:prefill ratio band [2:1, 4:1] plus a
    shared hourly budget: the coordinated arm's joint allocator
    rebalances pool-to-pool (raising prefill beyond what its own flat
    queue asks, because decode's storm pulls the ratio toward the upper
    bound) and must HOLD the band through the storm under the cap; the
    uncoordinated arm scales each pool from its own queue alone and
    violates the band for the storm's whole plateau. Violations are
    counted by exact integer cross-multiplication on the actuated
    per-tick replica counts — the same arithmetic the joint kernel
    enforces on device. Self-contained and mutation-free toward any
    real cluster (own stores, fake provider); the storm's per-tick
    drift stays inside the joint candidate ladder's reach, so the
    coordinated arm repairs within the tick the drift lands."""
    import math as _math

    rng = np.random.RandomState(seed)
    noise_p = rng.normal(0.0, 0.25, size=ticks)
    noise_d = rng.normal(0.0, 0.25, size=ticks)

    def queues_at(tick: int):
        progress = min(
            max(tick - ramp_start, 0) / max(ramp_ticks, 1), 1.0
        )
        qd = decode_base + (decode_peak - decode_base) * 0.5 * (
            1.0 - _math.cos(_math.pi * progress)
        )
        return (
            max(0.0, prefill_queue + float(noise_p[tick])),
            max(0.0, qd + float(noise_d[tick])),
        )

    def replay(grouped: bool) -> dict:
        clock = {"now": 1_000_000.0}
        runtime, ratio = _poolgroup_world(
            grouped, target, budget, lambda: clock["now"], backend, device
        )
        gauge = runtime.registry.register("queue", "length")
        trail_p, trail_d, spend_trail = [], [], []
        violations = coordinated_ticks = 0
        try:
            for tick in range(ticks):
                qp, qd = queues_at(tick)
                gauge.set("qp", "default", qp)
                gauge.set("qd", "default", qd)
                runtime.manager._due = {
                    k: 0.0 for k in runtime.manager._due
                }
                runtime.manager.reconcile_all()
                clock["now"] += interval_s
                p = runtime.store.get_scale(
                    "ScalableNodeGroup", "default", "g-prefill"
                ).spec_replicas
                d = runtime.store.get_scale(
                    "ScalableNodeGroup", "default", "g-decode"
                ).spec_replicas
                trail_p.append(p)
                trail_d.append(d)
                # exact integer band check, the kernel's arithmetic:
                # min_num*p <= d*min_den and d*max_den <= max_num*p
                if (
                    d * ratio.min_denominator
                    < ratio.min_numerator * p
                    or d * ratio.max_denominator
                    > ratio.max_numerator * p
                ):
                    violations += 1
                spend_trail.append(float(p + d))  # default $1/replica-hour
                group = runtime.store.get(
                    "PoolGroup", "default", "serving"
                )
                if group.status.coordinated:
                    coordinated_ticks += 1
            stats = runtime.solver_service.stats
            return {
                "prefill": trail_p,
                "decode": trail_d,
                "ratio_violation_ticks": violations,
                "coordinated_ticks": coordinated_ticks,
                "max_hourly_spend": round(max(spend_trail), 2),
                "mean_hourly_spend": round(
                    float(np.mean(spend_trail)), 2
                ),
                "poolgroup_dispatches": stats.poolgroup_dispatches,
                "cost_dispatches": stats.cost_dispatches,
            }
        finally:
            runtime.close()

    on = replay(True)
    off = replay(False)
    return {
        "config": {
            "ticks": ticks,
            "interval_s": interval_s,
            "target": target,
            "prefill_queue": prefill_queue,
            "decode_storm": f"{decode_base} -> {decode_peak} over ticks "
                            f"[{ramp_start}, {ramp_start + ramp_ticks}]",
            "ratio_band": "2:1 <= decode:prefill <= 4:1",
            "max_hourly_cost": budget,
            "seed": seed,
        },
        "runs": {"coordinated": on, "uncoordinated": off},
        "band": {
            "coordinated_violation_ticks": on["ratio_violation_ticks"],
            "uncoordinated_violation_ticks": off[
                "ratio_violation_ticks"
            ],
            "held_through_storm": on["ratio_violation_ticks"] == 0,
        },
        "budget": {
            "declared_hourly": budget,
            "coordinated_max_spend": on["max_hourly_spend"],
            "under_cap": on["max_hourly_spend"] <= budget,
        },
        "dispatch_collapse": {
            # grouped rows leave the per-pool cost ladder and ride ONE
            # joint dispatch per tick (the acceptance criterion's
            # karpenter_solver_dispatches_per_tick collapse)
            "coordinated_poolgroup_dispatches": on[
                "poolgroup_dispatches"
            ],
            "coordinated_cost_dispatches": on["cost_dispatches"],
            "uncoordinated_cost_dispatches": off["cost_dispatches"],
        },
    }


def simulate_delta(
    store, what_if_groups: List[dict], solver=None,
    template_resolver=None, cost_model=None,
) -> dict:
    """Baseline solve vs what-if solve, with the per-group delta: the
    operator's 'what would adding node group X change?'."""
    baseline = simulate(
        store, solver=solver, template_resolver=template_resolver,
        cost_model=cost_model,
    )
    with_groups = simulate(
        store, what_if_groups, solver=solver,
        template_resolver=template_resolver, cost_model=cost_model,
    )
    delta = {}
    for name, after in with_groups["groups"].items():
        before = baseline["groups"].get(
            name,
            {"pending_pods": 0, "additional_nodes_needed": 0},
        )
        delta[name] = {
            "pending_pods": after["pending_pods"]
            - before["pending_pods"],
            "additional_nodes_needed": after["additional_nodes_needed"]
            - before["additional_nodes_needed"],
        }
    return {
        "baseline": baseline,
        "what_if": with_groups,
        "delta": {
            "groups": delta,
            "unschedulable_pods": with_groups["unschedulable_pods"]
            - baseline["unschedulable_pods"],
        },
    }


# -- constraint-plane replay (docs/constraints.md) ---------------------------


def simulate_constraints(  # lint: allow-complexity — scenario assembly: world build + outage replay + before/after report
    ticks: int = 3,
    zones: int = 3,
    nodes_per_zone: int = 2,
    web_pods: int = 6,
    gold_pods: int = 2,
    plain_pods: int = 4,
    seed: int = 7,
    device=None,
) -> dict:
    """The --simulate --constraints replay (docs/constraints.md): a
    spread-constrained serving fleet with a gold reservation, driven
    through the REAL producer/encoder/solver path, then hit with a
    seeded zonal outage. The report shows per-group spread skew and
    reservation fill BEFORE and AFTER the outage — the constrained
    re-solve must rebalance onto the surviving zones without dropping
    the reservation fence — plus deterministic per-phase digests the
    acceptance test pins (tests/test_simulate.py).

    Nothing here touches a live store or provider: the world is
    self-contained (fake provider, scripted clock)."""
    from karpenter_tpu_torch.api.core import (
        Container, Node, NodeCondition, NodeSpec, NodeStatus,
        ObjectMeta, Pod, PodSpec, RESERVATION_LABEL, ZONE_LABEL,
        resource_list,
    )
    from karpenter_tpu_torch.api.metricsproducer import (
        MetricsProducer, MetricsProducerSpec, PendingCapacitySpec,
    )
    from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
    from karpenter_tpu_torch.constraints import ConstraintGroup, SpreadSpec
    from karpenter_tpu_torch.metrics.producers.pendingcapacity import (
        CONSTRAINTS_SUBSYSTEM, RESERVATION_FILL, SPREAD_SKEW,
    )
    from karpenter_tpu_torch.metrics.producers.pendingcapacity import (
        encoder as _pc_encoder,
    )
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options

    rng = np.random.default_rng(seed)
    _pc_encoder.reset_constraint_state()
    clock = {"now": 1_000_000.0}
    runtime = KarpenterRuntime(
        Options(device=device),
        cloud_provider_factory=FakeFactory(),
        clock=lambda: clock["now"],
    )
    store = runtime.store
    zone_names = [f"z{i + 1}" for i in range(zones)]
    for z, zone in enumerate(zone_names):
        for i in range(nodes_per_zone):
            store.create(Node(
                metadata=ObjectMeta(
                    name=f"{zone}-n{i}",
                    labels={"pool": "serving", ZONE_LABEL: zone},
                ),
                spec=NodeSpec(),
                status=NodeStatus(
                    allocatable=resource_list(
                        cpu="8", memory="32Gi", pods="32"
                    ),
                    conditions=[NodeCondition("Ready", "True")],
                ),
            ))
    store.create(Node(
        metadata=ObjectMeta(
            name="reserved-0",
            labels={"pool": "reserved", RESERVATION_LABEL: "gold"},
        ),
        spec=NodeSpec(),
        status=NodeStatus(
            allocatable=resource_list(cpu="8", memory="32Gi", pods="32"),
            conditions=[NodeCondition("Ready", "True")],
        ),
    ))
    # one producer per zone plus the reserved pool — the group axis.
    # A single producer spanning zones would profile as the label
    # INTERSECTION of its nodes (encoder._group_profile) and lose the
    # zone domain the spread constraint needs, exactly like real node
    # groups that are zonal by construction. The constraint groups ride
    # the first producer; solve_pending merges them across the axis.
    constraints = [
        ConstraintGroup(
            name="web", pod_selector={"app": "web"}, spread=SpreadSpec()
        ),
        ConstraintGroup(
            name="gold", pod_selector={"tier": "gold"},
            reservation="gold",
        ),
    ]
    for z, zone in enumerate(zone_names):
        store.create(MetricsProducer(
            metadata=ObjectMeta(name=f"serving-{zone}"),
            spec=MetricsProducerSpec(
                pending_capacity=PendingCapacitySpec(
                    node_selector={
                        "pool": "serving", ZONE_LABEL: zone
                    },
                    constraints=constraints if z == 0 else [],
                )
            ),
        ))
    store.create(MetricsProducer(
        metadata=ObjectMeta(name="serving-reserved"),
        spec=MetricsProducerSpec(
            pending_capacity=PendingCapacitySpec(
                node_selector={"pool": "reserved"},
            )
        ),
    ))
    specs = (
        [("web", {"app": "web"})] * web_pods
        + [("gold", {"tier": "gold"})] * gold_pods
        + [("plain", {})] * plain_pods
    )
    for i, (kind, labels) in enumerate(specs):
        store.create(Pod(
            metadata=ObjectMeta(name=f"{kind}-{i}", labels=dict(labels)),
            spec=PodSpec(
                node_name="",
                containers=[Container(requests=resource_list(
                    cpu=str(int(rng.integers(1, 3))), memory="1Gi",
                ))],
            ),
        ))

    def _phase() -> dict:
        skew = {}
        fill = {}
        for sub, name, metric in (
            (CONSTRAINTS_SUBSYSTEM, SPREAD_SKEW, skew),
            (CONSTRAINTS_SUBSYSTEM, RESERVATION_FILL, fill),
        ):
            # register() returns the existing vec (or an empty one if
            # the solve never published — gauge() would KeyError)
            vec = runtime.registry.register(sub, name)
            for sample in vec.samples():
                metric[sample.labels["name"]] = sample.value
        groups = {}
        unschedulable = -1
        for mp in store.list("MetricsProducer", "default"):
            status = mp.status.pending_capacity
            if status is None:
                continue
            groups[mp.metadata.name] = {
                "pending_pods": status.pending_pods,
                "nodes_needed": status.additional_nodes_needed,
            }
            unschedulable = status.unschedulable_pods
        return {
            "spread_skew": skew,
            "reservation_fill": fill,
            "groups": groups,
            "unschedulable": unschedulable,
        }

    def _digest(phase: dict) -> int:
        # zlib.crc32 over canonical JSON, NOT hash(): str hashing is
        # salted per process and the acceptance test pins these values
        import json
        import zlib

        return zlib.crc32(
            json.dumps(phase, sort_keys=True).encode()
        )

    try:
        for _ in range(ticks):
            clock["now"] += 10.0
            runtime.manager.converge(1)
        before = _phase()
        # the seeded zonal outage: one zone's nodes disappear — its
        # zone drops out of the spread domain universe and the
        # constrained re-solve must rebalance the quotas over the
        # survivors (NotReady alone wouldn't do it: an all-NotReady
        # group still profiles via the scaled-to-zero fallback)
        dead_zone = zone_names[int(rng.integers(0, zones))]
        for i in range(nodes_per_zone):
            store.delete("Node", "default", f"{dead_zone}-n{i}")
        for _ in range(ticks):
            clock["now"] += 10.0
            runtime.manager.converge(1)
        after = _phase()
        stats = dict(_pc_encoder.constraint_stats)
    finally:
        runtime.close()

    return {
        "config": {
            "ticks": ticks, "zones": zones,
            "nodes_per_zone": nodes_per_zone, "web_pods": web_pods,
            "gold_pods": gold_pods, "plain_pods": plain_pods,
            "seed": seed,
        },
        "dead_zone": dead_zone,
        "before": before,
        "after": after,
        "digests": {
            "before": _digest(before),
            "after": _digest(after),
        },
        "constraint_health": {
            "compiles": stats["compiles"],
            "fallbacks": stats["fallbacks"],
            "degraded": stats["degraded"],
        },
    }


# -- multi-tenant lockstep replay (docs/multitenancy.md) ---------------------


def multitenant_fleet_inputs(
    tenant: int,
    rows: int,
    metrics: int,
    seed: int,
    tick: int,
    spec_replicas: np.ndarray,
    now: float,
):
    """One tenant cluster's DecisionInputs for one lockstep tick:
    AverageValue metrics riding a seeded diurnal ramp whose phase and
    amplitude differ per tenant (tenant fleets are NOT in phase — the
    fairness and batching machinery must handle skewed demand), with
    the previous tick's desired fed back as spec/status replicas.
    Deterministic in (tenant, tick, seed); shared with `bench.py
    --multitenant` so the bench times exactly the matrices the
    simulator steps."""
    import math as _math

    from karpenter_tpu_torch.ops import decision as D

    rng = np.random.RandomState(seed * 100_003 + tenant * 1_009 + tick)
    phase = (tenant % 7) / 7.0 * 2.0 * _math.pi
    level = 40.0 + 30.0 * _math.sin(tick / 12.0 * 2.0 * _math.pi + phase)
    values = np.maximum(
        0.0, level + rng.normal(0.0, 2.0, (rows, metrics))
    ).astype(np.float32)
    spec = np.asarray(spec_replicas, np.int32)
    return D.DecisionInputs(
        metric_value=values,
        target_value=np.full((rows, metrics), 4.0, np.float32),
        target_type=np.full(
            (rows, metrics), D.TYPE_AVERAGE_VALUE, np.int32
        ),
        metric_valid=np.ones((rows, metrics), bool),
        spec_replicas=spec,
        status_replicas=spec.copy(),
        min_replicas=np.ones(rows, np.int32),
        max_replicas=np.full(rows, 10_000, np.int32),
        up_window=np.zeros(rows, np.int32),
        down_window=np.zeros(rows, np.int32),
        up_policy=np.full(rows, D.POLICY_MAX, np.int32),
        down_policy=np.full(rows, D.POLICY_MAX, np.int32),
        last_scale_time=np.zeros(rows, np.float32),
        has_last_scale=np.zeros(rows, bool),
        now=np.float32(now),
        up_ptype=np.zeros((rows, 1), np.int32),
        up_pvalue=np.zeros((rows, 1), np.int32),
        up_pperiod=np.ones((rows, 1), np.int32),
        up_pvalid=np.zeros((rows, 1), bool),
        down_ptype=np.zeros((rows, 1), np.int32),
        down_pvalue=np.zeros((rows, 1), np.int32),
        down_pperiod=np.ones((rows, 1), np.int32),
        down_pvalid=np.zeros((rows, 1), bool),
    )


def multitenant_cost_inputs(decide_inputs, desired: np.ndarray):
    """The tenant's CostInputs for the same tick: every row SLO-opted,
    demand = the observed metric values, a per-row unit-cost spread so
    the budget/risk trade is live. Deterministic companion of
    multitenant_fleet_inputs."""
    from karpenter_tpu_torch.ops.cost import CostInputs

    rows = int(np.asarray(desired).shape[0])
    values = np.asarray(decide_inputs.metric_value, np.float32)
    unit = np.asarray(
        [0.19 + 0.27 * (i % 4) for i in range(rows)], np.float32
    )
    return CostInputs(
        base_desired=np.asarray(desired, np.int32),
        min_replicas=np.asarray(decide_inputs.min_replicas, np.int32),
        max_replicas=np.asarray(decide_inputs.max_replicas, np.int32),
        unit_cost=unit,
        slo_weight=np.full(rows, 50.0, np.float32),
        max_hourly_cost=np.zeros(rows, np.float32),
        slo_valid=np.ones(rows, bool),
        slo_target=np.asarray(decide_inputs.target_value, np.float32),
        demand_mu=values,
        demand_sigma=np.full(values.shape, 1.5, np.float32),
        demand_valid=np.ones(values.shape, bool),
    )


def simulate_multitenant(  # lint: allow-complexity — scenario assembly: lockstep replay + provenance/trace exports + report
    tenants: int = 16,
    ticks: int = 12,
    rows: int = 4,
    metrics: int = 2,
    seed: int = 0,
    backend: str = "auto",
    tenant_config: Optional[str] = None,
    provenance: bool = False,
    trace_export: Optional[str] = None,
    device=None,
) -> dict:
    """Step N seeded tenant clusters in LOCKSTEP through one
    MultiTenantScheduler (docs/multitenancy.md): every tick, all
    tenants' fleet matrices concatenate into shared decide + cost
    dispatches, the refined desired feeds back as the next tick's
    replicas, and the report quantifies the amortization — actual
    shared dispatches vs the 2-per-tenant-per-tick a sequential loop
    would pay — plus deterministic aggregate-replica digests the
    regression tests pin. Self-contained: no store, no provider.

    `provenance=True` records the decision ledger through the replay
    and adds the per-tenant WHY view (winning stage, cost ladder,
    solver rung, admission round) for a pinned mid-run tick — the
    `--simulate --cost --multitenant --provenance` acceptance surface.
    `trace_export=FILE` additionally mints one reconcile trace per tick
    (so ledger records carry trace-id backlinks), exporting the trace
    JSONL to FILE and the decision JSONL next to it
    (provenance.decisions_export_path).

    The port's `backend` default "auto" is the service's default rung:
    the tensor programs on the card (the reference's "xla"), the numpy
    mirrors on the CPU; `device` is where the shared service runs (the
    card by default). On the card the scheduler holds the card rule
    (tenancy/scheduler.py): `mirror_served` stays 0."""
    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.observability import (
        default_ledger,
        default_tracer,
        reset_default_ledger,
        reset_default_tracer,
        set_default_ledger,
    )
    from karpenter_tpu_torch.solver import SolverService
    from karpenter_tpu_torch.tenancy import (
        MultiTenantScheduler,
        TenantRegistry,
        TenantSpec,
        load_tenant_config,
    )

    if tenant_config:
        specs = load_tenant_config(tenant_config)
        tenants = len(specs)
    else:
        specs = [
            TenantSpec(id=f"t{i:04d}", weight=1.0 + (i % 3))
            for i in range(tenants)
        ]
    # the replay records into its OWN ledger and restores the process
    # default afterwards: an enabled default leaking out would turn on
    # provenance for a co-resident runtime that never opted in
    saved_ledger = None
    ledger = None
    if provenance:
        saved_ledger = default_ledger()
        ledger = reset_default_ledger(enabled=True)
    if trace_export:
        reset_default_tracer()
    service = SolverService(
        backend=backend, registry=GaugeRegistry(), device=device
    )
    registry = TenantRegistry(
        service=service, registry=GaugeRegistry(), specs=specs
    )
    scheduler = MultiTenantScheduler(registry, service)
    replicas = {
        spec.id: np.full(rows, 2, np.int32) for spec in specs
    }
    digests = {}
    pinned_tick = ticks // 2
    pinned_records: List[dict] = []
    try:
        for tick in range(ticks):
            now = 1_000_000.0 + tick * 10.0
            batch = {
                spec.id: multitenant_fleet_inputs(
                    i, rows, metrics, seed, tick, replicas[spec.id], now
                )
                for i, spec in enumerate(specs)
            }
            with default_tracer().trace(
                "simulate.multitenant.tick", tick=tick
            ):
                decided = scheduler.decide_all(batch)
                cost_batch = {
                    tid: multitenant_cost_inputs(
                        batch[tid], decided[tid].desired
                    )
                    for tid in decided
                }
                refined = scheduler.cost_all(cost_batch, backend=backend)
            for tid in refined:
                replicas[tid] = np.asarray(refined[tid].desired, np.int32)
            if tick in (0, ticks // 2, ticks - 1):
                digests[f"tick_{tick}"] = int(
                    sum(int(r.sum()) for r in replicas.values())
                )
            if ledger is not None and tick == pinned_tick:
                # the tick's records are exactly the newest commit
                pinned_records = ledger.query(kind="tenant")[
                    -(len(refined) * rows):
                ]
    finally:
        service.close()
        if saved_ledger is not None:
            set_default_ledger(saved_ledger)
    stats = scheduler.stats
    shared = stats.decide_dispatches + stats.cost_dispatches
    isolated = stats.isolated_dispatches
    sequential_equiv = tenants * ticks * 2
    report = {
        "tenants": tenants,
        "ticks": ticks,
        "rows_per_tenant": rows,
        "metrics_per_row": metrics,
        "decisions": stats.decide_rows,
        "decide_dispatches": stats.decide_dispatches,
        "cost_dispatches": stats.cost_dispatches,
        "isolated_dispatches": isolated,
        "admission_rounds": stats.admission_rounds,
        "mirror_served": stats.mirror_served,
        "fallback_served": stats.fallback_served,
        "sequential_equivalent_dispatches": sequential_equiv,
        "dispatch_amortization": round(
            sequential_equiv / max(shared + isolated, 1), 1
        ),
        "aggregate_replicas": digests,
        "solver": {
            "requests": service.stats.requests,
            "dispatches": service.stats.dispatches,
        },
    }
    if ledger is not None:
        why = _why_report(ledger)
        why["pinned_tick"] = pinned_tick
        why["pinned"] = [
            {
                "tenant": r["tenant"],
                "row": r["name"],
                "why": r["winning_stage"],
                "desired": r["final_desired"],
                "base": r["base_desired"],
                "risk": r["cost_risk"],
                "hourly": r["cost_hourly"],
                "rung": r["solver_rung"] or None,
                "admission_round": r["admission_round"],
                "trace": r["trace"] or None,
            }
            for r in pinned_records
        ]
        report["provenance"] = why
    if trace_export:
        report["trace_export"] = trace_export
        report["trace_events"] = default_tracer().export_jsonl(
            trace_export
        )
        if ledger is not None:
            from karpenter_tpu_torch.observability.provenance import (
                export_next_to_trace,
            )

            path, count = export_next_to_trace(ledger, trace_export)
            report["decisions_export"] = path
            report["decision_records"] = count
    return report
