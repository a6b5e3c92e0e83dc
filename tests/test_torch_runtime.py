"""The port's controller runtime (karpenter_tpu_torch.runtime and what it
wires: the Manager, the MetricsProducer controller and its producers, the
durable store, the recovery journal) against the reference's, on the CPU.

Every scenario runs on both packages with the same injected clock:

  * the reference's e2e scenarios (tests/test_e2e.py): their golden
    values hold on both runtimes, and the runtimes leave equal objects,
    provider replicas and registry exposition;
  * workloads.build_runtime_world at a small size through both runtimes,
    tick by tick, under several option sets (fused tick, pool groups,
    consolidation, preemption, event-driven passes);
  * the Manager's backoff snapshot/restore and event passes;
  * a restart over the journal dir mid-drain, with fenced writes;
  * a data dir written by either package opens in the other.

The reference runs as its own tests run it (JAX on the CPU, numpy rung);
the port with Options(device="cpu").
"""

from __future__ import annotations

import importlib

import pytest

from karpenter_tpu_torch import workloads

REF, PORT = "karpenter_tpu", "karpenter_tpu_torch"
PACKAGES = (REF, PORT)


def mod(package: str, name: str):
    return importlib.import_module(f"{package}.{name}")


class FakeClock:
    def __init__(self, start=1000.0):
        self.now = start

    def __call__(self):
        return self.now

    def advance(self, seconds):
        self.now += seconds


def runtime_of(package, *, store=None, provider=None, clock=None, **opts):
    rt = mod(package, "runtime")
    if package == PORT:
        opts.setdefault("device", "cpu")
    return rt.KarpenterRuntime(
        rt.Options(**opts), store=store, cloud_provider_factory=provider,
        clock=clock,
    )


def snapshot(package, runtime, provider) -> dict:
    return workloads.runtime_snapshot(
        runtime.store, runtime.registry, provider,
        mod(package, "api.serialization").to_dict,
    )


def world_api(package):
    return workloads.runtime_api_namespace({
        key: mod(package, key) for key in workloads.RUNTIME_API
    })


def assert_same(got: dict, want: dict, what: str) -> None:
    assert got["objects"].keys() == want["objects"].keys(), what
    for key, doc in want["objects"].items():
        assert got["objects"][key] == doc, f"{what}: {key}"
    assert got["replicas"] == want["replicas"], f"{what}: replicas"
    assert got["exposition"] == want["exposition"], f"{what}: exposition"


# -- the reference's e2e scenarios ------------------------------------------


class E2E:
    """One package's classes and a fresh runtime over a FakeFactory."""

    def __init__(self, package):
        self.package = package
        self.core = mod(package, "api.core")
        self.ha = mod(package, "api.horizontalautoscaler")
        self.mp = mod(package, "api.metricsproducer")
        self.sng = mod(package, "api.scalablenodegroup")
        self.cond = mod(package, "api.conditions")
        self.fake = mod(package, "cloudprovider.fake")
        self.clock = FakeClock()
        self.provider = self.fake.FakeFactory()
        self.runtime = runtime_of(
            package, provider=self.provider, clock=self.clock
        )
        self.store = self.runtime.store

    def tick(self):
        self.runtime.manager.reconcile_all()

    def get(self, kind, name):
        return self.store.get(kind, "default", name)

    def sng_of(self, name, replicas=1):
        return self.sng.ScalableNodeGroup(
            metadata=self.core.ObjectMeta(name=name),
            spec=self.sng.ScalableNodeGroupSpec(
                replicas=replicas, type="FakeNodeGroup", id=name
            ),
        )

    def ha_of(self, name, target, query, target_spec, lo=0, hi=1000):
        h = self.ha
        return h.HorizontalAutoscaler(
            metadata=self.core.ObjectMeta(name=name),
            spec=h.HorizontalAutoscalerSpec(
                scale_target_ref=h.CrossVersionObjectReference(
                    kind="ScalableNodeGroup", name=target
                ),
                min_replicas=lo,
                max_replicas=hi,
                metrics=[
                    h.Metric(prometheus=h.PrometheusMetricSource(
                        query=q, target=target_spec,
                    ))
                    for q in ([query] if isinstance(query, str) else query)
                ],
            ),
        )

    def happy(self, kind, name):
        return self.get(kind, name).status_conditions().is_happy()


def e2e_utilization(e: E2E):
    name = "microservices"
    for resource in ("cpu", "memory"):
        e.runtime.registry.register(
            "reserved_capacity", f"{resource}_utilization"
        ).set(name, "default", 0.85)
    e.provider.node_replicas[name] = 5
    e.store.create(e.sng_of(name, replicas=5))
    e.store.create(e.ha_of(
        name, name,
        [f'karpenter_reserved_capacity_{r}_utilization{{name="{name}"}}'
         for r in ("cpu", "memory")],
        e.ha.MetricTarget(type="Utilization", value=60), lo=3, hi=23,
    ))
    e.tick()
    e.tick()
    assert e.get("HorizontalAutoscaler", name).status.desired_replicas == 8
    assert e.happy("HorizontalAutoscaler", name)
    assert e.provider.node_replicas[name] == 8
    e.clock.advance(61)
    e.tick()
    assert e.get("ScalableNodeGroup", name).status.replicas == 8
    assert e.happy("ScalableNodeGroup", name)


def e2e_queue(e: E2E):
    queue_id = "arn:aws:sqs:us-west-2:1234567890:ml-training-queue"
    e.provider.queue_lengths[queue_id] = 41
    e.provider.node_replicas["ml-training-capacity"] = 1
    e.store.create(e.mp.MetricsProducer(
        metadata=e.core.ObjectMeta(name="ml-training-queue"),
        spec=e.mp.MetricsProducerSpec(
            queue=e.mp.QueueSpec(type="FakeQueue", id=queue_id)
        ),
    ))
    e.store.create(e.sng_of("ml-training-capacity"))
    e.store.create(e.ha_of(
        "ml-training-capacity-autoscaler", "ml-training-capacity",
        'karpenter_queue_length{name="ml-training-queue"}',
        e.ha.MetricTarget(type="AverageValue", value=4),
    ))
    e.tick()
    e.tick()
    ha = e.get("HorizontalAutoscaler", "ml-training-capacity-autoscaler")
    assert ha.status.desired_replicas == 11
    assert ha.status_conditions().is_happy()
    assert e.provider.node_replicas["ml-training-capacity"] == 11
    assert e.get("MetricsProducer", "ml-training-queue").status.queue.length == 41


def e2e_stabilization(e: E2E):
    gauge = e.runtime.registry.register("queue", "length")
    gauge.set("q", "default", 100.0)
    e.provider.node_replicas["svc"] = 1
    e.store.create(e.sng_of("svc"))
    e.store.create(e.ha_of(
        "svc", "svc", 'karpenter_queue_length{name="q"}',
        e.ha.MetricTarget(type="AverageValue", value=4), hi=100,
    ))
    e.tick()
    assert e.get("HorizontalAutoscaler", "svc").status.desired_replicas == 25
    gauge.set("q", "default", 4.0)
    e.clock.advance(30)
    e.tick()
    scale = e.store.get_scale("ScalableNodeGroup", "default", "svc")
    assert scale.spec_replicas == 25
    able = e.get("HorizontalAutoscaler", "svc").status_conditions().get(
        e.cond.ABLE_TO_SCALE
    )
    assert able.status == e.cond.FALSE
    assert "within stabilization window" in able.message
    e.clock.advance(301)
    e.tick()
    assert e.store.get_scale(
        "ScalableNodeGroup", "default", "svc"
    ).spec_replicas == 1


def e2e_reserved_capacity(e: E2E):
    core = e.core
    selector = {"k8s.io/nodegroup": "group"}
    allocatable = core.resource_list(cpu="16300m", memory="128500Mi", pods="50")

    def node(i, labels=selector, ready="True", unschedulable=False):
        return core.Node(
            metadata=core.ObjectMeta(name=f"node-{i}", labels=dict(labels)),
            spec=core.NodeSpec(unschedulable=unschedulable),
            status=core.NodeStatus(
                allocatable=dict(allocatable),
                conditions=[core.NodeCondition("Ready", ready)],
            ),
        )

    def pod(name, node_name, cpu, memory):
        return core.Pod(
            metadata=core.ObjectMeta(name=name),
            spec=core.PodSpec(
                node_name=node_name,
                containers=[core.Container(
                    requests=core.resource_list(cpu=cpu, memory=memory)
                )],
            ),
        )

    for obj in [
        node(0), node(1), node(2, labels={"unknown": "label"}), node(3),
        node(4, ready="False"), node(5, unschedulable=True),
        pod("p0", "node-0", "1100m", "1Gi"),
        pod("p1", "node-0", "2100m", "25Gi"),
        pod("p2", "node-0", "3300m", "50Gi"),
        pod("p3", "node-1", "1100m", "1Gi"),
        pod("p4", "node-2", "99", "99Gi"),
    ]:
        e.store.create(obj)
    for name, sel in (("microservices", selector),
                      ("empty", {"k8s.io/nodegroup": "empty"})):
        e.store.create(e.mp.MetricsProducer(
            metadata=core.ObjectMeta(name=name),
            spec=e.mp.MetricsProducerSpec(
                reserved_capacity=e.mp.ReservedCapacitySpec(node_selector=sel)
            ),
        ))
    e.tick()
    status = e.get("MetricsProducer", "microservices").status
    assert status.reserved_capacity["cpu"] == "15.54%, 7600m/48900m"
    assert status.reserved_capacity["memory"] == "20.45%, 77Gi/385500Mi"
    assert status.reserved_capacity["pods"] == "2.67%, 4/150"
    assert e.happy("MetricsProducer", "microservices")
    got = e.runtime.registry.gauge("reserved_capacity", "cpu_utilization").get(
        "microservices", "default"
    )
    assert got == pytest.approx(7.6 / 48.9)
    empty = e.get("MetricsProducer", "empty")
    for resource in ("cpu", "memory", "pods"):
        assert empty.status.reserved_capacity[resource] == "NaN%, 0/0"
    assert empty.status_conditions().is_happy()


def e2e_sng_up_down_noop(e: E2E):
    e.provider.node_replicas["g"] = 5
    e.store.create(e.sng_of("g", replicas=10))
    e.tick()
    assert e.provider.node_replicas["g"] == 10
    sng = e.get("ScalableNodeGroup", "g")
    sng.spec.replicas = 3
    e.store.update(sng)
    e.tick()
    assert e.provider.node_replicas["g"] == 3
    e.clock.advance(61)
    e.tick()
    assert e.provider.node_replicas["g"] == 3
    fresh = e.get("ScalableNodeGroup", "g")
    assert fresh.status_conditions().is_happy() and fresh.status.replicas == 3


def e2e_retryable_error(e: E2E):
    e.provider.node_replicas["g"] = 1
    e.provider.want_err = e.fake.retryable_error("throttled")
    e.store.create(e.sng_of("g", replicas=2))
    e.tick()
    conds = e.get("ScalableNodeGroup", "g").status_conditions()
    assert conds.get(e.cond.ACTIVE).status == e.cond.TRUE
    able = conds.get(e.cond.ABLE_TO_SCALE)
    assert able.status == e.cond.FALSE and "throttled" in able.message
    assert e.provider.node_replicas["g"] == 1
    e.provider.want_err = None
    e.clock.advance(61)
    e.tick()
    e.tick()
    assert e.happy("ScalableNodeGroup", "g")
    assert e.provider.node_replicas["g"] == 2


def e2e_non_retryable_error(e: E2E):
    e.provider.want_err = RuntimeError("hard failure")
    e.store.create(e.sng_of("g", replicas=1))
    e.tick()
    active = e.get("ScalableNodeGroup", "g").status_conditions().get(
        e.cond.ACTIVE
    )
    assert active.status == e.cond.FALSE
    assert "hard failure" in active.message
    # deactivated: later ticks leave it alone
    e.clock.advance(120)
    e.tick()
    again = e.get("ScalableNodeGroup", "g").status_conditions().get(
        e.cond.ACTIVE
    )
    assert again.status == e.cond.FALSE


SCENARIOS = {
    "utilization_85_target_60_wants_8": e2e_utilization,
    "queue_41_target_4_wants_11": e2e_queue,
    "stabilization_window": e2e_stabilization,
    "reserved_capacity_strings_and_nan": e2e_reserved_capacity,
    "sng_scale_up_down_noop": e2e_sng_up_down_noop,
    "sng_retryable_error": e2e_retryable_error,
    "sng_non_retryable_error": e2e_non_retryable_error,
}


def run_scenario(package, scenario) -> dict:
    e = E2E(package)
    try:
        SCENARIOS[scenario](e)
        return snapshot(package, e.runtime, e.provider)
    finally:
        e.runtime.close()


class TestE2EScenarios:
    @pytest.mark.parametrize("scenario", sorted(SCENARIOS))
    def test_golden_values_hold_and_runtimes_agree(self, scenario):
        want = run_scenario(REF, scenario)
        got = run_scenario(PORT, scenario)
        assert_same(got, want, scenario)


# -- the runtime world, tick by tick ----------------------------------------

WORLD = dict(pods=2000, types=8, n_has=40, metrics=3, seed=0, groups=8)
WORLD_TICKS = 8
WORLD_CHURN = 20
OPTION_SETS = {
    "production": dict(fused_tick=True, poolgroups=True, consolidate=True,
                       preempt=True),
    "chained": dict(poolgroups=True),
    "event_driven": dict(fused_tick=True, poolgroups=True, consolidate=True,
                         preempt=True, event_driven=True, event_thread=False),
}


def run_world(package, options: dict, ticks: int = WORLD_TICKS):
    """Snapshots after each tick of the runtime world, with the clock
    advanced 5 s, WORLD_CHURN pods churned and the queues stepped
    between ticks; under event_driven an event pass runs after each
    churn and before the tick."""
    clock = FakeClock(1_000_000.0)
    provider = mod(package, "cloudprovider.fake").FakeFactory()
    runtime = runtime_of(package, provider=provider, clock=clock, **options)
    snaps, passes = [], []
    try:
        world = workloads.build_runtime_world(
            runtime.store, provider, api=world_api(package), **WORLD
        )
        for t in range(ticks):
            if t:
                clock.advance(5.0)
                workloads.churn_reconcile(world.cluster, WORLD_CHURN)()
                world.step_queues()
                if runtime.manager.event_driven:
                    passes.append(runtime.manager.run_event_pass())
            runtime.manager.reconcile_all()
            snaps.append(snapshot(package, runtime, provider))
        return snaps, passes
    finally:
        runtime.close()


@pytest.fixture(scope="module")
def reference_worlds():
    return {name: run_world(REF, opts) for name, opts in OPTION_SETS.items()}


class TestRuntimeWorld:
    @pytest.mark.parametrize("options", sorted(OPTION_SETS))
    def test_every_tick_equals_the_reference(self, reference_worlds, options):
        want_snaps, want_passes = reference_worlds[options]
        got_snaps, got_passes = run_world(PORT, OPTION_SETS[options])
        assert got_passes == want_passes
        for t, (got, want) in enumerate(zip(got_snaps, want_snaps)):
            assert_same(got, want, f"{options}, tick {t}")

    def test_the_world_moves_every_controller(self, reference_worlds):
        snaps, passes = reference_worlds["event_driven"]
        first, last = snaps[0]["objects"], snaps[-1]["objects"]
        statuses = {
            kind: [d for (k, _, _), d in last.items() if k == kind]
            for kind in ("MetricsProducer", "HorizontalAutoscaler",
                         "ScalableNodeGroup")
        }
        assert all(d.get("status") for d in statuses["MetricsProducer"])
        pending = [d for d in statuses["MetricsProducer"]
                   if "pendingCapacity" in d["status"]]
        assert len(pending) == WORLD["types"]
        assert any(d["status"].get("desiredReplicas")
                   for d in statuses["HorizontalAutoscaler"])
        assert snaps[0]["replicas"] != snaps[-1]["replicas"]
        assert first != last
        assert any(passes)
        text = "\n".join(snaps[-1]["exposition"])
        for family in ("karpenter_pending_capacity_", "karpenter_queue_length{",
                       "karpenter_poolgroup_", "karpenter_consolidation_",
                       "karpenter_preemption_"):
            assert family in text, family


# -- the Manager: backoff ladder and event passes ---------------------------


class Flaky:
    """A controller of ScalableNodeGroups failing per object: names
    starting with "r" retryably, "x" non-retryably, others succeed."""

    def __init__(self, package):
        self.errors = mod(package, "controllers.errors")
        self.seen = []

    def kind(self):
        return "ScalableNodeGroup"

    def interval(self):
        return 30.0

    def reconcile(self, obj):
        self.seen.append(obj.metadata.name)
        if obj.metadata.name.startswith("r"):
            raise self.errors.RetryableError("throttled", code="throttled")
        if obj.metadata.name.startswith("x"):
            raise RuntimeError("poisoned")


def manager_run(package, event_driven: bool):
    store = mod(package, "store").Store()
    registry = mod(package, "metrics.registry").GaugeRegistry()
    clock = FakeClock()
    flaky = Flaky(package)
    manager = mod(package, "controllers.engine").Manager(
        store, clock=clock, registry=registry, backoff_seed=7,
        event_driven=event_driven, event_thread=False,
    ).register(flaky)
    core = mod(package, "api.core")
    sng = mod(package, "api.scalablenodegroup")
    names = ["a0", "r1", "x2", "a3", "r4"]
    for name in names:
        store.create(sng.ScalableNodeGroup(
            metadata=core.ObjectMeta(name=name),
            spec=sng.ScalableNodeGroupSpec(
                replicas=1, type="FakeNodeGroup", id=name
            ),
        ))
    trail = []
    for step in range(6):
        clock.advance(7.0)
        if event_driven and step % 2:
            obj = store.get("ScalableNodeGroup", "default", names[step % 5])
            obj.spec.replicas += 1
            store.update(obj)
            trail.append(("pass", manager.run_event_pass()))
        manager.reconcile_all()
        trail.append(("seen", list(flaky.seen)))
        flaky.seen.clear()
    snap = manager.snapshot_backoff()
    due = {k: v for k, v in manager._due.items()}
    fresh = mod(package, "controllers.engine").Manager(
        store, clock=clock, backoff_seed=7
    ).register(Flaky(package))
    fresh.restore_backoff(dict(snap))
    restored = {k: v for k, v in fresh._due.items() if k in fresh._backoff_prev}
    manager.close()
    fresh.close()
    return trail, snap, due, restored, workloads.exposition_lines(registry)


class TestManager:
    @pytest.mark.parametrize("event_driven", [False, True],
                             ids=["tick_paced", "event_driven"])
    def test_backoff_ladder_snapshot_and_restore(self, event_driven):
        want = manager_run(REF, event_driven)
        got = manager_run(PORT, event_driven)
        names = ("trail", "backoff snapshot", "due times", "restored",
                 "exposition")
        for name, g, w in zip(names, got, want):
            assert g == w, name
        trail, snap, due, restored, _ = got
        assert len(snap) == 2  # the two retryable objects
        assert due[("ScalableNodeGroup", "default", "x2")] == float("inf")
        assert set(restored) == {
            ("ScalableNodeGroup", "default", "r1"),
            ("ScalableNodeGroup", "default", "r4"),
        }
        if event_driven:
            assert any(kind == "pass" and n for kind, n in trail)

    def test_registration_order_is_the_references(self):
        for package in PACKAGES:
            runtime = runtime_of(package, clock=FakeClock())
            try:
                kinds = [c.kind() for c in runtime.manager._controllers]
            finally:
                runtime.close()
            assert kinds == ["MetricsProducer", "ScalableNodeGroup",
                             "HorizontalAutoscaler"], package


# -- recovery: a restart mid-drain ------------------------------------------


def drain_restart(package, journal_dir):
    """tests/test_restart_chaos.py's crash-after-decrement scenario: the
    restarted incarnation resumes the draining node and actuates once,
    fenced with the new generation."""
    core = mod(package, "api.core")
    mpa = mod(package, "api.metricsproducer")
    sng = mod(package, "api.scalablenodegroup")
    fake = mod(package, "cloudprovider.fake")
    quantity = mod(package, "utils.quantity").Quantity

    class Recording(fake.FakeFactory):
        def __init__(self):
            super().__init__()
            self.actuations = []

        def node_group_for(self, spec):
            factory = self

            class Group(fake.FakeNodeGroup):
                def set_replicas(self, count, token=None):
                    super().set_replicas(count, token=token)
                    factory.actuations.append((self._id, count, token.generation
                                               if token is not None else None))

            return Group(self, spec.id)

    def q(v):
        return quantity.parse(str(v))

    store = mod(package, "store").Store()
    clock = FakeClock()
    provider = Recording()
    provider.node_replicas["grp-id"] = 3
    store.create(mpa.MetricsProducer(
        metadata=core.ObjectMeta(name="pc"),
        spec=mpa.MetricsProducerSpec(pending_capacity=mpa.PendingCapacitySpec(
            node_selector={"pool": "a"}, node_group_ref="grp",
        )),
    ))
    store.create(sng.ScalableNodeGroup(
        metadata=core.ObjectMeta(name="grp"),
        spec=sng.ScalableNodeGroupSpec(
            replicas=3, type=sng.FAKE_NODE_GROUP, id="grp-id"
        ),
    ))
    for i in range(3):
        store.create(core.Node(
            metadata=core.ObjectMeta(name=f"n{i}", labels={"pool": "a"}),
            spec=core.NodeSpec(),
            status=core.NodeStatus(
                allocatable={"cpu": q(8), "memory": q("16Gi"), "pods": q(16)},
                conditions=[core.NodeCondition("Ready", "True")],
            ),
        ))
    store.create(core.Pod(
        metadata=core.ObjectMeta(name="p0"),
        spec=core.PodSpec(node_name="n0", containers=[core.Container(
            requests={"cpu": q(1), "memory": q("1Gi")}
        )]),
    ))

    def boot():
        return runtime_of(
            package, store=store, provider=provider, clock=clock,
            journal_dir=str(journal_dir), consolidate=True,
        )

    rt1 = boot()
    engine = rt1.consolidation
    engine.plan()
    clock.advance(engine.config.cooldown_s + 1)
    engine.plan()
    cordoned = next(iter(engine.in_flight()))
    clock.advance(engine.config.verify_s + 1)
    engine.plan()  # APPROVED -> DRAINING, spec 3 -> 2
    phase_before = dict(engine.in_flight())
    generation_1 = rt1.recovery.fence.generation
    rt1.solver_service.close()  # SIGKILL: no graceful checkpoint
    rt1.recovery.journal.close()

    rt2 = boot()
    try:
        resumed = dict(rt2.consolidation.in_flight())
        warm = rt2.recovery.warmup_remaining
        clock.advance(61.0)
        rt2.manager._due = {k: 0.0 for k in rt2.manager._due}
        rt2.manager.reconcile_all()
        return dict(
            cordoned=cordoned, before=phase_before, resumed=resumed,
            warmup=warm, generations=(generation_1,
                                      rt2.recovery.fence.generation),
            actuations=list(provider.actuations),
            replicas=provider.node_replicas["grp-id"],
            highest=provider.fence_validator.highest_seen,
            nodes=sorted(n.metadata.name for n in store.list("Node")),
            after=dict(rt2.consolidation.in_flight()),
        )
    finally:
        rt2.close()


class TestRecovery:
    def test_restart_mid_drain_resumes_and_actuates_fenced(self, tmp_path):
        want = drain_restart(REF, tmp_path / "ref")
        got = drain_restart(PORT, tmp_path / "port")
        assert got == want
        assert got["before"] == {got["cordoned"]: "draining"}
        assert got["resumed"] == got["before"]
        assert got["warmup"] == 1
        assert got["generations"] == (1, 2)
        # one provider write across both incarnations, stamped with the
        # restarted incarnation's generation
        assert got["actuations"] == [("grp-id", 2, 2)]
        assert got["highest"] == 2 and got["replicas"] == 2
        assert got["cordoned"] not in got["nodes"] and got["after"] == {}

    def test_sng_controller_is_wired_to_recovery(self, tmp_path):
        runtime = runtime_of(PORT, journal_dir=str(tmp_path),
                             clock=FakeClock())
        try:
            assert runtime._sng_controller.recovery is runtime.recovery
            assert runtime.recovery.fence.generation == 1
        finally:
            runtime.close()


# -- the durable store across packages --------------------------------------


def write_data_dir(package, data_dir):
    """A small runtime world in `package`'s DurableStore, ticked twice
    (statuses written through the WAL), with some deletions."""
    store = mod(package, "store.persistence").open_store(str(data_dir))
    provider = mod(package, "cloudprovider.fake").FakeFactory()
    clock = FakeClock(1_000_000.0)
    runtime = runtime_of(package, store=store, provider=provider, clock=clock)
    try:
        world = workloads.build_runtime_world(
            store, provider, 300, 4, 8, 2, 3, groups=2,
            api=world_api(package),
        )
        runtime.manager.reconcile_all()
        clock.advance(5.0)
        workloads.churn_reconcile(world.cluster, 10)()
        runtime.manager.reconcile_all()
    finally:
        runtime.close()
        store.close()


def read_data_dir(package, data_dir) -> dict:
    store = mod(package, "store.persistence").open_store(str(data_dir))
    try:
        to_dict = mod(package, "api.serialization").to_dict
        out = {}
        for kind in workloads.RUNTIME_KINDS:
            for obj in store.list(kind):
                out[(kind, obj.metadata.namespace, obj.metadata.name)] = (
                    to_dict(obj), obj.metadata.uid,
                    obj.metadata.resource_version,
                )
        return out
    finally:
        store.close()


class TestDurableStore:
    @pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                             ids=["reference_to_port", "port_to_reference"])
    def test_data_dir_opens_in_the_other_package(self, tmp_path, writer,
                                                 reader):
        write_data_dir(writer, tmp_path)
        want = read_data_dir(writer, tmp_path)
        got = read_data_dir(reader, tmp_path)
        assert len(want) > 300
        assert got == want
        statuses = [doc for (kind, _, _), (doc, _, _) in want.items()
                    if kind == "MetricsProducer"]
        assert statuses and all(doc.get("status") for doc in statuses)
