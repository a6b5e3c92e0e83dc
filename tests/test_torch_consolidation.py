"""The port's disruption path on the CPU (karpenter_tpu_torch/consolidation,
preemption, controllers/scalablenodegroup.py, cloudprovider/, the
service's `consolidate` family) against the reference's.

- Planner verdicts: the same small clusters, built from each package's
  classes, judged by both packages' planners behind their CPU services
  (the port on its torch and numpy rungs), equal the expected verdicts.
- Batched == independent: a consolidate() batch equals one masked
  bin-pack per candidate, on both port rungs, and the reference's numpy
  mirror; the candidates' operands equal the reference's byte for byte.
- The consolidate seam: one dispatch per batch on the torch rung, no new
  dispatch key across candidate-count jitter, a batch past max_batch in
  one dispatch; the card's whole-batch admission on a CPU service under
  the card's policy.
- The engine's state machine and the controller's scale-down condition,
  as tests/test_consolidation.py runs them through the reference's
  runtime, here through the port's controller over a fake clock.
- One disruption world (workloads.build_disruption_world, 40 nodes, 400
  pods, 6 critical pods) built from both packages: over 8 rounds the
  port behind SolverService(device="cpu", backend="torch") and the
  reference behind its CPU service give equal verdicts, plans,
  evictions, store state, node-group statuses and gauge exposition.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import types

import numpy as np
import pytest

import karpenter_tpu.solver as ref_solver
from karpenter_tpu.metrics.registry import GaugeRegistry as RefRegistry
from karpenter_tpu.ops.numpy_binpack import binpack_numpy as ref_binpack_numpy
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.api.scalablenodegroup import (
    FAKE_NODE_GROUP,
    ScalableNodeGroup,
    ScalableNodeGroupSpec,
)
from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
from karpenter_tpu_torch.consolidation import DO_NOT_DISRUPT, ConsolidationEngine
from karpenter_tpu_torch.controllers.scalablenodegroup import (
    ScalableNodeGroupController,
)
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.ops import binpack as B
from karpenter_tpu_torch.ops.numpy_binpack import binpack_numpy
from karpenter_tpu_torch.solver import SolverSaturated
from karpenter_tpu_torch.store.store import Scale

from test_torch_solver_service import FakeClock, card_policy, new_service

OUT_FIELDS = ("assigned", "assigned_count", "nodes_needed")


def package(name: str):
    """The modules a cluster and its planner come from, by package."""
    if name == "port":
        from karpenter_tpu_torch import consolidation, store
        from karpenter_tpu_torch.api import core, metricsproducer
        from karpenter_tpu_torch.utils import quantity
    else:
        from karpenter_tpu import consolidation, store
        from karpenter_tpu.api import core, metricsproducer
        from karpenter_tpu.utils import quantity
    return types.SimpleNamespace(
        core=core, mp=metricsproducer, store=store, quantity=quantity,
        consolidation=consolidation,
    )


PORT = package("port")
REF = package("ref")


def make_node(pkg, name, cpu="8", memory="16Gi", pods="16", labels=None,
              ready=True, taints=(), annotations=None, unschedulable=False):
    c, q = pkg.core, pkg.quantity.Quantity.parse
    return c.Node(
        metadata=c.ObjectMeta(
            name=name, labels=dict(labels or {"pool": "a"}),
            annotations=dict(annotations or {}),
        ),
        spec=c.NodeSpec(
            taints=[c.Taint(key=k, value=v, effect=e) for k, v, e in taints],
            unschedulable=unschedulable,
        ),
        status=c.NodeStatus(
            allocatable={"cpu": q(cpu), "memory": q(memory), "pods": q(pods)},
            conditions=[c.NodeCondition("Ready", "True" if ready else "False")],
        ),
    )


def make_pod(pkg, name, node, cpu="1", memory="1Gi", node_selector=None,
             tolerations=(), annotations=None):
    c, q = pkg.core, pkg.quantity.Quantity.parse
    return c.Pod(
        metadata=c.ObjectMeta(name=name, annotations=dict(annotations or {})),
        spec=c.PodSpec(
            node_name=node,
            containers=[c.Container(requests={"cpu": q(cpu), "memory": q(memory)})],
            node_selector=dict(node_selector or {}),
            tolerations=[
                c.Toleration(key=k, operator="Equal", value=v, effect=e)
                for k, v, e in tolerations
            ],
        ),
    )


def make_producer(pkg, name="pc", selector=None, ref="grp"):
    return pkg.mp.MetricsProducer(
        metadata=pkg.core.ObjectMeta(name=name),
        spec=pkg.mp.MetricsProducerSpec(
            pending_capacity=pkg.mp.PendingCapacitySpec(
                node_selector=dict(selector or {"pool": "a"}),
                node_group_ref=ref,
            )
        ),
    )


def store_with(pkg, nodes=(), pods=()):
    """A store of a producer (pool=a -> grp), the given nodes and pods,
    each given as (name, kwargs) and built from `pkg`'s classes."""
    store = pkg.store.Store()
    store.create(make_producer(pkg))
    for name, kw in nodes:
        store.create(make_node(pkg, name, **kw))
    for name, node, kw in pods:
        store.create(make_pod(pkg, name, node, **kw))
    return store


@pytest.fixture
def services():
    """(port torch rung, port numpy rung, reference numpy rung)."""
    made = [
        new_service(backend="torch", window_s=0.02),
        new_service(backend="numpy", window_s=0.02),
        ref_solver.SolverService(registry=RefRegistry(), backend="numpy",
                                 window_s=0.02),
    ]
    try:
        yield made
    finally:
        for svc in made:
            svc.close()


def verdicts_everywhere(services, nodes, pods, names):
    """{candidate: drainable} from the port on both rungs and from the
    reference, asserted equal; also the port services' request counts."""
    out = []
    for pkg, svc in ((PORT, services[0]), (PORT, services[1]),
                     (REF, services[2])):
        store = store_with(pkg, nodes, pods)
        view = pkg.consolidation.cluster_view(store)
        out.append(pkg.consolidation.evaluate(view, names, svc))
    assert out[0] == out[1] == out[2]
    return out[0]


class TestPlannerVerdicts:
    def test_empty_node_is_trivially_drainable(self, services):
        got = verdicts_everywhere(
            services, [("n0", {}), ("n1", {})], [], ["n0", "n1"]
        )
        assert got == {"n0": True, "n1": True}
        # nothing to re-pack: no solve was needed at all
        assert services[0].stats.requests == services[1].stats.requests == 0

    def test_pod_repacks_onto_free_node(self, services):
        got = verdicts_everywhere(
            services, [("n0", {}), ("n1", {})], [("p0", "n0", {})], ["n0"]
        )
        assert got == {"n0": True}
        assert services[0].stats.dispatches == 1

    def test_no_receiver_vetoes(self, services):
        got = verdicts_everywhere(
            services, [("n0", {})], [("p0", "n0", {})], ["n0"]
        )
        assert got == {"n0": False}

    def test_overfull_remainder_vetoes(self, services):
        # n1's free capacity (8 - 6 = 2 cpu) cannot absorb n0's 4-cpu pod
        got = verdicts_everywhere(
            services, [("n0", {}), ("n1", {})],
            [("p0", "n0", {"cpu": "4"}), ("p1", "n1", {"cpu": "6"})], ["n0"],
        )
        assert got == {"n0": False}

    def test_node_selector_respected(self, services):
        got = verdicts_everywhere(
            services,
            [("n0", {"labels": {"pool": "a", "disk": "ssd"}}), ("n1", {})],
            [("p0", "n0", {"node_selector": {"disk": "ssd"}})], ["n0"],
        )
        assert got == {"n0": False}

    @pytest.mark.parametrize("tolerated", [False, True])
    def test_untolerated_taint_respected(self, services, tolerated):
        taint = ("dedicated", "x", "NoSchedule")
        got = verdicts_everywhere(
            services, [("n0", {}), ("n1", {"taints": [taint]})],
            [("p0", "n0", {"tolerations": [taint] if tolerated else []})],
            ["n0"],
        )
        assert got == {"n0": tolerated}

    def test_cordoned_receiver_excluded(self, services):
        got = verdicts_everywhere(
            services, [("n0", {}), ("n1", {"unschedulable": True})],
            [("p0", "n0", {})], ["n0"],
        )
        assert got == {"n0": False}

    def test_do_not_disrupt_marks_view(self):
        store = store_with(
            PORT, [("n0", {}), ("n1", {})],
            [("p0", "n0", {"annotations": {DO_NOT_DISRUPT: "true"}})],
        )
        by_name = PORT.consolidation.cluster_view(store).by_name()
        assert by_name["n0"].do_not_disrupt
        assert not by_name["n1"].do_not_disrupt


def random_cluster(pkg, seed, nodes=8, pods=40):
    """tests/test_consolidation.py::random_cluster from `pkg`'s classes: a
    fragmented cluster with skewed placement, mixed sizes, and some
    selector-constrained pods."""
    rng = np.random.default_rng(seed)
    node_specs = [
        (f"n{i}", {"cpu": str(int(rng.choice([4, 8, 16]))),
                   "labels": {"pool": "a", "zone": f"z{i % 2}"}})
        for i in range(nodes)
    ]
    pod_specs = []
    for i in range(pods):
        n = int(nodes * rng.random() ** 2) % nodes
        selector = (
            {"zone": f"z{int(rng.integers(0, 2))}"}
            if rng.random() < 0.3 else None
        )
        pod_specs.append((f"p{i}", f"n{n}", {
            "cpu": str(float(rng.choice([0.25, 0.5, 1.0, 2.0]))),
            "memory": f"{int(rng.choice([256, 512, 1024]))}Mi",
            "node_selector": selector,
        }))
    return store_with(pkg, node_specs, pod_specs)


def problems(pkg, seed, **kw):
    view = pkg.consolidation.cluster_view(random_cluster(pkg, seed, **kw))
    return pkg.consolidation.build_problems(view, [nv.name for nv in view.nodes])


class TestBatchedVerdictProperty:
    """The batched consolidation verdict for N candidates equals N
    independent masked bin-packs on both port rungs, and the reference's
    numpy mirror."""

    @pytest.mark.parametrize("seed", range(4))
    def test_batched_equals_independent_both_rungs(self, seed, services):
        solved, inputs, trivial = problems(PORT, seed)
        ref_solved, ref_inputs, ref_trivial = problems(REF, seed)
        assert (solved, trivial) == (ref_solved, ref_trivial)
        assert inputs, "cluster should produce at least one solve"
        for mine, ref in zip(inputs, ref_inputs):
            for f in dataclasses.fields(ref):
                a, b = getattr(mine, f.name), getattr(ref, f.name)
                assert (a is None) == (b is None), f.name
                if a is not None:
                    assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        batched_torch = services[0].consolidate(inputs, backend="torch")
        batched_np = services[1].consolidate(inputs, backend="numpy")
        for name, x, bt, bn in zip(solved, inputs, batched_torch, batched_np):
            direct = B.solve(x, backend="torch", device="cpu")
            want = ref_binpack_numpy(x)
            for got in (bt, bn, direct, binpack_numpy(x)):
                for field in OUT_FIELDS:
                    np.testing.assert_array_equal(
                        np.asarray(getattr(got, field)),
                        np.asarray(getattr(want, field)),
                        err_msg=f"{name}:{field}",
                    )
                assert int(got.unschedulable) == int(want.unschedulable)
                assert (PORT.consolidation.drainable(got)
                        == REF.consolidation.drainable(want))


class TestServiceConsolidateSeam:
    def test_empty_batch(self, services):
        assert services[0].consolidate([]) == []

    def test_one_dispatch_per_batch(self, services):
        _, inputs, _ = problems(PORT, 1)
        assert len(inputs) >= 4
        svc = services[0]
        before = svc.stats.dispatches
        svc.consolidate(inputs, backend="torch")
        assert svc.stats.dispatches == before + 1
        assert svc.stats.consolidate_calls == 1
        assert svc.stats.consolidate_candidates == len(inputs)

    def test_no_new_key_across_candidate_jitter(self, services):
        """Candidate counts wandering inside one batch rung (and pod
        counts inside one pod rung) reuse the dispatch key."""
        _, inputs, _ = problems(PORT, 2, nodes=10, pods=50)
        assert len(inputs) >= 6
        svc = services[0]
        svc.consolidate(inputs[:6], backend="torch")  # first sight of rung 6
        misses = svc.stats.compile_cache_misses
        svc.consolidate(inputs[:5], backend="torch")
        svc.consolidate(inputs[:6], backend="torch")
        assert svc.stats.compile_cache_misses == misses
        assert svc.stats.compile_cache_hits >= 2

    def test_batch_larger_than_max_batch_one_dispatch(self):
        svc = new_service(backend="torch", window_s=0.02, max_batch=2)
        try:
            _, inputs, _ = problems(PORT, 3, nodes=10, pods=50)
            assert len(inputs) > 2
            before = svc.stats.dispatches
            svc.consolidate(inputs)
            assert svc.stats.dispatches == before + 1
        finally:
            svc.close()

    def test_cpu_overflow_slots_answer_from_numpy(self):
        """A batch takes one queue slot: on the CPU a batch longer than
        max_queue is admitted whole, and a full queue refuses it whole,
        each candidate then answered from numpy."""
        _, inputs, _ = problems(PORT, 1)
        svc = new_service(backend="torch", window_s=0.02, max_queue=2)
        try:
            assert len(svc.consolidate(inputs)) == len(inputs)
            assert svc.stats.rejected == svc.stats.fallbacks == 0
            assert svc.stats.dispatches == 1
            svc.max_queue = 0
            got = svc.consolidate(inputs)
            assert svc.stats.rejected == len(inputs)
            assert svc.stats.fallbacks == len(inputs)
            for x, out in zip(inputs, got):
                np.testing.assert_array_equal(
                    out.assigned, binpack_numpy(x).assigned
                )
        finally:
            svc.close()

    def test_batch_overflow_records_rejected_spans(self):
        """Queue-full slots of a batch leave rejected request spans, as a
        rejected singleton does."""
        from karpenter_tpu_torch.observability import (
            default_tracer,
            reset_default_tracer,
            set_default_tracer,
        )

        saved = default_tracer()
        tracer = reset_default_tracer()
        _, inputs, _ = problems(PORT, 1)
        svc = new_service(backend="numpy", max_queue=0)
        try:
            with tracer.trace("tick"):
                assert len(svc.consolidate(inputs[:3])) == 3
        finally:
            svc.close()
            set_default_tracer(saved)
        rejected = [s for s in tracer.snapshot()
                    if s["name"] == "solver.request"
                    and s["args"].get("rejected") is True]
        assert len(rejected) == 3
        assert all(s["args"]["ok"] is False for s in rejected)

    @pytest.mark.parametrize("policy", ["cpu", "card"])
    def test_solve_beside_a_waiting_batch(self, policy):
        """A batch of the engine's default size (64 candidates plus the
        nodes it re-verifies) waiting behind a running dispatch leaves
        room in the default queue: a solve() beside it is admitted on
        either device, and nothing is refused or answered from numpy."""
        from karpenter_tpu_torch.faults import FaultRegistry

        _, inputs, _ = problems(PORT, 1)
        batch = [inputs[i % len(inputs)] for i in range(67)]
        svc = new_service(backend="torch", window_s=0.0)
        if policy == "card":
            card_policy(svc)
        assert svc.max_queue == 64
        out = {}
        with FaultRegistry() as reg:
            reg.plan("solver.dispatch", mode="latency", latency_s=1.0,
                     times=1)
            try:
                first = threading.Thread(
                    target=lambda: out.setdefault(
                        "first", svc.solve(inputs[0])))
                first.start()
                deadline = time.monotonic() + 5.0
                while reg.injected.get("solver.dispatch", 0) < 1:
                    assert time.monotonic() < deadline
                    time.sleep(0.001)
                drain = threading.Thread(
                    target=lambda: out.setdefault(
                        "batch", svc.consolidate(batch)))
                drain.start()
                while svc.queue_depth() < len(batch):
                    assert time.monotonic() < deadline
                    time.sleep(0.001)
                got = svc.solve(inputs[1])
                first.join(10.0)
                drain.join(10.0)
            finally:
                svc.close()
        assert svc.stats.rejected == svc.stats.fallbacks == 0
        np.testing.assert_array_equal(
            got.assigned, binpack_numpy(inputs[1]).assigned)
        assert len(out["batch"]) == len(batch)
        for x, res in zip(batch, out["batch"]):
            np.testing.assert_array_equal(
                res.assigned, binpack_numpy(x).assigned)

    def test_cuda_rung_refuses_constraint_operands(self):
        """The planner folds every constraint into pod_group_forbidden, so
        a candidate carrying constraint operands is refused on the cuda
        rung (no constraint entry in the fused kernel), not served by the
        plain program."""
        _, inputs, _ = problems(PORT, 1)
        x = inputs[0]
        p = x.pod_requests.shape[0]
        svc = new_service(backend="torch")
        try:
            assert svc._consolidate_key(x, 32, "torch")[-1] == "vmap"
            claimed = dataclasses.replace(
                x, pod_claim=np.zeros(p, np.int32))
            with pytest.raises(ValueError, match="constraint operands"):
                svc._consolidate_key(claimed, 32, "cuda")
            assert svc.stats.constraint_reroutes == 0
        finally:
            svc.close()

    def test_card_admits_a_batch_whole_or_raises(self):
        """Under the card's policy a batch longer than max_queue is
        admitted whole (one dispatch, no numpy answer), and a full queue
        refuses the whole batch with SolverSaturated."""
        _, inputs, _ = problems(PORT, 1)
        svc = card_policy(new_service(backend="torch", window_s=0.02,
                                      max_queue=2))
        try:
            got = svc.consolidate(inputs)
            assert len(got) == len(inputs)
            assert svc.stats.rejected == svc.stats.fallbacks == 0
            assert svc.stats.dispatches == 1
            svc.max_queue = 0
            with pytest.raises(SolverSaturated):
                svc.consolidate(inputs)
            assert svc.stats.rejected == len(inputs)
            assert svc.stats.fallbacks == 0
        finally:
            svc.close()


class Harness:
    """One node group (grp -> grp-id) behind the port's
    ScalableNodeGroupController with a ConsolidationEngine, on a fake
    clock: what tests/test_consolidation.py builds with
    KarpenterRuntime(Options(consolidate=True)). `converge(n)` reconciles
    the group n times and writes its status, as the manager's converge."""

    def __init__(self, replicas=3, budget=1, stable=True):
        self.clock = FakeClock()
        self.provider = FakeFactory()
        self.provider.node_replicas["grp-id"] = replicas
        self.provider.node_group_stable = stable
        self.store = PORT.store.Store()
        self.registry = GaugeRegistry()
        self.service = new_service(backend="torch", window_s=0.02)
        self.engine = ConsolidationEngine(
            self.store, solver_service=self.service,
            registry=self.registry, clock=self.clock,
        )
        self.engine.config.budget_per_group = budget
        self.controller = ScalableNodeGroupController(
            self.provider, consolidator=self.engine,
            registry=self.registry, clock=self.clock,
        )
        self.store.create(make_producer(PORT))
        self.store.create(ScalableNodeGroup(
            metadata=PORT.core.ObjectMeta(name="grp"),
            spec=ScalableNodeGroupSpec(
                replicas=replicas, type=FAKE_NODE_GROUP, id="grp-id"
            ),
        ))

    def node(self, name, **kw):
        self.store.create(make_node(PORT, name, **kw))

    def pod(self, name, node, **kw):
        self.store.create(make_pod(PORT, name, node, **kw))

    def converge(self, ticks):
        for _ in range(ticks):
            sng = self.store.get("ScalableNodeGroup", "default", "grp")
            self.controller.reconcile(sng)
            self.store.patch_status(sng)

    def vetoed(self):
        return self.registry.gauge(
            "consolidation", "drains_vetoed_total"
        ).get("-", "-")


@pytest.fixture
def harness():
    made = []

    def build(**kw):
        h = Harness(**kw)
        made.append(h)
        return h

    yield build
    for h in made:
        h.service.close()


class TestEngineStateMachine:
    def test_cooldown_then_cordon_verify_drain(self, harness):
        h = harness()
        engine, store = h.engine, h.store
        for i in range(3):
            h.node(f"n{i}")
        h.pod("p0", "n0")
        # first sight starts the churn clock: nothing is touched
        assert engine.plan() == {}
        assert engine.in_flight() == {}
        h.clock.advance(engine.config.cooldown_s + 1)
        engine.plan()
        # budget 1: exactly one node cordoned (an empty one first)
        assert list(engine.in_flight().values()) == ["cordoned"]
        cordoned = next(iter(engine.in_flight()))
        node = store.get("Node", "default", cordoned)
        assert node.spec.unschedulable
        assert node.metadata.annotations[
            "karpenter.sh/consolidation-state"] == "cordoned"
        h.clock.advance(1)
        engine.plan()
        assert engine.in_flight()[cordoned] == "cordoned"
        h.clock.advance(engine.config.verify_s)
        engine.plan()
        assert engine.in_flight()[cordoned] == "draining"
        assert store.get("ScalableNodeGroup", "default", "grp").spec.replicas == 2
        # the controller actuates the shrink and finalizes the drain
        h.converge(2)
        assert engine.in_flight() == {}
        assert h.provider.node_replicas["grp-id"] == 2
        assert cordoned not in {n.metadata.name for n in store.list("Node")}
        assert h.registry.gauge(
            "consolidation", "drains_actuated_total").get("-", "-") == 1.0

    def test_verdict_flip_uncordons_and_counts_veto(self, harness):
        h = harness()
        engine = h.engine
        h.node("n0")
        h.node("n1")
        h.pod("p0", "n0")
        engine.plan()
        h.clock.advance(engine.config.cooldown_s + 1)
        engine.plan()
        # emptiest-first: n1 (no pods) cordons
        assert engine.in_flight() == {"n1": "cordoned"}
        # fill n0 and bind a pod onto n1 past the cordon: n1 no longer
        # drains
        h.pod("big0", "n0", cpu="7")
        h.pod("p1", "n1", cpu="4")
        h.clock.advance(engine.config.verify_s + 1)
        engine.plan()
        assert engine.in_flight() == {}
        assert not h.store.get("Node", "default", "n1").spec.unschedulable
        assert h.vetoed() == 1.0

    def test_drain_timeout_vetoes_and_frees_budget(self, harness):
        h = harness()
        engine = h.engine
        h.node("n0")
        h.node("n1")
        engine.plan()
        h.clock.advance(engine.config.cooldown_s + 1)
        engine.plan()
        h.clock.advance(engine.config.verify_s + 1)
        engine.plan()
        (draining,) = [n for n, p in engine.in_flight().items()
                       if p == "draining"]
        # a concurrent writer reverts the decrement: the controller never
        # observes spec < observed
        h.store.update_scale("ScalableNodeGroup", Scale("default", "grp", 3, 3))
        h.clock.advance(engine.config.drain_timeout_s + 1)
        engine.plan()
        assert draining not in engine.in_flight()
        assert not h.store.get("Node", "default", draining).spec.unschedulable
        assert h.vetoed() == 1.0

    def test_failed_uncordon_retries_until_it_lands(self, harness):
        h = harness()
        engine, store = h.engine, h.store
        h.node("n0")
        h.node("n1")
        h.pod("p0", "n0")
        engine.plan()
        h.clock.advance(engine.config.cooldown_s + 1)
        engine.plan()
        assert engine.in_flight() == {"n1": "cordoned"}
        h.pod("big", "n0", cpu="7")
        h.pod("p1", "n1", cpu="4")
        real_update = store.update

        def failing_update(obj):
            raise RuntimeError("injected conflict")

        store.update = failing_update
        h.clock.advance(engine.config.verify_s + 1)
        engine.plan()
        assert engine.in_flight() == {"n1": "uncordoning"}
        assert store.get("Node", "default", "n1").spec.unschedulable
        store.update = real_update
        h.clock.advance(1)
        engine.plan()
        assert engine.in_flight() == {}
        assert not store.get("Node", "default", "n1").spec.unschedulable

    def test_do_not_disrupt_blocks_candidacy(self, harness):
        h = harness()
        engine = h.engine
        h.node("n0", annotations={DO_NOT_DISRUPT: "true"})
        h.node("n1")
        h.pod("p0", "n1", annotations={DO_NOT_DISRUPT: "true"})
        engine.plan()
        h.clock.advance(engine.config.cooldown_s + 1)
        assert engine.plan() == {}  # neither node is even evaluated
        assert engine.in_flight() == {}

    def test_budget_bounds_concurrent_disruption(self, harness):
        h = harness(budget=2)
        engine = h.engine
        for i in range(5):
            h.node(f"n{i}")
        engine.plan()
        h.clock.advance(engine.config.cooldown_s + 1)
        engine.plan()
        assert sorted(engine.in_flight().values()) == ["cordoned", "cordoned"]

    def test_pod_churn_resets_cooldown(self, harness):
        h = harness()
        engine = h.engine
        h.node("n0")
        h.node("n1")
        engine.plan()
        h.clock.advance(engine.config.cooldown_s - 5)
        h.pod("late", "n0")  # lands on n0 just before its cooldown expires
        engine.plan()
        h.clock.advance(10)
        engine.plan()
        flight = engine.in_flight()
        assert "n0" not in flight and "n1" in flight

    def test_nodes_without_group_ref_never_actuate(self, harness):
        h = harness()
        engine = h.engine
        h.node("n0", labels={"pool": "other"})  # outside every selector
        h.node("n1")
        engine.plan()
        h.clock.advance(engine.config.cooldown_s + 1)
        engine.plan()
        assert "n0" not in engine.in_flight()

    def test_snapshot_restore_resumes_each_phase(self, harness):
        """A restored engine resumes the cordoned node's soak instead of
        re-cordoning it, and releases an orphan cordon nobody owns."""
        h = harness()
        engine, store = h.engine, h.store
        for i in range(3):
            h.node(f"n{i}")
        h.pod("p0", "n0")
        engine.plan()
        h.clock.advance(engine.config.cooldown_s + 1)
        engine.plan()
        table = engine.snapshot_state()
        ((key, entry),) = table.items()
        assert entry["phase"] == "cordoned"
        orphan = store.get("Node", "default", "n0")
        orphan.spec.unschedulable = True
        orphan.metadata.annotations["karpenter.sh/consolidation-state"] = (
            "cordoned")
        store.update(orphan)
        fresh = ConsolidationEngine(store, solver_service=h.service,
                                    registry=GaugeRegistry(), clock=h.clock)
        fresh.restore_state(table)
        assert fresh.snapshot_state() == table
        assert not store.get("Node", "default", "n0").spec.unschedulable
        h.clock.advance(engine.config.verify_s + 1)
        fresh.plan()
        assert list(fresh.in_flight().values()) == ["draining"]


class TestScaleDownCondition:
    """A scale-down actuated while the group is unstable is surfaced as a
    structured condition on the API object."""

    def reconcile(self, stable):
        provider = FakeFactory()
        provider.node_replicas["grp-id"] = 3
        provider.node_group_stable = stable
        controller = ScalableNodeGroupController(provider)
        resource = ScalableNodeGroup(
            metadata=PORT.core.ObjectMeta(name="grp"),
            spec=ScalableNodeGroupSpec(
                replicas=1, type=FAKE_NODE_GROUP, id="grp-id"
            ),
        )
        controller.reconcile(resource)
        return provider, resource

    def test_unstable_scale_down_emits_structured_condition(self):
        provider, resource = self.reconcile(stable=False)
        assert provider.node_replicas["grp-id"] == 1  # still actuated
        condition = resource.status_conditions().get("Stabilized")
        assert condition.status == "False"
        assert condition.reason == "ScaleDownWhileUnstable"
        assert "3->1" in condition.message
        assert condition.last_transition_time > 0

    def test_stable_scale_down_leaves_condition_clean(self):
        provider, resource = self.reconcile(stable=True)
        assert provider.node_replicas["grp-id"] == 1
        condition = resource.status_conditions().get("Stabilized")
        assert condition.status == "True"
        assert condition.reason == ""


class TestProviderAndController:
    def test_registry_selects_the_fake(self):
        from karpenter_tpu_torch.cloudprovider import Options, registry

        assert isinstance(registry.new_factory(Options(), "fake"), FakeFactory)
        # aws and tpu are registered (cloudprovider/aws.py, tpu.py)
        assert type(registry.new_factory(Options(), "aws")).__name__ == (
            "AWSFactory")
        with pytest.raises(ValueError, match="unknown cloud provider"):
            registry.new_factory(Options(), "azure")
        missing = registry.new_factory(Options())
        assert missing.want_err is not None

    def test_fence_rejects_a_superseded_generation(self):
        from karpenter_tpu_torch.recovery.fence import (
            ActuationFence,
            FenceRejectedError,
        )

        provider = FakeFactory()
        group = provider.node_group_for(
            ScalableNodeGroupSpec(type=FAKE_NODE_GROUP, id="g")
        )
        group.set_replicas(4, token=ActuationFence(generation=2).token())
        with pytest.raises(FenceRejectedError):
            group.set_replicas(1, token=ActuationFence(generation=1).token())
        group.set_replicas(5)  # unstamped calls pass
        assert provider.node_replicas["g"] == 5
        assert provider.fence_validator.rejections == 1

    def test_breaker_opens_after_consecutive_provider_failures(self):
        from karpenter_tpu_torch.cloudprovider.fake import retryable_error

        clock = FakeClock()
        provider = FakeFactory()
        provider.want_err = retryable_error("Throttled")
        registry = GaugeRegistry()
        controller = ScalableNodeGroupController(
            provider, registry=registry, circuit_failure_threshold=2,
            circuit_reset_s=60.0, clock=clock,
        )
        resource = ScalableNodeGroup(
            metadata=PORT.core.ObjectMeta(name="grp"),
            spec=ScalableNodeGroupSpec(replicas=1, type=FAKE_NODE_GROUP,
                                       id="grp-id"),
        )
        for _ in range(3):
            controller.reconcile(resource)
        condition = resource.status_conditions().get("AbleToScale")
        assert condition.reason == "ActuationCircuitOpen"
        assert registry.gauge("resilience", "circuit_open_total").get(
            "grp", "default") == 1.0
        provider.want_err = None
        provider.node_replicas["grp-id"] = 1
        clock.advance(61.0)
        controller.reconcile(resource)
        assert resource.status_conditions().get("AbleToScale").status == "True"


def reference_disruption_api():
    from karpenter_tpu import consolidation, preemption, store
    from karpenter_tpu.api import (
        conditions,
        core,
        metricsproducer,
        scalablenodegroup,
    )
    from karpenter_tpu.cloudprovider import fake
    from karpenter_tpu.controllers import scalablenodegroup as sng
    from karpenter_tpu.metrics import registry
    from karpenter_tpu.utils import quantity

    return workloads.disruption_api_namespace({
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


WORLD = dict(nodes=40, pods=400, pending_critical=6, seed=0)
ROUNDS = 8


def run_world(which: str, backend: str):
    """(snapshots per round, error maps per round, verdicts, plans, service
    stats) of one disruption world over ROUNDS rounds."""
    if which == "port":
        svc = new_service(backend=backend)
        api = None
    else:
        svc = ref_solver.SolverService(registry=RefRegistry(), backend=backend)
        api = reference_disruption_api()
    try:
        world = workloads.build_disruption_world(**WORLD, service=svc, api=api)
        snaps, errors = [], []
        for _ in range(ROUNDS):
            errors.append({k: None if e is None else (type(e).__name__, str(e))
                           for k, e in world.round().items()})
            snaps.append(world.snapshot())
        return snaps, errors, world.verdicts, world.plans, svc.stats
    finally:
        svc.close()


class TestDisruptionWorldParity:
    @pytest.mark.parametrize("backend", ["torch", "numpy"])
    def test_port_equals_reference_every_round(self, backend):
        mine = run_world("port", backend)
        ref = run_world("ref", "numpy")
        for r, (a, b) in enumerate(zip(mine[0], ref[0])):
            for key in a:
                assert a[key] == b[key], (r, key)
        assert mine[1] == ref[1]
        assert mine[2] == ref[2]  # every consolidation plan's verdicts
        assert mine[3] == ref[3]  # every preemption plan's results
        # the world really ran the whole path: drains cordoned, verified,
        # actuated through spec.replicas and finished; evictions made
        last = mine[0][-1]
        assert "drains_actuated_total" in last["exposition"]
        assert sum(r for _, r in last["provider"]) < WORLD["nodes"]
        assert len(last["nodes"]) < WORLD["nodes"]
        evictions = sum(len(p["evictions"]) for _, plans in mine[3]
                        for p in plans.values() if p)
        assert evictions > 0
        assert len(last["pods"]) == WORLD["pods"] + WORLD["pending_critical"] - evictions
        stats = mine[4]
        assert stats.consolidate_calls >= 2 and stats.preempt_calls == ROUNDS
        assert stats.fallbacks == 0
        if backend == "torch":
            assert stats.preempt_dispatches == ROUNDS
            assert stats.dispatches == ROUNDS + stats.consolidate_calls
