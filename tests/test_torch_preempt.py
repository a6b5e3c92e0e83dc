"""The port's eviction-planning program (karpenter_tpu_torch/ops/preempt.py)
and the service's `preempt` family against the reference's, on the CPU.

Every output of the port's `preempt_plan` (PyTorch on the CPU) and its
copied `preempt_numpy` equals the reference's `preempt_plan` (XLA on the
CPU) and `preempt_numpy` on seeded numpy draws: integer arithmetic makes
the four bit-identical. The cases follow tests/test_preemption.py's
TestKernelParity, TestBatchedIndependence and TestKernelSemantics, plus
the victim ceiling V = MAX_VICTIMS = 16,384, where the prefix sums reach
2^30. The service's torch and numpy rungs answer the same plans, one
dispatch per request; TestCardFailurePolicy holds the card's policy (a
failure raises, nothing answers from numpy) on a CPU service.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

import bench
from karpenter_tpu.ops import preempt as RP
from karpenter_tpu.solver import bucketing as RB
from karpenter_tpu_torch import faults, workloads
from karpenter_tpu_torch.ops import preempt as P
from karpenter_tpu_torch.solver import SolverDeviceError
from karpenter_tpu_torch.solver import bucketing as B

from test_preemption import random_problem, single_candidate
from test_torch_solver_service import FakeClock, card_policy, new_service

FIELDS = ("chosen_node", "evict_count", "evict_mask", "unplaceable")


def host(out) -> dict:
    """Outputs of either package (tensors or arrays, or a dict of them)
    as numpy arrays."""
    if isinstance(out, dict):
        return {f: np.asarray(out[f]) for f in FIELDS}
    if isinstance(out, P.PreemptOutputs):
        return out.to_numpy()
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


def assert_plans_equal(got, want, context=""):
    got, want = host(got), host(want)
    for field in FIELDS:
        assert got[field].shape == want[field].shape, (field, context)
        assert np.array_equal(got[field], want[field]), (field, context)


def port_plan(inputs) -> dict:
    """The port's program on the CPU; its integer outputs stay int32."""
    out = P.preempt_plan(inputs, "cpu")
    got = out.to_numpy()
    assert got["chosen_node"].dtype == np.int32
    assert got["evict_count"].dtype == np.int32
    assert got["unplaceable"].dtype == np.int32 and got["unplaceable"].ndim == 0
    return got


def all_four(inputs, context=""):
    """Port program == port mirror == reference XLA == reference mirror."""
    want = RP.preempt_numpy(inputs)
    assert_plans_equal(port_plan(inputs), want, f"port plan {context}")
    assert_plans_equal(P.preempt_numpy(inputs), want, f"port mirror {context}")
    assert_plans_equal(
        RP.preempt_plan(jax.device_put(inputs)), want, f"ref xla {context}"
    )
    return want


def ceiling_inputs(extra: float = 0.0):
    """V = MAX_VICTIMS victims of 1.0 each on node 0, whose free capacity
    is 0: each victim sheds exactly QUANT, the full prefix is 2^30, and a
    candidate asking for all of it (plus `extra`) sits at the i32 edge."""
    v = P.MAX_VICTIMS
    return RP.PreemptInputs(
        pod_requests=np.array([[float(v) + extra], [0.5]], np.float32),
        pod_priority=np.array([100, 100], np.int32),
        pod_valid=np.ones(2, bool),
        pod_node_forbidden=np.zeros((2, 2), bool),
        node_free=np.array([[0.0], [0.5]], np.float32),
        node_tier=np.zeros(2, np.int32),
        victim_requests=np.ones((v, 1), np.float32),
        victim_priority=np.arange(v, dtype=np.int32) % 50,
        victim_node=np.zeros(v, np.int32),
        victim_valid=np.ones(v, bool),
        victim_evictable=np.ones(v, bool),
    )


class TestKernelParity:
    @pytest.mark.parametrize("seed", range(5))
    def test_port_equals_reference_bit_identically(self, seed):
        rng = np.random.default_rng(7 + 100 * seed)
        for trial in range(8):
            all_four(random_problem(rng), f"(seed {seed}, trial {trial})")

    @pytest.mark.parametrize("seed", [11, 12])
    def test_parity_survives_bucket_padding(self, seed):
        rng = np.random.default_rng(seed)
        for trial in range(6):
            inputs = random_problem(rng)
            c = inputs.pod_requests.shape[0]
            v = inputs.victim_requests.shape[0]
            shape = B.preempt_bucket_shape(inputs)
            assert shape == RB.preempt_bucket_shape(inputs)
            padded = B.pad_preempt_inputs(inputs, shape)
            ref_padded = RB.pad_preempt_inputs(inputs, shape)
            for f in dataclasses.fields(ref_padded):
                a = np.asarray(getattr(padded, f.name))
                b = np.asarray(getattr(ref_padded, f.name))
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            cropped = B.crop_preempt_outputs(
                P.PreemptOutputs(**port_plan(padded)), c, v
            )
            assert_plans_equal(
                cropped, RP.preempt_numpy(inputs), f"(trial {trial})"
            )

    def test_quantization_scale_is_candidate_independent(self):
        inputs = RP.PreemptInputs(
            pod_requests=np.array(
                [[1.17], [2.87], [0.83], [2.60], [4.34]], np.float32
            ),
            pod_priority=np.full(5, 100, np.int32),
            pod_valid=np.ones(5, bool),
            pod_node_forbidden=np.zeros((5, 1), bool),
            node_free=np.array([[2.6019135]], np.float32),
            node_tier=np.zeros(1, np.int32),
            victim_requests=np.zeros((0, 1), np.float32),
            victim_priority=np.zeros(0, np.int32),
            victim_node=np.zeros(0, np.int32),
            victim_valid=np.zeros(0, bool),
            victim_evictable=np.zeros(0, bool),
        )
        batched = all_four(inputs)
        for c in range(5):
            one = port_plan(single_candidate(inputs, c))
            assert int(one["chosen_node"][0]) == int(
                batched.chosen_node[c]
            ), f"candidate {c}"

    def test_nodeless_fleet_is_unplaceable(self):
        """N = 0 (a full spot reclaim): every valid candidate unplaceable,
        on the static branch of both programs."""
        inputs = RP.PreemptInputs(
            pod_requests=np.array([[1.0], [2.0]], np.float32),
            pod_priority=np.array([100, 50], np.int32),
            pod_valid=np.array([True, False]),
            pod_node_forbidden=np.zeros((2, 0), bool),
            node_free=np.zeros((0, 1), np.float32),
            node_tier=np.zeros(0, np.int32),
            victim_requests=np.zeros((0, 1), np.float32),
            victim_priority=np.zeros(0, np.int32),
            victim_node=np.zeros(0, np.int32),
            victim_valid=np.zeros(0, bool),
            victim_evictable=np.zeros(0, bool),
        )
        all_four(inputs)
        got = port_plan(inputs)
        assert got["chosen_node"].tolist() == [-1, -1]
        assert int(got["unplaceable"]) == 1

    @pytest.mark.parametrize("seed", [3, 4])
    def test_empty_victim_axis(self, seed):
        inputs = random_problem(np.random.default_rng(seed), v=0)
        all_four(inputs, "(V=0)")
        for backend in ("torch", "numpy"):
            out = host(P.solve_preempt(inputs, backend=backend, device="cpu"))
            # with no victims every plan is a zero-eviction fit or nothing
            assert (out["evict_count"] == 0).all()
            assert out["evict_mask"].shape == (inputs.pod_requests.shape[0], 0)

    def test_plans_actually_fit(self):
        """Conservative quantization: a plan's freed + free capacity
        covers the candidate — never an under-eviction."""
        rng = np.random.default_rng(5)
        for _ in range(10):
            inputs = random_problem(rng)
            out = port_plan(inputs)
            for c, col in enumerate(out["chosen_node"].tolist()):
                if col < 0:
                    continue
                freed = inputs.victim_requests[out["evict_mask"][c]].sum(axis=0)
                assert (
                    inputs.node_free[col] + freed + 1e-3
                    >= inputs.pod_requests[c]
                ).all()

    def test_victim_ceiling_at_the_i32_headroom(self):
        """V = 16,384: the inclusive prefix on node 0 reaches 2^30 = V *
        QUANT; a candidate needing all of it evicts every victim, one
        needing a little more than any prefix is unplaceable (its need
        clips below 2^31), in every program."""
        want = all_four(ceiling_inputs(), "(ceiling)")
        got = port_plan(ceiling_inputs())
        assert got["chosen_node"].tolist() == [0, 1]
        assert int(got["evict_count"][0]) == P.MAX_VICTIMS
        assert int(got["evict_mask"][0].sum()) == P.MAX_VICTIMS
        assert int(want.unplaceable) == 0
        over = all_four(ceiling_inputs(extra=64.0), "(past the ceiling)")
        assert int(np.asarray(over.chosen_node)[0]) == -1
        assert int(over.unplaceable) == 1

    def test_bench_fleet_at_the_victim_ceiling(self):
        """bench.py's eviction fleet at 64 candidates x 2,000 nodes x
        16,384 victims (the chip smoke's seam):
        workloads.build_preempt_inputs draws the bench's arrays, and all
        four programs plan them equally."""
        mine = workloads.build_preempt_inputs(64, 2000, 16384, seed=0)
        ref = bench.build_preempt_inputs(64, 2000, 16384, seed=0)
        for f in dataclasses.fields(ref):
            a, b = getattr(mine, f.name), getattr(ref, f.name)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        want = all_four(ref, "(bench fleet)")
        assert int(np.asarray(want.evict_count).max()) > 0

    def test_more_victims_than_the_ceiling_refused(self):
        rng = np.random.default_rng(9)
        inputs = random_problem(rng, c=1, n=2, v=P.MAX_VICTIMS + 1, r=1)
        with pytest.raises(ValueError, match="at most"):
            P.solve_preempt(inputs, backend="numpy")
        svc = new_service()
        try:
            with pytest.raises(ValueError, match="at most"):
                svc.preempt(inputs)
        finally:
            svc.close()


class TestBatchedIndependence:
    @pytest.mark.parametrize("seed", [13, 14])
    def test_batched_equals_per_candidate(self, seed):
        rng = np.random.default_rng(seed)
        for trial in range(6):
            inputs = random_problem(rng)
            batched = port_plan(inputs)
            for c in range(inputs.pod_requests.shape[0]):
                one = port_plan(single_candidate(inputs, c))
                for field in ("chosen_node", "evict_count"):
                    assert one[field][0] == batched[field][c], (field, c)
                assert np.array_equal(
                    one["evict_mask"][0], batched["evict_mask"][c]
                )

    def test_batched_equals_per_candidate_in_the_mirror(self):
        rng = np.random.default_rng(17)
        inputs = random_problem(rng, c=6, n=5, v=24, r=3)
        batched = host(P.preempt_numpy(inputs))
        for c in range(6):
            one = host(P.preempt_numpy(single_candidate(inputs, c)))
            assert int(one["chosen_node"][0]) == int(batched["chosen_node"][c])
            assert int(one["evict_count"][0]) == int(batched["evict_count"][c])


class TestKernelSemantics:
    def fleet(self):
        """One node with no free cpu, three 1-cpu victims at priorities
        10/20/30."""
        return RP.PreemptInputs(
            pod_requests=np.array([[2.0]], np.float32),
            pod_priority=np.array([100], np.int32),
            pod_valid=np.ones(1, bool),
            pod_node_forbidden=np.zeros((1, 1), bool),
            node_free=np.array([[0.0]], np.float32),
            node_tier=np.zeros(1, np.int32),
            victim_requests=np.array([[1.0], [1.0], [1.0]], np.float32),
            victim_priority=np.array([10, 20, 30], np.int32),
            victim_node=np.zeros(3, np.int32),
            victim_valid=np.ones(3, bool),
            victim_evictable=np.ones(3, bool),
        )

    def plan(self, **changes):
        inputs = dataclasses.replace(self.fleet(), **changes)
        all_four(inputs)
        return port_plan(inputs)

    def test_minimal_prefix_evicts_lowest_priority_first(self):
        out = self.plan()
        assert int(out["chosen_node"][0]) == 0
        assert int(out["evict_count"][0]) == 2
        assert out["evict_mask"][0].tolist() == [True, True, False]

    def test_higher_priority_victims_are_protected(self):
        out = self.plan(pod_priority=np.array([15], np.int32))
        assert int(out["chosen_node"][0]) == -1
        assert int(out["unplaceable"]) == 1

    def test_spot_tier_is_evictable_by_contract(self):
        out = self.plan(
            pod_priority=np.array([15], np.int32),
            node_tier=np.ones(1, np.int32),
        )
        assert int(out["chosen_node"][0]) == 0
        assert int(out["evict_count"][0]) == 2

    def test_do_not_disrupt_mask_respected(self):
        out = self.plan(victim_evictable=np.array([False, True, True]))
        assert out["evict_mask"][0].tolist() == [False, True, True]

    def test_zero_eviction_fit_wins(self):
        out = self.plan(
            node_free=np.array([[0.0], [2.0]], np.float32),
            node_tier=np.zeros(2, np.int32),
            pod_node_forbidden=np.zeros((1, 2), bool),
        )
        assert int(out["chosen_node"][0]) == 1
        assert int(out["evict_count"][0]) == 0


class TestServiceSeam:
    @pytest.mark.parametrize("backend", ["torch", "numpy"])
    def test_rungs_match_the_reference_one_dispatch_per_request(self, backend):
        rng = np.random.default_rng(29)
        svc = new_service(backend=backend)
        try:
            first = random_problem(rng, c=4, n=6, v=30, r=3)
            assert_plans_equal(svc.preempt(first), RP.preempt_numpy(first))
            # jittered sizes inside one rung: no new dispatch key
            misses = svc.stats.compile_cache_misses
            again = random_problem(rng, c=5, n=6, v=28, r=3)
            assert_plans_equal(svc.preempt(again), RP.preempt_numpy(again))
            assert svc.stats.compile_cache_misses == misses
            assert svc.stats.preempt_calls == 2
            assert svc.stats.preempt_candidates == 9
            want = 2 if backend == "torch" else 0
            assert svc.stats.preempt_dispatches == want
            assert svc.stats.dispatches == want
            assert svc.stats.fallbacks == 0
        finally:
            svc.close()

    def test_reference_inputs_go_in_unchanged(self):
        """The reference's PreemptInputs, the port's and a dict of its
        arrays give the same plans through the torch rung."""
        rng = np.random.default_rng(41)
        inputs = random_problem(rng, c=7, n=9, v=33, r=2)
        want = RP.preempt_numpy(inputs)
        as_dict = {f.name: getattr(inputs, f.name)
                   for f in dataclasses.fields(inputs)}
        svc = new_service(backend="torch")
        try:
            for given in (inputs, P.PreemptInputs(**as_dict), as_dict):
                assert_plans_equal(svc.preempt(given), want)
        finally:
            svc.close()

    def test_empty_candidate_axis_short_circuits(self):
        svc = new_service(backend="torch")
        try:
            inputs = random_problem(np.random.default_rng(31), c=1, n=2,
                                    v=4, r=2)
            empty = dataclasses.replace(
                inputs,
                pod_requests=inputs.pod_requests[:0],
                pod_priority=inputs.pod_priority[:0],
                pod_valid=inputs.pod_valid[:0],
                pod_node_forbidden=inputs.pod_node_forbidden[:0],
            )
            out = svc.preempt(empty)
            assert np.asarray(out.chosen_node).shape == (0,)
            assert np.asarray(out.evict_mask).shape == (0, 4)
            assert svc.stats.dispatches == 0
        finally:
            svc.close()

    def test_cpu_ladder_answers_a_failure_from_the_mirror(self):
        rng = np.random.default_rng(43)
        inputs = random_problem(rng, c=3, n=4, v=12, r=2)
        svc = new_service(backend="torch")
        try:
            with faults.injected_faults(seed=1) as reg:
                reg.plan("preempt.plan", mode="error")
                assert_plans_equal(svc.preempt(inputs),
                                   RP.preempt_numpy(inputs))
            assert svc.stats.device_failures == 1
            assert svc.stats.fallbacks == 1
            assert svc.stats.preempt_dispatches == 0
        finally:
            svc.close()


class TestCardFailurePolicy:
    def test_failure_raises_then_degraded_then_the_probe_heals(self):
        clock = FakeClock()
        svc = card_policy(new_service(
            backend="torch", clock=clock, health_failure_threshold=2,
            health_probe_interval_s=30.0,
        ))
        inputs = random_problem(np.random.default_rng(47), c=3, n=4, v=12,
                                r=2)
        try:
            with faults.injected_faults(seed=2) as reg:
                reg.plan("preempt.plan", mode="error")
                for _ in range(2):
                    with pytest.raises(faults.FaultInjected):
                        svc.preempt(inputs)
                assert svc.backend_health() == "degraded"
                attempts = reg.attempts["preempt.plan"]
                with pytest.raises(SolverDeviceError, match="degraded"):
                    svc.preempt(inputs)
                assert reg.attempts["preempt.plan"] == attempts
            clock.advance(31.0)
            assert_plans_equal(svc.preempt(inputs), RP.preempt_numpy(inputs))
            assert svc.backend_health() == "healthy"
            assert svc.stats.fallbacks == 0
        finally:
            svc.close()


# -- the preemption engine through the port (tests/test_preemption.py TestEngine)

from karpenter_tpu_torch.api.core import (  # noqa: E402
    Container,
    Node,
    NodeCondition,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodSpec,
)
from karpenter_tpu_torch.api.metricsproducer import (  # noqa: E402
    MetricsProducer,
    MetricsProducerSpec,
    PendingCapacitySpec,
)
from karpenter_tpu_torch.api.scalablenodegroup import (  # noqa: E402
    ScalableNodeGroup,
    ScalableNodeGroupSpec,
)
from karpenter_tpu_torch.consolidation import ConsolidationEngine  # noqa: E402
from karpenter_tpu_torch.consolidation.planner import cluster_view  # noqa: E402
from karpenter_tpu_torch.preemption import (  # noqa: E402
    PreemptionConfig,
    PreemptionEngine,
)
from karpenter_tpu_torch.store import Store  # noqa: E402
from karpenter_tpu_torch.utils.quantity import Quantity  # noqa: E402


def q(value):
    return Quantity.parse(str(value))


def make_node(name, labels=None, cpu="4", ready=True):
    return Node(
        metadata=ObjectMeta(name=name, labels=dict(labels or {"pool": "a"})),
        spec=NodeSpec(),
        status=NodeStatus(
            allocatable={"cpu": q(cpu), "memory": q("8Gi"), "pods": q("16")},
            conditions=[NodeCondition("Ready", "True" if ready else "False")],
        ),
    )


def make_pod(name, node=None, cpu="1", priority=None, annotations=None):
    return Pod(
        metadata=ObjectMeta(name=name, annotations=dict(annotations or {})),
        spec=PodSpec(
            node_name=node or "",
            priority=priority,
            containers=[Container(requests={"cpu": q(cpu), "memory": q("1Gi")})],
        ),
    )


def storm_store(eviction_budget=None, preemptible=False):
    """Two 4-cpu nodes, each full of four priority-0 1-cpu pods."""
    store = Store()
    store.create(MetricsProducer(
        metadata=ObjectMeta(name="pool"),
        spec=MetricsProducerSpec(pending_capacity=PendingCapacitySpec(
            node_selector={"pool": "a"}, node_group_ref="grp",
        )),
    ))
    store.create(ScalableNodeGroup(
        metadata=ObjectMeta(name="grp"),
        spec=ScalableNodeGroupSpec(
            replicas=2, type="FakeNodeGroup", id="grp",
            preemptible=preemptible, eviction_budget=eviction_budget,
        ),
    ))
    for name in ("n1", "n2"):
        store.create(make_node(name))
        for i in range(4):
            store.create(make_pod(f"{name}-batch-{i}", node=name, priority=0))
    return store


def bound(store) -> int:
    return sum(1 for p in store.list("Pod") if p.spec.node_name)


@pytest.fixture
def engine_for():
    made = []

    def build(store, clock=None, consolidation=None, **config):
        svc = new_service(backend="torch")
        made.append(svc)
        return PreemptionEngine(
            store, svc, consolidation=consolidation,
            config=PreemptionConfig(
                min_candidate_priority=1, plan_interval_s=0.0, **config
            ),
            clock=clock,
        )

    yield build
    for svc in made:
        svc.close()


class TestEngine:
    def test_evicts_lowest_priority_to_admit_candidate(self, engine_for):
        store = storm_store(eviction_budget=4)
        store.create(make_pod("critical", cpu="2", priority=1000))
        engine = engine_for(store)
        plan = engine.plan()[("default", "critical")]
        assert plan is not None and len(plan["evictions"]) == 2
        assert all(store.try_get("Pod", ns, name) is None
                   for ns, name in plan["evictions"])
        assert engine.service.stats.preempt_dispatches == 1

    def test_budget_never_exceeded(self, engine_for):
        store = storm_store(eviction_budget=1)
        store.create(make_pod("critical", cpu="2", priority=1000))
        engine = engine_for(store)
        # 2 evictions needed, budget 1: deferred, not trimmed
        assert engine.plan()[("default", "critical")] is None
        assert bound(store) == 8

    def test_no_duplicate_evictions_across_conflicting_plans(self, engine_for):
        store = storm_store(eviction_budget=8)
        store.create(make_pod("crit-a", cpu="2", priority=1000))
        store.create(make_pod("crit-b", cpu="2", priority=900))
        accepted = [p for p in engine_for(store).plan().values() if p]
        evicted = [key for p in accepted for key in p["evictions"]]
        assert len(evicted) == len(set(evicted))
        nodes = [p["node"] for p in accepted]
        assert len(nodes) == len(set(nodes))

    def test_do_not_disrupt_pod_never_evicted(self, engine_for):
        store = storm_store(eviction_budget=8)
        for name in ("n1", "n2"):
            for i in range(4):
                pod = store.get("Pod", "default", f"{name}-batch-{i}")
                pod.metadata.annotations["karpenter.sh/do-not-disrupt"] = "true"
                store.update(pod)
        store.create(make_pod("critical", cpu="2", priority=1000))
        assert engine_for(store).plan()[("default", "critical")] is None
        assert bound(store) == 8

    def test_candidate_hold_prevents_amplification(self, engine_for):
        store = storm_store(eviction_budget=8)
        store.create(make_pod("critical", cpu="2", priority=1000))
        engine = engine_for(store)
        assert engine.plan()[("default", "critical")] is not None
        assert engine.plan() == {}
        assert bound(store) == 6

    def test_partial_actuation_is_not_an_accepted_plan(self, engine_for):
        store = storm_store(eviction_budget=4)
        store.create(make_pod("critical", cpu="2", priority=1000))
        engine = engine_for(store)
        real_delete = store.delete
        vetoed = {"n": 0}

        def flaky_delete(kind, namespace=None, name=None):
            if name == "n1-batch-1" and vetoed["n"] == 0:
                vetoed["n"] += 1
                raise RuntimeError("conflict")
            return real_delete(kind, namespace, name)

        store.delete = flaky_delete
        try:
            assert engine.plan()[("default", "critical")] is None
            assert ("default", "critical") not in engine._candidate_holds
            again = engine.plan(engine.clock() + 1.0)
            assert again[("default", "critical")] is not None
        finally:
            store.delete = real_delete

    def test_ungrouped_nodes_budget_independently(self):
        key = PreemptionEngine._budget_key
        assert key(("default", "pool", "grp"), "n1") == ("default", "grp")
        assert key(None, "n1") != key(None, "n2")

    def test_consolidation_coordination_both_ways(self, engine_for):
        store = storm_store(eviction_budget=8)
        store.create(make_pod("critical", cpu="2", priority=1000))
        consolidation = ConsolidationEngine(
            store, solver_service=new_service(backend="torch")
        )
        try:
            engine = engine_for(store, consolidation=consolidation)
            consolidation.node_guard = engine.active_nodes
            # consolidation owns n1: preemption must plan around it
            consolidation._in_flight["n1"] = type(
                "S", (), {"node": "n1", "group": ("default", "x", "grp"),
                          "phase": "cordoned", "since": 0.0}
            )()
            plan = engine.plan()[("default", "critical")]
            assert plan is not None and plan["node"] == "n2"
            # ...and the preemption hold guards n2 from consolidation
            assert "n2" in engine.active_nodes()
            view_node = next(nv for nv in cluster_view(store).nodes
                             if nv.name == "n2")
            assert not consolidation._eligible(
                view_node, now=1e9, guarded=consolidation.node_guard()
            )
        finally:
            consolidation.service.close()

    def test_snapshot_restore_round_trip(self, engine_for):
        """Holds, candidate holds and budget charges survive a restart:
        a fresh engine restored from the snapshot reports the same table,
        and keeps the spent budget spent."""
        clock = FakeClock(5000.0)
        store = storm_store(eviction_budget=2)
        store.create(make_pod("critical", cpu="2", priority=1000))
        engine = engine_for(store, clock=clock)
        assert engine.plan()[("default", "critical")] is not None
        table = engine.snapshot_state()
        assert set(k.split(",")[0] for k in table) == {
            '["cand"', '["charge"', '["hold"'
        }
        fresh = engine_for(store, clock=clock)
        fresh.restore_state(table)
        assert fresh.snapshot_state() == table
        assert fresh.active_nodes() == engine.active_nodes()
        assert fresh._budget_left(("default", "pool", "grp"), "n1") == 0
        clock.advance(engine.config.hold_s + 1.0)
        expired = engine_for(store, clock=clock)
        expired.restore_state(table)
        assert expired.snapshot_state() == {}
