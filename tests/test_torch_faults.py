"""The port's fault-injection registry (karpenter_tpu_torch/faults) and its
injection points against the reference's, on the CPU.

Every test body runs once per package: the same plan against the same
point must fire (or pass) in the port exactly as it does in the
reference. Points covered: store.patch_status (store/store.py),
encoder.encode and constraints.mask (the pending-capacity encoder), and
solver.dispatch (the solve service, where an error plan degrades the
request to the numpy rung).
"""

from __future__ import annotations

import importlib
import threading

import numpy as np
import pytest

from tests.test_torch_encoder import _fresh_state  # noqa: F401 — autouse reset

PKGS = {"ref": "karpenter_tpu", "port": "karpenter_tpu_torch"}
SIDES = pytest.mark.parametrize("side", sorted(PKGS))


def mod(side, name):
    return importlib.import_module(f"{PKGS[side]}.{name}")


@pytest.fixture(autouse=True)
def _no_leaked_registry():
    yield
    for side in PKGS:
        mod(side, "faults").uninstall()


class TestFaultRegistry:
    @SIDES
    def test_inactive_is_noop(self, side):
        mod(side, "faults").inject("solver.dispatch")

    @SIDES
    def test_error_plan_raises_typed_retryable(self, side):
        faults = mod(side, "faults")
        errors = mod(side, "controllers.errors")
        with faults.FaultRegistry(seed=1) as reg:
            reg.plan("p", mode="error", code="Throttling")
            with pytest.raises(faults.FaultInjected) as e:
                faults.inject("p")
            assert e.value.code == "Throttling"
            assert errors.is_retryable(e.value)
            reg.plan("q", retryable=False)
            with pytest.raises(faults.FaultInjected) as e:
                faults.inject("q")
            assert not errors.is_retryable(e.value)

    @SIDES
    def test_flaky_fails_first_n_then_passes(self, side):
        faults = mod(side, "faults")
        with faults.FaultRegistry(seed=1) as reg:
            plan = reg.plan("p", mode="flaky", times=3)
            for _ in range(3):
                with pytest.raises(faults.FaultInjected):
                    faults.inject("p")
            for _ in range(10):
                faults.inject("p")
            assert (plan.fired, plan.attempts) == (3, 13)

    @SIDES
    def test_hang_blocks_until_released_then_raises(self, side):
        faults = mod(side, "faults")
        reg = faults.install(faults.FaultRegistry(seed=1))
        reg.plan("p", mode="hang", times=1)
        state = {}

        def hit():
            try:
                faults.inject("p")
            except faults.FaultInjected as e:
                state["error"] = e

        thread = threading.Thread(target=hit, daemon=True)
        thread.start()
        thread.join(timeout=0.1)
        assert thread.is_alive()
        faults.uninstall()
        thread.join(timeout=5.0)
        assert not thread.is_alive()
        assert state["error"].code == "FaultHangReleased"

    def test_probability_sequence_equals_reference(self):
        """The same seed replays the same fire/skip sequence in both
        packages (each plan's stream is seeded from (seed, plan index))."""

        def pattern(side, seed):
            faults = mod(side, "faults")
            reg = faults.FaultRegistry(seed=seed)
            reg.plan("p", probability=0.5)
            fired = []
            with reg:
                for _ in range(64):
                    try:
                        faults.inject("p")
                        fired.append(False)
                    except faults.FaultInjected:
                        fired.append(True)
            return fired

        for seed in (7, 8):
            assert pattern("port", seed) == pattern("ref", seed)
        assert any(pattern("port", 7)) and not all(pattern("port", 7))

    @SIDES
    def test_counters_metrics_and_flight_recorder(self, side):
        faults = mod(side, "faults")
        gauges = mod(side, "metrics.registry").GaugeRegistry()
        recorder = mod(side, "observability").reset_default_flight_recorder()
        with faults.FaultRegistry(seed=1, registry=gauges) as reg:
            reg.plan("cloud.*", times=1)
            with pytest.raises(faults.FaultInjected):
                faults.inject("cloud.get_replicas")
            faults.inject("cloud.get_replicas")
            faults.inject("q")
        assert reg.attempts == {"cloud.get_replicas": 2, "q": 1}
        assert reg.injected == {"cloud.get_replicas": 1}
        text = gauges.expose_text()
        assert 'karpenter_faults_injected_total{name="cloud.get_replicas"' in text
        events = recorder.events("fault_injected")
        assert [(e["point"], e["mode"]) for e in events] == [
            ("cloud.get_replicas", "error")
        ]


class TestInjectionPoints:
    @SIDES
    def test_store_patch_status(self, side):
        core = mod(side, "api.core")
        store = mod(side, "store").Store()
        stored = store.create(core.Pod(
            metadata=core.ObjectMeta(name="p", namespace="default"),
            spec=core.PodSpec(containers=[]),
            status=core.PodStatus(phase="Pending"),
        ))
        faults = mod(side, "faults")
        with faults.FaultRegistry(seed=1) as reg:
            reg.plan("store.patch_status", times=1)
            with pytest.raises(faults.FaultInjected):
                store.patch_status(stored)
            store.patch_status(stored)  # exhausted: healthy again
            assert reg.attempts == {"store.patch_status": 2}

    @SIDES
    def test_encoder_encode(self, side):
        encode = mod(side, "metrics.producers.pendingcapacity").encode_snapshot
        faults = mod(side, "faults")
        with faults.FaultRegistry(seed=1) as reg:
            reg.plan("encoder.encode")
            with pytest.raises(faults.FaultInjected):
                encode(None, [])

    @SIDES
    def test_constraints_mask_falls_back_to_unconstrained(self, side):
        """A compile fault at constraints.mask degrades that encode to
        the unconstrained wire (operands None), counted and fed to the
        breaker; with the fault cleared the next encode compiles."""
        core = mod(side, "api.core")
        E = mod(side, "metrics.producers.pendingcapacity.encoder")
        encode = mod(side, "metrics.producers.pendingcapacity").encode_snapshot
        B = mod(side, "ops.binpack")
        snapshot_from_pods = mod(side, "store.columnar").snapshot_from_pods
        group = mod(side, "constraints").ConstraintGroup
        faults = mod(side, "faults")
        pods = [core.Pod(
            metadata=core.ObjectMeta(name="p0", labels={"t": "1"}),
            spec=core.PodSpec(node_name="", containers=[core.Container(
                requests=core.resource_list(cpu="1", memory="1Gi")
            )]),
        )]
        profiles = [({"cpu": 8.0, "memory": 32.0, "pods": 32.0},
                     set(), set())]
        groups = [group(name="a", pod_selector={"t": "1"},
                        anti_affinity=True)]
        with faults.FaultRegistry(seed=1) as reg:
            reg.plan("constraints.mask", mode="error")
            inputs = encode(snapshot_from_pods(pods), profiles,
                            constraints=groups)
        assert not B.has_constraint_operands(inputs)
        assert E.constraint_stats["fallbacks"] == 1
        assert E.constraint_stats["degraded"]
        assert E._constraint_breaker.consecutive_failures == 1
        inputs = encode(snapshot_from_pods(pods), profiles,
                        constraints=groups)
        assert np.asarray(inputs.pod_exclusive).any()
        assert E.constraint_stats["compiles"] == 1
        assert not E.constraint_stats["degraded"]

    @SIDES
    def test_solver_dispatch_falls_back_to_numpy(self, side):
        from test_binpack import make_inputs

        ref = make_inputs(pod_requests=[[1, 1], [3, 1]],
                          group_allocatable=[[4, 4]])
        B = mod(side, "ops.binpack")
        inputs = B.BinPackInputs(**{
            name: (None if getattr(ref, name) is None
                   else np.asarray(getattr(ref, name)))
            for name in B.BinPackInputs.__dataclass_fields__
        })
        registry = mod(side, "metrics.registry").GaugeRegistry()
        kwargs = ({"device": "cpu", "backend": "torch"} if side == "port"
                  else {"backend": "xla"})
        service = mod(side, "solver").SolverService(
            registry=registry, health_failure_threshold=100, **kwargs
        )
        faults = mod(side, "faults")
        try:
            with faults.FaultRegistry(seed=1) as reg:
                reg.plan("solver.dispatch", times=1)
                out = service.solve(inputs, buckets=8)
            want = mod(side, "ops.numpy_binpack").binpack_numpy(
                inputs, buckets=8
            )
            np.testing.assert_array_equal(
                np.asarray(out.assigned), np.asarray(want.assigned)
            )
            assert service.stats.fallbacks == 1
            assert service.stats.device_failures == 1
            assert reg.injected == {"solver.dispatch": 1}
        finally:
            service.close()
