"""The port's shared solve service (karpenter_tpu_torch/solver) against the
reference's (karpenter_tpu/solver), on the CPU.

The port's service runs with device="cpu" on its `torch` rung (the
coalesced, pipelined batch of the plain program) and its `numpy` rung;
the reference's with backend="xla" and backend="numpy" under
JAX_PLATFORMS=cpu. Inputs are tests/test_solver_service.py's seeded
draws (integer-valued requests, so every float sum is exact), handed to
both packages as the same numpy arrays.

Tolerance: assigned, assigned_count, nodes_needed and unschedulable are
exact. lp_bound is exact except at the f32 boundary ROADMAP Queue 3
documents (a group whose demand/allocatable lies within 1e-5 of an
integer, where one f32 ulp exceeds the ceil guard); these draws never
reach it, so every comparison here is exact on all five outputs.

On the CPU the port keeps the reference's never-block ladder (a failed,
hung, saturated or expired device path is answered from numpy); on the
card it raises instead. TestCardFailurePolicy holds the card's policy
here, on a CPU service given it (card_policy).

Every test that starts a worker closes its service in `finally`; waits
are bounded by timeouts, and no sleep is longer than 0.1 s.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time

import numpy as np
import pytest
import torch

import karpenter_tpu.solver as ref_solver
from karpenter_tpu.metrics.registry import GaugeRegistry as RefRegistry
from karpenter_tpu.ops import binpack as RB
from karpenter_tpu.solver import bucketing as ref_bucketing
from karpenter_tpu_torch import faults
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops.numpy_binpack import binpack_numpy
from karpenter_tpu_torch.solver import (
    SolverDeviceError,
    SolverSaturated,
    SolverService,
    SolverTimeout,
    bucketing,
)
from karpenter_tpu_torch.solver import service as S
from test_solver_service import make_inputs as ref_make_inputs
from test_torch_binpack import constraint_fields
from tests.test_torch_encoder import _fresh_state  # noqa: F401 — autouse reset

OUTPUT_FIELDS = (
    "assigned", "assigned_count", "nodes_needed", "lp_bound", "unschedulable"
)


def to_port(ref_inputs, **extra):
    fields = {
        f.name: (None if getattr(ref_inputs, f.name) is None
                 else np.asarray(getattr(ref_inputs, f.name)))
        for f in dataclasses.fields(ref_inputs)
    }
    fields.update(extra)
    return TB.BinPackInputs(**fields)


def make_inputs(pods, types, seed=0, weighted=False, constrained=False):
    return to_port(ref_make_inputs(pods, types, seed, weighted, constrained))


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_outputs_equal(got, want, what=""):
    for name in OUTPUT_FIELDS:
        np.testing.assert_array_equal(
            host(getattr(got, name)), host(getattr(want, name)),
            err_msg=f"{what}{name}",
        )


def direct(inputs, buckets=32):
    """A direct solve of the port's plain program on the CPU."""
    return TB.solve(inputs, buckets=buckets, backend="torch", device="cpu")


def new_service(**kwargs):
    kwargs.setdefault("registry", GaugeRegistry())
    return SolverService(device="cpu", **kwargs)


def card_policy(svc):
    """A CPU service under the card's failure policy, as
    SolverService(device="cuda") sets it at construction (pinned by
    TestCardFailurePolicy.test_the_card_sets_the_policy): no numpy
    ladder, deadlines raise."""
    svc._numpy_ladder = False
    svc.on_timeout = "raise"
    return svc


def explode_in_flight(monkeypatch):
    """Make the torch rung's batched program return outputs whose fetch
    raises: a failure that surfaces at drain time, not at dispatch."""
    real = S.run_batched

    class Exploding:
        shape = (1, 0)

        def reshape(self, *args):
            raise RuntimeError("injected in-flight failure")

    monkeypatch.setattr(S, "run_batched", lambda stacked, buckets: (
        dataclasses.replace(real(stacked, buckets), lp_bound=Exploding())))


@pytest.fixture
def service():
    svc = new_service(window_s=0.05, max_batch=8)
    yield svc
    svc.close()


class FakeClock:
    def __init__(self, now=1000.0):
        self.now = now
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            return self.now

    def advance(self, dt):
        with self._lock:
            self.now += dt


class TestBucketLadder:
    def test_bucket_up_equals_reference(self):
        for floor in (1, 2, 4, 8, 32, 64, 256):
            for n in range(0, 5000, 7):
                assert bucketing.bucket_up(n, floor) == \
                    ref_bucketing.bucket_up(n, floor), (n, floor)
        assert bucketing.bucket_up(100_000, 256) == 131_072
        assert bucketing.bucket_up(300, 8) == 384
        assert bucketing.bucket_up(3, bucketing.RESOURCE_FLOOR) == 4

    @pytest.mark.parametrize(
        "case", ["plain", "weighted", "constrained", "constraint_plane",
                 "priority", "at_bucket"],
    )
    def test_pad_to_bucket_byte_equal_to_reference(self, case):
        rng = np.random.default_rng(3)
        pods, types = (256, 8) if case == "at_bucket" else (300, 12)
        ref = ref_make_inputs(pods, types, seed=7,
                              weighted=case != "plain",
                              constrained=case == "constrained")
        if case == "constraint_plane":
            ref = dataclasses.replace(ref, **constraint_fields(
                rng, pods, types,
                ("pod_claim", "group_reservation", "pod_pack_class",
                 "pod_spread_slot", "group_domain", "spread_cap"),
            ))
        if case == "priority":
            ref = dataclasses.replace(
                ref, pod_priority=rng.integers(0, 3, pods).astype(np.int32),
                group_tier=rng.integers(0, 2, types).astype(np.int32),
            )
        port = to_port(ref)
        shape = bucketing.bucket_shape(port)
        assert shape == ref_bucketing.bucket_shape(ref)
        assert bucketing.constraint_shape(port) == \
            ref_bucketing.constraint_shape(ref)
        assert bucketing.presence(port) == ref_bucketing.presence(ref)
        got = bucketing.pad_to_bucket(port, shape)
        want = ref_bucketing.pad_to_bucket(ref, shape)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert (a is None) == (b is None), f.name
            if a is None:
                continue
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        key = (shape, 32, "torch", bucketing.presence(port),
               bucketing.constraint_shape(port))
        assert bucketing.rung_label(key) == ref_bucketing.rung_label(key)
        if case == "at_bucket":
            again = bucketing.pad_to_bucket(got, bucketing.bucket_shape(got))
            assert again is got

    def test_pad_reads_tensors_on_the_host(self):
        port = make_inputs(100, 5, seed=2, weighted=True)
        fields = {f.name: getattr(port, f.name)
                  for f in dataclasses.fields(port)
                  if getattr(port, f.name) is not None}
        tensors = TB.inputs_from_numpy(fields, "cpu")
        shape = bucketing.bucket_shape(port)
        a = bucketing.pad_to_bucket(port, shape)
        b = bucketing.pad_to_bucket(tensors, shape)
        for name in fields:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))

    def test_crop_outputs_equal_reference(self):
        port = make_inputs(100, 5, seed=4)
        shape = bucketing.bucket_shape(port)
        padded = TB.solve(bucketing.pad_to_bucket(port, shape), backend="numpy")
        got = bucketing.crop_outputs(padded, 100, 5)
        want = ref_bucketing.crop_outputs(padded, 100, 5)
        assert_outputs_equal(got, want)
        assert_outputs_equal(got, direct(port))


class TestPaddingIsInvisible:
    @pytest.mark.parametrize("resources", [3, 4])
    def test_padded_service_solve_equals_unpadded_direct(self, resources):
        """The torch rung pads R = 3 to RESOURCE_FLOOR = 4, and P, T, K
        and L up their ladders. Every output equals the unpadded direct
        solve, weighted and with the optional operands."""
        rng = np.random.default_rng(resources)
        for weighted, constrained in ((False, False), (True, True)):
            port = make_inputs(333, 13, seed=resources,
                               weighted=weighted, constrained=constrained)
            if resources == 4:
                port = dataclasses.replace(port, pod_requests=np.concatenate(
                    [port.pod_requests,
                     rng.integers(0, 3, (333, 1)).astype(np.float32)], 1,
                ), group_allocatable=np.concatenate(
                    [port.group_allocatable,
                     np.full((13, 1), 4.0, np.float32)], 1,
                ))
            shape = bucketing.bucket_shape(port)
            assert shape[2] == 4 and shape[0] == 384 and shape[1] == 16
            svc = new_service()
            try:
                out = svc.solve(port, backend="torch")
            finally:
                svc.close()
            assert out.assigned.shape == (333,)
            assert out.assigned_count.shape == (13,)
            assert_outputs_equal(out, direct(port))
            assert_outputs_equal(out, binpack_numpy(port))


class TestEquality:
    @pytest.mark.parametrize("weighted", [False, True])
    @pytest.mark.parametrize("constrained", [False, True])
    def test_service_matches_direct_and_reference_service(
        self, service, weighted, constrained
    ):
        ref_svc = ref_solver.SolverService(
            registry=RefRegistry(), shard_threshold=0
        )
        try:
            for pods, types in ((17, 3), (256, 8), (300, 12)):
                ref = ref_make_inputs(pods, types, seed=pods,
                                      weighted=weighted,
                                      constrained=constrained)
                port = to_port(ref)
                got = service.solve(port, backend="torch")
                assert_outputs_equal(got, direct(port), "direct ")
                assert_outputs_equal(
                    got, ref_svc.solve(ref, backend="xla"), "ref xla ")
                assert_outputs_equal(
                    service.solve(port, backend="numpy"),
                    ref_svc.solve(ref, backend="numpy"), "ref numpy ")
        finally:
            ref_svc.close()

    def test_constraint_plane_and_priority_through_the_service(self, service):
        rng = np.random.default_rng(12)
        ref = ref_make_inputs(240, 19, seed=12, weighted=True)
        ref = dataclasses.replace(ref, **constraint_fields(
            rng, 240, 19,
            ("pod_claim", "group_reservation", "pod_pack_class",
             "pod_spread_slot", "group_domain", "spread_cap"),
        ), pod_priority=rng.integers(0, 3, 240).astype(np.int32),
            group_tier=rng.integers(0, 2, 19).astype(np.int32))
        port = to_port(ref)
        got = service.solve(port, backend="torch")
        assert_outputs_equal(got, RB.binpack(ref, buckets=32))
        assert_outputs_equal(service.solve(port, backend="numpy"), got)

    def test_numpy_backend_touches_no_device(self, service):
        inputs = make_inputs(40, 4, seed=7)
        assert_outputs_equal(
            service.solve(inputs, backend="numpy"), binpack_numpy(inputs)
        )
        assert service.stats.dispatches == 0
        assert service.stats.upload_bytes == 0

    def test_auto_on_the_cpu_is_the_numpy_rung(self, service):
        inputs = make_inputs(40, 4, seed=8)
        out = service.solve(inputs)
        assert isinstance(out.assigned, np.ndarray)
        assert service.stats.dispatches == 0
        assert_outputs_equal(out, direct(inputs))

    def test_unknown_and_cuda_backends_refused_on_the_cpu(self, service):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            service.solve(make_inputs(10, 2), backend="cuda")
        with pytest.raises(ValueError, match="unknown solver backend"):
            service.solve(make_inputs(10, 2), backend="xla")


class TestCoalescing:
    def test_concurrent_requests_coalesce_and_equal_direct(self, service):
        """8 concurrent same-bucket requests ride at most 2 dispatches,
        and every result equals its direct solve; a later stream of
        jittered sizes inside one bucket misses no key."""
        inputs = [make_inputs(100 + i, 5, seed=i) for i in range(8)]
        service.solve(make_inputs(90, 5, seed=99), backend="torch")
        results = [None] * 8
        barrier = threading.Barrier(8)

        def submit(i):
            barrier.wait(5.0)
            results[i] = service.solve(inputs[i], backend="torch")

        before = service.stats.dispatches
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
            assert not t.is_alive()
        assert service.stats.dispatches - before <= 2
        assert service.stats.last_coalesce_factor >= 4
        for i in range(8):
            assert_outputs_equal(results[i], direct(inputs[i]))
        misses = service.stats.compile_cache_misses
        for pods in (70, 110, 200, 255, 130, 64, 256):
            out = service.solve(make_inputs(pods, 5, seed=pods),
                                backend="torch")
            assert out.assigned.shape == (pods,)
        assert service.stats.compile_cache_misses == misses
        assert service.stats.compile_cache_hits > 0

    def test_distinct_buckets_solve_independently(self, service):
        small, large = make_inputs(50, 4, seed=1), make_inputs(300, 4, seed=2)
        results = {}
        barrier = threading.Barrier(2)

        def submit(name, inputs):
            barrier.wait(5.0)
            results[name] = service.solve(inputs, backend="torch")

        threads = [threading.Thread(target=submit, args=("small", small)),
                   threading.Thread(target=submit, args=("large", large))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert_outputs_equal(results["small"], direct(small))
        assert_outputs_equal(results["large"], direct(large))

    def test_adaptive_idle_queue_skips_the_window(self):
        svc = new_service(window_s=0.5, max_batch=8)
        try:
            inputs = make_inputs(40, 4, seed=1)
            for _ in range(3):
                svc.solve(inputs, backend="torch")
            assert svc.stats.immediate_dispatches >= 3
            assert svc.stats.dispatches == 3
        finally:
            svc.close()


class TestBackpressureAndDeadlines:
    def test_deadline_expiry_raises_when_configured(self):
        release = threading.Event()

        def stuck_device(inputs, buckets=32, backend="auto"):
            release.wait(5.0)
            return binpack_numpy(inputs, buckets=buckets)

        svc = new_service(device_solver=stuck_device, on_timeout="raise",
                          window_s=0.0)
        try:
            with pytest.raises(SolverTimeout):
                svc.solve(make_inputs(20, 3), timeout=0.05)
            assert svc.stats.deadline_expired == 1
            assert svc.stats.fallbacks == 0
        finally:
            release.set()
            svc.close()

    def test_deadline_expiry_falls_back_to_numpy_by_default(self):
        release = threading.Event()

        def stuck_device(inputs, buckets=32, backend="auto"):
            release.wait(5.0)
            return binpack_numpy(inputs, buckets=buckets)

        svc = new_service(device_solver=stuck_device, window_s=0.0)
        try:
            inputs = make_inputs(20, 3)
            out = svc.solve(inputs, timeout=0.05)
            assert_outputs_equal(out, direct(inputs))
            assert svc.stats.deadline_expired == 1
            assert svc.stats.fallbacks == 1
        finally:
            release.set()
            svc.close()

    def test_saturated_queue_degrades_inline(self):
        """max_queue=1: the overflow request is served by numpy inline,
        counted, and equal to the direct solve."""
        release, started = threading.Event(), threading.Event()

        def slow_device(inputs, buckets=32, backend="auto"):
            started.set()
            release.wait(5.0)
            return binpack_numpy(inputs, buckets=buckets)

        svc = new_service(device_solver=slow_device, max_queue=1,
                          window_s=0.0)
        try:
            blocked = svc.submit(make_inputs(10, 2, seed=1))
            assert started.wait(2.0)
            svc.submit(make_inputs(10, 2, seed=2))
            with pytest.raises(SolverSaturated):
                svc.submit(make_inputs(10, 2, seed=3))
            inputs = make_inputs(10, 2, seed=4)
            out = svc.solve(inputs)
            assert_outputs_equal(out, direct(inputs))
            assert svc.stats.rejected == 2
            assert svc.stats.fallbacks == 1
            svc.publish_gauges()
            assert svc.registry.gauge("solver", "fallback_total").get(
                "-", "-") == 1.0
            release.set()
            blocked.result(5.0)
        finally:
            release.set()
            svc.close()

    def test_device_failure_falls_back_to_numpy(self):
        def broken(inputs, buckets=32, backend="auto"):
            raise RuntimeError("injected device failure")

        svc = new_service(device_solver=broken, window_s=0.0)
        try:
            inputs = make_inputs(30, 4, seed=3)
            assert_outputs_equal(svc.solve(inputs), direct(inputs))
            assert svc.stats.fallbacks == 1
            assert svc.stats.device_failures == 1
        finally:
            svc.close()


class TestHealthFSM:
    def test_trips_short_circuits_probes_and_recovers(self):
        clock = FakeClock()
        svc = new_service(
            backend="torch", clock=clock, health_failure_threshold=2,
            health_probe_interval_s=30.0,
        )
        inputs = make_inputs(40, 4, seed=5)
        want = direct(inputs)
        try:
            with faults.injected_faults(seed=3) as reg:
                reg.plan("solver.dispatch", mode="error")
                for _ in range(2):
                    assert_outputs_equal(svc.solve(inputs), want)
                assert svc.backend_health() == "degraded"
                assert svc.stats.fsm_trips == 1
                assert svc.registry.gauge(
                    "resilience", "solver_backend_state").get("-", "-") == 1.0
                attempts = reg.attempts["solver.dispatch"]
                # degraded: served wholesale from numpy, no device attempt
                for _ in range(3):
                    assert_outputs_equal(svc.solve(inputs), want)
                assert reg.attempts["solver.dispatch"] == attempts
                assert svc.stats.fsm_short_circuits == 3
                # the probe window opens on the injected clock; the fault
                # still holds, so the probe fails and the FSM stays down
                clock.advance(31.0)
                assert_outputs_equal(svc.solve(inputs), want)
                assert reg.attempts["solver.dispatch"] == attempts + 1
                assert svc.backend_health() == "degraded"
            # faults cleared: the next probe rides the device and heals
            clock.advance(31.0)
            assert_outputs_equal(svc.solve(inputs), want)
            assert svc.backend_health() == "healthy"
            assert svc.stats.fsm_probes == 2
            assert svc.stats.fsm_recoveries == 1
            assert svc.registry.gauge(
                "resilience", "solver_backend_state").get("-", "-") == 0.0
            dispatches = svc.stats.dispatches
            assert_outputs_equal(svc.solve(inputs), want)
            assert svc.stats.dispatches == dispatches + 1
        finally:
            svc.close()


    def test_health_is_current_when_the_answer_returns(self):
        """The FSM records a device success before the caller is woken:
        right after a probe's answer the service already reads healthy
        (checked over repeated trip -> probe cycles)."""
        clock = FakeClock()
        svc = new_service(backend="torch", clock=clock,
                          health_failure_threshold=1,
                          health_probe_interval_s=10.0)
        inputs = make_inputs(20, 3, seed=9)
        try:
            for _ in range(10):
                with faults.injected_faults(seed=1) as reg:
                    reg.plan("solver.dispatch", mode="error", times=1)
                    svc.solve(inputs)
                    assert svc.backend_health() == "degraded"
                clock.advance(11.0)
                svc.solve(inputs)
                assert svc.backend_health() == "healthy"
            assert svc.stats.fsm_recoveries == 10
        finally:
            svc.close()


class TestWatchdog:
    def test_hang_restarts_worker_drains_to_numpy_and_discards_late(self):
        svc = new_service(backend="torch", watchdog_timeout_s=0.2,
                          health_failure_threshold=10)
        inputs = make_inputs(40, 4, seed=6)
        want = direct(inputs)
        try:
            assert_outputs_equal(svc.solve(inputs), want)  # worker up
            stale = svc._worker
            with faults.injected_faults(seed=4) as reg:
                reg.plan("solver.dispatch", mode="hang", times=1)
                out = svc.solve(inputs, timeout=10.0)
                assert_outputs_equal(out, want)
                assert svc.stats.watchdog_restarts == 1
                assert svc.stats.fallbacks == 1
                assert svc._worker is not stale
            # leaving the scope released the hang: the stale worker
            # unwinds, its late error is discarded (no second failure)
            stale.join(5.0)
            assert not stale.is_alive()
            assert svc.stats.device_failures == 1
            assert svc.backend_health() == "healthy"
            assert_outputs_equal(svc.solve(inputs, timeout=10.0), want)
            assert svc.stats.watchdog_restarts == 1
        finally:
            svc.close()

    def test_new_worker_serves_while_the_hang_holds(self):
        """A hang the watchdog gave up on is never released while the
        next request arrives: the replacement worker answers it from the
        device path (no numpy fallback, no timeout)."""
        svc = new_service(backend="torch", watchdog_timeout_s=0.2,
                          health_failure_threshold=10)
        inputs = make_inputs(40, 4, seed=8)
        want = direct(inputs)
        try:
            assert_outputs_equal(svc.solve(inputs), want)  # worker up
            stale = svc._worker
            with faults.injected_faults(seed=5) as reg:
                reg.plan("solver.dispatch", mode="hang", times=1)
                assert_outputs_equal(svc.solve(inputs, timeout=10.0), want)
                assert svc.stats.watchdog_restarts == 1
                assert svc.stats.fallbacks == 1
                assert stale.is_alive()  # still hung
                dispatches = svc.stats.dispatches
                assert_outputs_equal(svc.solve(inputs, timeout=5.0), want)
                assert svc._worker is not stale
                assert stale.is_alive()
                assert svc.stats.fallbacks == 1
                assert svc.stats.deadline_expired == 0
                assert svc.stats.dispatches == dispatches + 1
            stale.join(5.0)
            assert not stale.is_alive()
        finally:
            svc.close()

    def test_stale_worker_late_result_is_discarded(self):
        """A device call that wedges and later RETURNS: the watchdog has
        answered from numpy; the stale worker's late answer never
        replaces it."""
        entered, release = threading.Event(), threading.Event()
        bogus = dataclasses.replace(
            binpack_numpy(make_inputs(40, 4, seed=7)),
            nodes_needed=np.full(4, -7, np.int32),
        )

        def wedged(inputs, buckets=32, backend="auto"):
            entered.set()
            release.wait(5.0)
            return bogus

        svc = new_service(device_solver=wedged, watchdog_timeout_s=0.2,
                          health_failure_threshold=10, window_s=0.0)
        inputs = make_inputs(40, 4, seed=7)
        try:
            future = svc.submit(inputs, timeout=10.0)
            assert entered.wait(2.0)
            out = future.result(10.0)
            assert_outputs_equal(out, direct(inputs))
            stale = [t for t in threading.enumerate()
                     if t.name == "solver-service" and t is not svc._worker]
            release.set()
            for t in stale:
                t.join(5.0)
            assert future.result(1.0) is out
            assert svc.stats.watchdog_restarts == 1
        finally:
            release.set()
            svc.close()


class TestPipelinedDispatch:
    def test_sustained_load_overlaps_dispatches(self):
        svc = new_service(window_s=0.02, max_batch=2, pipeline_depth=1)
        try:
            inputs = [make_inputs(30 + i, 3, seed=i) for i in range(6)]
            svc.solve(inputs[0], backend="torch")
            futures = [svc.submit(x, backend="torch") for x in inputs]
            results = [f.result(30.0) for f in futures]
            for x, out in zip(inputs, results):
                assert_outputs_equal(out, direct(x))
            assert svc.stats.pipeline_overlaps >= 1
        finally:
            svc.close()

    def test_closed_loop_batch_splits_and_overlaps(self):
        svc = new_service(window_s=0.1, max_batch=8, adaptive_window=False,
                          pipeline_depth=1)
        try:
            inputs = [make_inputs(30 + i, 3, seed=i) for i in range(8)]
            svc.solve(inputs[0], backend="torch")
            results = [None] * 8
            barrier = threading.Barrier(8)

            def submit(i):
                barrier.wait(5.0)
                results[i] = svc.solve(inputs[i], backend="torch")

            threads = [threading.Thread(target=submit, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30.0)
            for x, out in zip(inputs, results):
                assert_outputs_equal(out, direct(x))
            assert svc.stats.pipeline_splits >= 1
            assert svc.stats.pipeline_overlaps >= 1
        finally:
            svc.close()

    def test_pipeline_depth_zero_is_serial(self):
        svc = new_service(window_s=0.0, pipeline_depth=0)
        try:
            inputs = make_inputs(20, 3, seed=5)
            assert_outputs_equal(svc.solve(inputs, backend="torch"),
                                 direct(inputs))
            assert svc.stats.pipeline_overlaps == 0
        finally:
            svc.close()

    def test_inflight_failure_degrades_to_numpy(self, monkeypatch):
        """A failure that surfaces at drain time (the fetch), not at
        dispatch, still answers every request from numpy."""
        svc = new_service(window_s=0.0)
        explode_in_flight(monkeypatch)
        try:
            inputs = make_inputs(15, 3, seed=9)
            assert_outputs_equal(svc.solve(inputs, backend="torch"),
                                 direct(inputs))
            assert svc.stats.fallbacks == 1
            assert svc.stats.device_failures == 1
        finally:
            svc.close()

    def test_first_seen_keys_are_counted(self, service):
        """Nothing is compiled per key: the compile-cache counters count
        first-seen dispatch keys (a repeat of a shape bucket is a hit),
        and reset_caches forgets them."""
        inputs = make_inputs(30, 3, seed=1)
        service.solve(inputs, backend="torch")
        assert service.stats.compile_cache_misses == 1
        service.solve(make_inputs(40, 3, seed=2), backend="torch")
        assert service.stats.compile_cache_misses == 1
        assert service.stats.compile_cache_hits == 1
        service.reset_caches()
        service.solve(inputs, backend="torch")
        assert service.stats.compile_cache_misses == 2

    def test_batched_program_equals_direct_per_item(self):
        """run_batched over a stacked batch == the plain program on each
        item, element for element."""
        items = [make_inputs(200, 6, seed=s, weighted=True, constrained=True)
                 for s in range(3)]
        shape = bucketing.bucket_shape(items[0])
        padded = [bucketing.pad_to_bucket(x, shape) for x in items]
        stacked = S._stack_inputs(padded)
        fields = {f.name: getattr(stacked, f.name)
                  for f in dataclasses.fields(stacked)
                  if getattr(stacked, f.name) is not None}
        out = S.run_batched(TB.inputs_from_numpy(fields, "cpu"), 32)
        for i, x in enumerate(padded):
            assert_outputs_equal(S._index_outputs(S._fetch_outputs(out), i),
                                 direct(x))


class TestMetricsSurface:
    def test_registered_names_equal_reference(self):
        def surface(registry):
            return {
                (sub, name, vec.kind)
                for sub, vecs in registry._gauges.items()
                for name, vec in vecs.items()
            }

        port_reg, ref_reg = GaugeRegistry(), RefRegistry()
        port = new_service(registry=port_reg, resident=False)
        ref = ref_solver.SolverService(registry=ref_reg)
        try:
            assert surface(port_reg) == surface(ref_reg)
            inputs = make_inputs(20, 3)
            port.solve(inputs, backend="torch")
            port.publish_gauges()
            text = port_reg.expose_text()
            for series in (
                "karpenter_solver_queue_depth",
                "karpenter_solver_coalesce_factor",
                "karpenter_solver_requests_total",
                "karpenter_solver_dispatch_total",
                "karpenter_solver_compile_cache_misses_total",
                "karpenter_solver_stage_p50_ms",
                "karpenter_solver_window_ms",
                "karpenter_solver_pipeline_depth",
                "karpenter_solver_upload_ms",
            ):
                assert series in text, series
            stages = port.stage_percentiles()
            for stage in ("queue_wait", "pad", "upload", "dispatch",
                          "fetch", "scatter"):
                assert stages[stage]["n"] >= 1, stage
            port.note_tick()
            assert port.stats.last_dispatches_per_tick == 1
        finally:
            port.close()
            ref.close()

    def test_decide_equals_direct_decide(self):
        from karpenter_tpu_torch import workloads
        from karpenter_tpu_torch.ops import decision as D

        svc = new_service()
        try:
            fields = workloads.build_decision_inputs(0, 64, 3)
            out = svc.decide(fields)
            want = D.decide(D.DecisionInputs.from_numpy(fields, "cpu"))
            for name, value in want.to_numpy().items():
                np.testing.assert_array_equal(
                    out.to_numpy()[name], value, err_msg=name)
            again = svc.decide(D.DecisionInputs.from_numpy(fields, "cpu"))
            np.testing.assert_array_equal(again.desired.numpy(),
                                          want.desired.numpy())
            assert svc.stats.decide_calls == 2
            assert svc.stage_percentiles()["decide"]["n"] == 2
        finally:
            svc.close()

    def test_prewarm_warms_skips_and_degrades(self):
        registry = GaugeRegistry()
        svc = new_service(registry=registry, backend="torch")
        try:
            report = svc.prewarm()
            assert set(report) == {"solve", "decide"}
            assert report["solve"]["fresh_compiles"] >= 1
            assert "fresh_compiles" not in report["decide"]
            assert svc.prewarm() == {"solve": {"skipped": True},
                                     "decide": {"skipped": True}}
            assert registry.gauge("solver", "prewarm_compiles_total").get(
                "solve", "-") == 1.0
            svc.reset_caches()
            assert svc.prewarm(families=("solve",))["solve"][
                "skipped"] is False
            bad = svc.prewarm(families=("nope",))
            assert bad["nope"] == {"skipped": False, "error": "ValueError"}
        finally:
            svc.close()


class TestDevice:
    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default service runs on it")
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            SolverService(registry=GaugeRegistry())
        S.reset_default_service()
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            S.default_service()

    def test_kernel_build_failure_raises_never_numpy(self, monkeypatch):
        """A service whose rung resolves to cuda builds the kernels when
        it is constructed, on the caller's thread: a build failure
        raises out of the constructor (and out of prewarm and a cuda
        submit) instead of being served by the numpy rung."""
        from karpenter_tpu_torch import kernels

        def broken_build(*args, **kwargs):
            raise RuntimeError("nvcc not found")

        monkeypatch.setattr(kernels, "build", broken_build)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            SolverService(registry=GaugeRegistry())
        svc = SolverService(registry=GaugeRegistry(), device="cuda",
                            backend="torch")
        try:
            with pytest.raises(RuntimeError, match="nvcc not found"):
                svc.submit(make_inputs(10, 2), backend="cuda")
            svc.backend = "cuda"
            with pytest.raises(RuntimeError, match="nvcc not found"):
                svc.prewarm(families=("solve",))
            assert svc.stats.requests == 0 and svc.stats.fallbacks == 0
        finally:
            svc.close()


class TestCardFailurePolicy:
    """On the card a failed, hung, degraded, saturated or expired device
    path reaches the caller as an error: nothing is answered from numpy
    unless backend="numpy" was asked for."""

    def test_the_card_sets_the_policy(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        svc = SolverService(registry=GaugeRegistry(), device="cuda",
                            backend="torch")
        try:
            assert svc._numpy_ladder is False
            assert svc.on_timeout == "raise"
        finally:
            svc.close()
        with pytest.raises(ValueError, match="never does"):
            SolverService(registry=GaugeRegistry(), device="cuda",
                          backend="torch", on_timeout="fallback")
        cpu = new_service()
        try:
            assert cpu._numpy_ladder is True
            assert cpu.on_timeout == "fallback"
        finally:
            cpu.close()

    def test_device_failure_raises(self):
        def broken(inputs, buckets=32, backend="auto"):
            raise RuntimeError("injected device failure")

        svc = card_policy(new_service(device_solver=broken, window_s=0.0))
        try:
            with pytest.raises(RuntimeError, match="injected device failure"):
                svc.solve(make_inputs(30, 4, seed=3))
            assert svc.stats.device_failures == 1
            assert svc.stats.fallbacks == 0
        finally:
            svc.close()

    def test_inflight_failure_raises(self, monkeypatch):
        svc = card_policy(new_service(window_s=0.0))
        explode_in_flight(monkeypatch)
        try:
            with pytest.raises(RuntimeError, match="in-flight failure"):
                svc.solve(make_inputs(15, 3, seed=9), backend="torch")
            assert svc.stats.device_failures == 1
            assert svc.stats.fallbacks == 0
        finally:
            svc.close()

    def test_fsm_trips_raises_and_recovers(self):
        clock = FakeClock()
        svc = card_policy(new_service(
            backend="torch", clock=clock, health_failure_threshold=2,
            health_probe_interval_s=30.0,
        ))
        inputs = make_inputs(40, 4, seed=5)
        try:
            with faults.injected_faults(seed=3) as reg:
                reg.plan("solver.dispatch", mode="error")
                for _ in range(2):
                    with pytest.raises(faults.FaultInjected):
                        svc.solve(inputs)
                assert svc.backend_health() == "degraded"
                attempts = reg.attempts["solver.dispatch"]
                # degraded: no device attempt, and no numpy answer
                with pytest.raises(SolverDeviceError, match="degraded"):
                    svc.solve(inputs)
                assert reg.attempts["solver.dispatch"] == attempts
                assert svc.stats.fsm_short_circuits == 1
            clock.advance(31.0)
            assert_outputs_equal(svc.solve(inputs), direct(inputs))
            assert svc.backend_health() == "healthy"
            assert svc.stats.fsm_recoveries == 1
            assert svc.stats.fallbacks == 0
        finally:
            svc.close()

    def test_hang_raises_after_the_watchdog_restart(self):
        svc = card_policy(new_service(backend="torch",
                                      watchdog_timeout_s=0.2,
                                      health_failure_threshold=10))
        inputs = make_inputs(40, 4, seed=6)
        try:
            svc.solve(inputs)  # worker up
            stale = svc._worker
            with faults.injected_faults(seed=4) as reg:
                reg.plan("solver.dispatch", mode="hang", times=1)
                with pytest.raises(SolverDeviceError, match="hung"):
                    svc.solve(inputs, timeout=10.0)
                assert svc.stats.watchdog_restarts == 1
            stale.join(5.0)
            assert not stale.is_alive()
            assert_outputs_equal(svc.solve(inputs, timeout=10.0),
                                 direct(inputs))
            assert svc.stats.fallbacks == 0
        finally:
            svc.close()

    def test_saturation_and_deadline_raise(self):
        # one permit lets one device call finish; `calls` counts entries
        release, calls = threading.Semaphore(0), []

        def slow_device(inputs, buckets=32, backend="auto"):
            calls.append(inputs)
            release.acquire(timeout=5.0)
            return binpack_numpy(inputs, buckets=buckets)

        def wait_for_calls(n):
            deadline = time.monotonic() + 2.0
            while len(calls) < n:
                assert time.monotonic() < deadline
                time.sleep(0.001)

        svc = card_policy(new_service(device_solver=slow_device, max_queue=1,
                                      window_s=0.0))
        try:
            blocked = svc.submit(make_inputs(10, 2, seed=1))
            wait_for_calls(1)
            svc.submit(make_inputs(10, 2, seed=2))
            with pytest.raises(SolverSaturated):
                svc.solve(make_inputs(10, 2, seed=4))
            release.release()
            blocked.result(5.0)
            wait_for_calls(2)  # the second request holds the device
            with pytest.raises(SolverTimeout):
                svc.solve(make_inputs(20, 3), timeout=0.05)
            assert svc.stats.deadline_expired == 1
            assert svc.stats.fallbacks == 0
        finally:
            release.release(8)
            svc.close()


class TestReconcileThroughTheService:
    def test_solve_pending_through_service_equals_direct(self):
        """Production's wiring: solve_pending(..., solver=service.solve).
        Over a first tick and churned ticks the statuses and gauges equal
        the direct-solve path's on the same draw."""
        from karpenter_tpu_torch import workloads as W
        from tests.test_torch_encoder import reset_state

        def run(solver_of):
            reset_state()
            cluster = W.build_reconcile_cluster(1500, 24, 0)
            svc, solver = solver_of()
            seen = []
            try:
                for k in range(4):
                    if k:
                        W.churn_reconcile(cluster, 40)()
                    errors = cluster.tick(solver)
                    assert all(e is None for e in errors.values())
                    seen.append((
                        [dataclasses.astuple(mp.status.pending_capacity)
                         for mp in cluster.producers],
                        cluster.registry.expose_text(),
                    ))
            finally:
                if svc is not None:
                    svc.close()
            return seen, svc

        def through_service():
            svc = new_service(backend="torch")
            return svc, svc.solve

        def direct_solver():
            return None, functools.partial(TB.solve, device="cpu")

        got, svc = run(through_service)
        want, _ = run(direct_solver)
        assert got == want
        assert svc.stats.requests == 4 and svc.stats.fallbacks == 0
        assert svc.stats.resident_rebuilds >= 1
