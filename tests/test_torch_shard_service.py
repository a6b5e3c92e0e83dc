"""The solve service's shard route (karpenter_tpu_torch/solver/service.py,
"Sharded dispatch") against the reference's, on the CPU: the
counterparts of tests/test_solver_service.py::TestShardedDispatch and of
tests/test_resident.py::TestShardThresholdCrossing.

The port's services run with device="cpu" on the torch rung (the
reference's xla) over eight virtual copies of the CPU
(utils/device.force_virtual_devices, set by a fixture and undone after
each test); the reference's over the eight virtual CPU devices
tests/conftest.py gives JAX. Inputs are tests/test_solver_service.py's
seeded draws, handed to both packages as the same numpy arrays.

Tolerance: all five outputs exact (bitwise), against the port's direct
plain solve, its numpy mirror and the reference service's shard route.
Every service is closed in `finally`.
"""

from __future__ import annotations

import numpy as np
import pytest

import karpenter_tpu.solver as ref_solver
from karpenter_tpu.metrics.registry import GaugeRegistry as RefRegistry
from karpenter_tpu_torch.ops.numpy_binpack import binpack_numpy
from karpenter_tpu_torch.utils import device as UD
from test_torch_resident import TwinWorld
from test_torch_solver_service import (
    assert_outputs_equal,
    card_policy,
    direct,
    make_inputs,
    new_service,
)
from tests.test_torch_encoder import _fresh_state  # noqa: F401 — autouse reset
from test_solver_service import make_inputs as ref_make_inputs


@pytest.fixture(autouse=True)
def eight_devices():
    UD.force_virtual_devices(8, "cpu")
    yield
    UD.reset_virtual_devices()


def shard_service(**kwargs):
    kwargs.setdefault("shard_threshold", 1)
    kwargs.setdefault("backend", "torch")
    return new_service(**kwargs)


class TestShardedDispatch:
    def test_above_threshold_routes_through_mesh_with_parity(self):
        svc = shard_service()
        ref = ref_solver.SolverService(registry=RefRegistry(),
                                       shard_threshold=1)
        try:
            inputs = make_inputs(333, 13, seed=3, weighted=True,
                                 constrained=True)
            out = svc.solve(inputs)
            assert svc.stats.shard_requests == 1
            assert svc.stats.shard_dispatches == 1
            assert svc.stats.fallbacks == svc.stats.shard_fallbacks == 0
            assert_outputs_equal(out, direct(inputs))
            assert_outputs_equal(out, binpack_numpy(inputs, buckets=32))
            ref_out = ref.solve(
                ref_make_inputs(333, 13, 3, True, True), backend="xla"
            )
            assert ref.stats.shard_dispatches == 1
            assert_outputs_equal(out, ref_out, "reference ")
            # the sharded route is visible on the latency surface too
            assert "upload" in svc.stage_percentiles()
            svc.publish_gauges()
            assert "karpenter_solver_shard_devices" in (
                svc.registry.expose_text())
            assert svc._g_shard.get("-", "-") == 8.0
        finally:
            svc.close()
            ref.close()

    def test_below_threshold_stays_single_device(self):
        svc = shard_service(shard_threshold=10**9)
        try:
            inputs = make_inputs(64, 4, seed=1)
            out = svc.solve(inputs)
            assert svc.stats.shard_requests == 0
            assert svc.stats.shard_dispatches == 0
            assert_outputs_equal(out, direct(inputs))
        finally:
            svc.close()

    def test_threshold_zero_disables_sharding(self):
        svc = shard_service(shard_threshold=0)
        try:
            svc.solve(make_inputs(300, 12, seed=2))
            assert svc.stats.shard_dispatches == 0
            assert svc._shard_mesh() is None
        finally:
            svc.close()

    def test_single_device_mesh_shapes_stay_unsharded(self):
        """An explicit 1x1 --shard-mesh (or a 1-device cap) builds no
        mesh: a one-device mesh would report sharding with no gain."""
        for kwargs in ({"shard_mesh_shape": (1, 1)}, {"shard_devices": 1}):
            svc = shard_service(**kwargs)
            try:
                inputs = make_inputs(128, 6, seed=6)
                out = svc.solve(inputs)
                assert svc._shard_mesh() is None, kwargs
                assert svc.stats.shard_dispatches == 0, kwargs
                assert_outputs_equal(out, direct(inputs))
            finally:
                svc.close()

    def test_shard_failure_degrades_to_single_device_then_sticks(self):
        """The ladder: a shard-route failure re-runs the SAME batch on the
        single-device program (answered on device, NOT from numpy) and
        stops routing new traffic to the mesh; reset_caches re-arms it."""
        svc = shard_service()

        def explode(*_a, **_k):
            raise RuntimeError("injected shard failure")

        svc._sharded_dispatch = explode
        try:
            inputs = make_inputs(200, 9, seed=4)
            out = svc.solve(inputs)
            assert_outputs_equal(out, direct(inputs))
            assert svc.stats.shard_fallbacks == 1
            assert svc.stats.fallbacks == 0  # device answered, not numpy
            assert svc._shard_broken
            out2 = svc.solve(inputs)
            assert_outputs_equal(out2, direct(inputs))
            assert svc.stats.shard_fallbacks == 1
            svc.reset_caches()
            assert not svc._shard_broken
        finally:
            svc.close()

    def test_shard_and_single_device_compile_families_never_alias(self):
        """The shard marker is part of the dispatch key: the same bucket
        shape sharded and unsharded are two keys."""
        svc = shard_service()
        try:
            inputs = make_inputs(128, 6, seed=8)
            svc.solve(inputs)
            misses_sharded = svc.stats.compile_cache_misses
            assert misses_sharded >= 1
            svc.shard_threshold = 10**12  # same shapes, unsharded now
            svc.solve(inputs)
            assert svc.stats.compile_cache_misses == misses_sharded + 1
            hits = svc.stats.compile_cache_hits
            svc.solve(inputs)
            svc.shard_threshold = 1
            svc.solve(inputs)
            assert svc.stats.compile_cache_hits == hits + 2
            assert svc.stats.compile_cache_misses == misses_sharded + 1
        finally:
            svc.close()

    def test_consolidate_routes_through_mesh_with_parity(self):
        svc = shard_service()
        try:
            inputs_list = [make_inputs(96, 8, seed=10 + i) for i in range(4)]
            results = svc.consolidate(inputs_list)
            assert svc.stats.shard_dispatches == 1  # one "vmap_shard" batch
            assert svc.stats.shard_requests == 4
            assert svc.stats.fallbacks == 0
            for inputs, out in zip(inputs_list, results):
                assert_outputs_equal(out, direct(inputs))
        finally:
            svc.close()

    def test_forecast_and_preempt_never_shard(self):
        """On the CPU's default rung (numpy) nothing shards, whatever the
        threshold: the reference's pin of its default service."""
        from karpenter_tpu_torch.forecast.models import ForecastInputs

        svc = new_service(shard_threshold=1)
        try:
            rng = np.random.default_rng(0)
            S, T = 6, 16
            svc.forecast(ForecastInputs(
                values=rng.uniform(0, 10, (S, T)).astype(np.float32),
                valid=np.ones((S, T), bool),
                times=np.tile(
                    (np.arange(T, dtype=np.float32) - (T - 1)) * 10, (S, 1)
                ),
                weights=np.ones((S, T), np.float32),
                horizon=np.full(S, 30.0, np.float32),
                step_s=np.full(S, 10.0, np.float32),
                model=np.zeros(S, np.int32),
                season=np.zeros(S, np.int32),
                alpha=np.full(S, 0.5, np.float32),
                beta=np.full(S, 0.2, np.float32),
                gamma=np.full(S, 0.2, np.float32),
            ))
            svc.solve(make_inputs(64, 4, seed=1))
            assert svc.stats.shard_dispatches == 0
            assert svc.stats.shard_requests == 0
        finally:
            svc.close()


class TestCardPolicy:
    def test_shard_failure_retries_single_device_never_numpy(self):
        """Under the card's failure rule a shard failure is retried on the
        single-device path of the same rung (counted), nothing answers
        from numpy, and a single-device failure then raises."""
        svc = card_policy(shard_service())
        calls = []

        def explode(*_a, **_k):
            calls.append(1)
            raise RuntimeError("injected shard failure")

        svc._sharded_dispatch = explode
        try:
            inputs = make_inputs(150, 7, seed=12)
            assert_outputs_equal(svc.solve(inputs), direct(inputs))
            assert calls == [1]
            assert svc.stats.shard_fallbacks == 1
            assert svc.stats.fallbacks == 0
            svc.reset_caches()
            svc._begin_pipelined_torch = explode
            with pytest.raises(RuntimeError, match="injected shard failure"):
                svc.solve(inputs)
            assert svc.stats.shard_fallbacks == 2
            assert svc.stats.fallbacks == 0
        finally:
            svc.close()

    def test_sharded_decide_failure_retries_single_device(self, monkeypatch):
        from karpenter_tpu_torch import workloads
        from karpenter_tpu_torch.ops import decision as D
        from karpenter_tpu_torch.parallel import mesh as PM

        svc = card_policy(shard_service())

        def explode(*_a, **_k):
            raise RuntimeError("injected shard failure")

        try:
            fleet = workloads.build_decision_inputs(2, 96, 3)
            want = D.decide_numpy(D.DecisionInputs.from_arrays(fleet))
            got = svc.decide(fleet)
            assert svc.stats.shard_dispatches == 1
            monkeypatch.setattr(PM, "sharded_decide", explode)
            svc.reset_caches()
            again = svc.decide(fleet)
            assert svc.stats.shard_fallbacks == 1 and svc._shard_broken
            for name in ("desired", "able_to_scale", "able_at"):
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(want, name))
                np.testing.assert_array_equal(getattr(again, name),
                                              getattr(want, name))
        finally:
            svc.close()


class TestShardThresholdCrossing:
    def test_crossing_rebuilds_then_scatters_both_modes(self):
        """Residency is keyed by mode: crossing the threshold either way
        rebuilds, and a sharded-mode scatter equals a cold upload and the
        reference's sharded resident buffers byte for byte."""
        w = TwinWorld()
        svcs = [side.svc for side in w.sides.values()]
        try:
            for svc in svcs:
                svc.shard_threshold = 1 << 60
            for i in range(16):
                w.upsert(f"p{i}", cpu=f"{100 + i}m")
            w.tick(expect="rebuild")  # single-device mode
            w.tick(expect="hit")
            for svc in svcs:
                svc.shard_threshold = 1
            w.upsert("up-a", cpu="700m")
            w.tick(expect="rebuild")
            assert all(svc.stats.shard_dispatches >= 1 for svc in svcs)
            w.upsert("up-b", cpu="701m")
            w.tick(expect="scatter")  # sharded-mode scatter
            w.tick(expect="hit")
            for svc in svcs:
                svc.shard_threshold = 1 << 60
            w.upsert("down-a", cpu="702m")
            w.tick(expect="rebuild")
            w.tick(expect="hit")
        finally:
            w.close()

