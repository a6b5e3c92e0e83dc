"""The port's fleet-tick families of the solve service (forecast, cost,
poolgroup, fused_tick; karpenter_tpu_torch/solver/service.py) against the
reference service's (karpenter_tpu/solver), on the CPU.

The reference service runs with backend="numpy" (its mirrors); the
port's on its default CPU rung (numpy, the same mirrors copied) and on
its `torch` rung (the tensor programs on the CPU, bitwise equal to the
mirrors). Inputs are seeded numpy draws at small sizes (N <= 64,
M <= 3, S <= 32, T <= 32) handed to both packages. Every answer is host
numpy, fetched in one copy per family call.

On the CPU the port keeps the reference's ladder (fused -> chained ->
numpy; joint -> independent ladders); on the card every failure raises.
TestCardFailurePolicy holds the card's policy on a CPU service given it
(`card_policy`), as tests/test_torch_solver_service.py does.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

import karpenter_tpu.solver as ref_solver
from karpenter_tpu.forecast import models as RM
from karpenter_tpu.metrics.registry import GaugeRegistry as RefRegistry
from karpenter_tpu_torch import faults, workloads
from karpenter_tpu_torch.forecast import models as M
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.ops import decision as D
from karpenter_tpu_torch.ops import fusedtick as FT
from karpenter_tpu_torch.ops import poolgroup as PG
from karpenter_tpu_torch.solver import (
    CostUnavailable,
    SolverDeviceError,
    SolverService,
)
from karpenter_tpu_torch.utils import operands

from test_cost import random_inputs as random_cost_inputs
from test_forecast import random_forecast_inputs
from test_poolgroup import random_group_inputs
from test_torch_fusedtick import ref_inputs as ref_tick_inputs
from test_torch_fusedtick import with_stages
from test_torch_mirrors import assert_same_bytes
from test_torch_solver_service import FakeClock, card_policy

N, M_COLS, S, T = 64, 3, 20, 24


def new_service(**kwargs):
    kwargs.setdefault("registry", GaugeRegistry())
    return SolverService(device="cpu", **kwargs)


@pytest.fixture
def services():
    """(port numpy rung, port torch rung, reference numpy rung)."""
    made = [
        new_service(),
        new_service(backend="torch"),
        ref_solver.SolverService(registry=RefRegistry(), backend="numpy"),
    ]
    try:
        yield made
    finally:
        for svc in made:
            svc.close()


def forecast_draw(seed, s=S, t=T):
    return random_forecast_inputs(np.random.RandomState(seed), s, t)


def padded_mirror(draw, t_bucket):
    """The reference mirror on the draw padded to the service's history
    bucket (the Holt-Winters season is clamped to the padded T, so the
    service's answer is the padded draw's)."""
    return RM.forecast_numpy(RM.pad_forecast_inputs(draw, t_bucket))


def tick_draw(seed, groups=6, pools=4, s=S, t=T):
    return workloads.build_fused_tick_inputs(
        seed, N, M_COLS, s, t, groups=groups, pools=pools
    )


class TestFamiliesEqualTheReference:
    @pytest.mark.parametrize("seed", range(3))
    def test_forecast(self, services, seed):
        port_np, port_torch, ref = services
        draw = forecast_draw(seed)
        want = ref.forecast(draw)
        for svc in (port_np, port_torch):
            before = operands.FETCHES["count"]
            got = svc.forecast(draw)
            assert_same_bytes(got, want, svc.backend)
            assert isinstance(got.point, np.ndarray)
            assert got.point.shape == (S,)
            assert operands.FETCHES["count"] - before == (
                1 if svc is port_torch else 0
            )
        assert port_torch.stats.forecast_dispatches == 1
        assert port_np.stats.forecast_dispatches == 0
        assert port_torch.stats.forecast_series == S

    def test_forecast_of_no_series(self, services):
        port_np, _, ref = services
        draw = forecast_draw(1, s=1)
        empty = M.ForecastInputs(**{
            k: np.asarray(v)[:0] for k, v in vars(draw).items()
        })
        assert_same_bytes(port_np.forecast(empty), ref.forecast(draw.__class__(
            **{k: np.asarray(v)[:0] for k, v in vars(draw).items()}
        )))
        assert port_np.stats.forecast_calls == 1

    @pytest.mark.parametrize("seed", range(3))
    def test_cost(self, services, seed):
        port_np, port_torch, ref = services
        draw = random_cost_inputs(seed, n=N, m=M_COLS)
        want = ref.cost(draw)
        for svc in (port_np, port_torch):
            assert_same_bytes(svc.cost(draw), want, svc.backend)
        assert port_torch.stats.cost_dispatches == 1
        assert port_np.stats.cost_dispatches == 0
        assert port_torch.stage_percentiles()["cost"]["n"] == 1

    @pytest.mark.parametrize("g, p, m", [(8, 4, 2), (6, 2, 3)])
    def test_poolgroup(self, services, g, p, m):
        port_np, port_torch, ref = services
        draw = random_group_inputs(3, g, p, m)
        want = ref.poolgroup(draw)
        for svc in (port_np, port_torch):
            assert_same_bytes(svc.poolgroup(draw), want, svc.backend)
        assert port_torch.stats.poolgroup_dispatches == 1
        assert port_torch.stats.poolgroup_independent_serves == 0

    @pytest.mark.parametrize("forecast", [True, False], ids=["fc", "no-fc"])
    @pytest.mark.parametrize("pools", [2, 4])
    def test_fused_tick(self, services, pools, forecast):
        port_np, port_torch, ref = services
        fields = with_stages(tick_draw(7, pools=pools), forecast, True, True)
        want = ref.fused_tick(ref_tick_inputs(fields))
        for svc in (port_np, port_torch):
            got = svc.fused_tick(FT.FusedTickInputs.from_arrays(fields))
            assert_same_bytes(got, want, svc.backend)
        # the service padded the forecast group to 24 -> 32 series and
        # 24 -> 32 samples, and sliced the answer back to the caller's S
        if forecast:
            assert got.forecast.point.shape == (S,)
        assert port_torch.stats.fused_dispatches == 1
        assert port_np.stats.fused_dispatches == 0
        assert port_np.stats.fused_mirror_serves == 0
        assert port_torch.stats.fused_chained_serves == 0

    def test_fused_tick_takes_tensor_operands(self, services):
        _, port_torch, ref = services
        fields = tick_draw(8)
        want = ref.fused_tick(ref_tick_inputs(fields))
        got = port_torch.fused_tick(FT.FusedTickInputs.from_numpy(fields, "cpu"))
        assert_same_bytes(got, want, "tensor operands")

    def test_decide_answers_numpy_for_host_operands(self, services):
        _, port_torch, _ = services
        fields = workloads.build_decision_inputs(2, N, M_COLS, forecast=True)
        before = operands.FETCHES["count"]
        host = port_torch.decide(D.DecisionInputs.from_arrays(fields))
        assert operands.FETCHES["count"] == before + 1
        assert isinstance(host.desired, np.ndarray)
        assert_same_bytes(host, D.decide_numpy(D.DecisionInputs.from_arrays(fields)))
        tensors = port_torch.decide(D.DecisionInputs.from_numpy(fields, "cpu"))
        assert not isinstance(tensors.desired, np.ndarray)
        assert operands.FETCHES["count"] == before + 1


class TestForecastCoalescing:
    def test_concurrent_requests_share_one_dispatch(self):
        svc = new_service(backend="torch", window_s=0.5, adaptive_window=False)
        draws = [forecast_draw(10 + i, s=3 + i, t=T) for i in range(4)]
        results = [None] * len(draws)
        barrier = threading.Barrier(len(draws))

        def call(i):
            barrier.wait(5.0)
            results[i] = svc.forecast(draws[i], timeout=20.0)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(30.0)
            for draw, got in zip(draws, results):
                assert_same_bytes(got, padded_mirror(draw, 32), "coalesced")
            assert svc.stats.forecast_calls == 4
            # all four arrive inside one 0.5 s window behind a barrier
            assert svc.stats.forecast_dispatches <= 2
            assert svc.stats.coalesced_batches >= 1
        finally:
            svc.close()

    def test_history_buckets_split_dispatches(self):
        svc = new_service(backend="torch")
        try:
            a = svc.forecast(forecast_draw(1, t=12))
            b = svc.forecast(forecast_draw(1, t=30))
            assert_same_bytes(a, padded_mirror(forecast_draw(1, t=12), 16))
            assert_same_bytes(b, padded_mirror(forecast_draw(1, t=30), 32))
            assert svc.stats.forecast_dispatches == 2
            assert svc.stats.compile_cache_misses == 2
            svc.forecast(forecast_draw(2, t=11))  # same 16 x 24 -> 32 keys
            assert svc.stats.compile_cache_hits >= 1
        finally:
            svc.close()


class TestCPULadder:
    """The reference's never-block ladder on the CPU."""

    def test_fused_failure_serves_chained_then_numpy(self):
        svc = new_service(backend="torch", health_failure_threshold=10)
        fields = tick_draw(4)
        want = FT.fused_tick_numpy(FT.FusedTickInputs.from_arrays(fields))
        try:
            with faults.injected_faults(seed=1) as reg:
                reg.plan("fused.tick", mode="error")
                got = svc.fused_tick(FT.FusedTickInputs.from_arrays(fields))
            assert_same_bytes(got, want, "chained")
            assert svc.stats.fused_chained_serves == 1
            assert svc.stats.device_failures == 1
            svc.note_tick()
            assert svc.stats.last_dispatches_per_tick == FT.programs(
                FT.FusedTickInputs.from_arrays(fields)
            )
        finally:
            svc.close()

    def test_degraded_fsm_serves_the_floors(self):
        clock = FakeClock()
        svc = new_service(backend="torch", clock=clock,
                          health_failure_threshold=1,
                          health_probe_interval_s=30.0)
        fields = tick_draw(5)
        pg = random_group_inputs(2, 4, 2, 2)
        try:
            with faults.injected_faults(seed=2) as reg:
                reg.plan("poolgroup.solve", mode="error")
                got = svc.poolgroup(pg)
            assert_same_bytes(got, PG.poolgroup_numpy(
                PG.PoolGroupInputs.from_arrays(pg), enforce=False))
            assert svc.stats.poolgroup_independent_serves == 1
            assert svc.backend_health() == "degraded"
            tick = svc.fused_tick(FT.FusedTickInputs.from_arrays(fields))
            assert_same_bytes(tick, FT.fused_tick_numpy(
                FT.FusedTickInputs.from_arrays(fields)))
            assert svc.stats.fused_mirror_serves == 1
            with pytest.raises(CostUnavailable):
                svc.cost(random_cost_inputs(1, n=N, m=M_COLS))
            assert svc.stats.cost_errors == 1
            fc = svc.forecast(forecast_draw(3))
            assert_same_bytes(fc, padded_mirror(forecast_draw(3), 32))
            assert svc.stats.fallbacks == 1
            clock.advance(31.0)
            svc.fused_tick(FT.FusedTickInputs.from_arrays(fields))
            assert svc.backend_health() == "healthy"
            assert svc.stats.fused_dispatches == 1
        finally:
            svc.close()


class TestCardFailurePolicy:
    """Under the card's policy no family answers from numpy: every
    failure, and a degraded FSM, reaches the caller."""

    def test_each_family_raises_a_device_failure(self):
        svc = card_policy(new_service(backend="torch",
                                      health_failure_threshold=10))
        fields = tick_draw(6)
        try:
            with faults.injected_faults(seed=3) as reg:
                for point in ("forecast.predict", "cost.score",
                              "poolgroup.solve", "fused.tick"):
                    reg.plan(point, mode="error")
                with pytest.raises(faults.FaultInjected):
                    svc.forecast(forecast_draw(1))
                with pytest.raises(faults.FaultInjected):
                    svc.cost(random_cost_inputs(2, n=N, m=M_COLS))
                with pytest.raises(faults.FaultInjected):
                    svc.poolgroup(random_group_inputs(1, 4, 2, 2))
                with pytest.raises(faults.FaultInjected):
                    svc.fused_tick(FT.FusedTickInputs.from_arrays(fields))
            st = svc.stats
            assert st.device_failures == 4
            assert st.fallbacks == 0
            assert st.fused_chained_serves == st.fused_mirror_serves == 0
            assert st.poolgroup_independent_serves == 0
            assert st.cost_errors == st.poolgroup_errors == 1
        finally:
            svc.close()

    def test_degraded_fsm_raises_and_the_probe_heals(self):
        clock = FakeClock()
        svc = card_policy(new_service(
            backend="torch", clock=clock, health_failure_threshold=2,
            health_probe_interval_s=30.0,
        ))
        fields = tick_draw(9)
        want = FT.fused_tick_numpy(FT.FusedTickInputs.from_arrays(fields))
        try:
            with faults.injected_faults(seed=4) as reg:
                reg.plan("fused.tick", mode="error")
                for _ in range(2):
                    with pytest.raises(faults.FaultInjected):
                        svc.fused_tick(FT.FusedTickInputs.from_arrays(fields))
                assert svc.backend_health() == "degraded"
                attempts = reg.attempts["fused.tick"]
                with pytest.raises(SolverDeviceError, match="degraded"):
                    svc.fused_tick(FT.FusedTickInputs.from_arrays(fields))
                assert reg.attempts["fused.tick"] == attempts
                with pytest.raises(SolverDeviceError, match="degraded"):
                    svc.poolgroup(random_group_inputs(1, 4, 2, 2))
                with pytest.raises(SolverDeviceError, match="degraded"):
                    svc.forecast(forecast_draw(2))
                with pytest.raises(CostUnavailable):
                    svc.cost(random_cost_inputs(3, n=N, m=M_COLS))
            clock.advance(31.0)
            got = svc.fused_tick(FT.FusedTickInputs.from_arrays(fields))
            assert_same_bytes(got, want, "after the probe")
            assert svc.backend_health() == "healthy"
            st = svc.stats
            assert st.fallbacks == st.fused_mirror_serves == 0
            assert st.fused_chained_serves == 0
            assert st.poolgroup_independent_serves == 0
        finally:
            svc.close()

    def test_numpy_answers_when_asked_for(self):
        svc = card_policy(new_service(backend="numpy"))
        fields = tick_draw(2)
        try:
            got = svc.fused_tick(FT.FusedTickInputs.from_arrays(fields))
            assert_same_bytes(got, FT.fused_tick_numpy(
                FT.FusedTickInputs.from_arrays(fields)))
            assert svc.stats.fused_mirror_serves == 0
            assert svc.stats.dispatches == 0
        finally:
            svc.close()


class TestPrewarmAndMetrics:
    def test_prewarm_fleet_families(self):
        registry = GaugeRegistry()
        svc = new_service(registry=registry, backend="torch")
        families = ("forecast", "cost", "poolgroup", "fused")
        try:
            report = svc.prewarm(families=families)
            assert set(report) == set(families)
            for family in families:
                assert report[family]["skipped"] is False, report
            assert report["fused"]["fresh_compiles"] == 1
            assert report["forecast"]["fresh_compiles"] == 1
            assert "fresh_compiles" not in report["cost"]
            assert svc.prewarm(families=families) == {
                f: {"skipped": True} for f in families
            }
            st = svc.stats
            assert (st.forecast_dispatches, st.cost_dispatches,
                    st.poolgroup_dispatches, st.fused_dispatches) == (1, 1, 1, 1)
            text = registry.expose_text()
            assert 'karpenter_solver_prewarm_compiles_total{name="fused"' in text
            stages = svc.stage_percentiles()
            for stage in ("cost", "poolgroup", "fused"):
                assert stages[stage]["n"] == 1, stage
        finally:
            svc.close()

    def test_fused_key_is_stable_across_steady_ticks(self):
        svc = new_service(backend="torch")
        try:
            for seed in range(3):  # new values, same shapes
                svc.fused_tick(FT.FusedTickInputs.from_arrays(tick_draw(seed)))
            assert svc.stats.compile_cache_misses == 1
            assert svc.stats.compile_cache_hits == 2
            # 20 -> 24 series stays inside the 32-series bucket
            svc.fused_tick(FT.FusedTickInputs.from_arrays(tick_draw(3, s=24)))
            assert svc.stats.compile_cache_misses == 1
            svc.fused_tick(FT.FusedTickInputs.from_arrays(tick_draw(3, s=40)))
            assert svc.stats.compile_cache_misses == 2
            assert svc.fused_program().captures == 0  # no graphs on the CPU
        finally:
            svc.close()
