"""The port's multi-tenant control plane (karpenter_tpu_torch/tenancy)
against the reference's (karpenter_tpu/tenancy), on the CPU.

The same seeded numpy inputs go through both packages' registries and
schedulers. The reference's service runs its default CPU rung (decide
through its jitted program) with the numpy mirrors for cost, forecast
and the fused tick; the port's service runs its default CPU rung
(numpy) and its `torch` rung (the tensor programs on the CPU). Every
tenant's outputs must be equal, integers exactly and f32 bitwise, and so
must the scheduler's statistics and its karpenter_tenant_* exposition.

Also here: the concat/slice helpers, fairness and the breaker board, the
registry (namespaced stacks, retirement, per-tenant journal dirs, the
tenant-config loader), the weighted deadlines, the seeded chaos case of
docs/multitenancy.md on both packages, and the card rule
(TestCardFailurePolicy: a CPU service held to the card's policy, as
tests/test_torch_solver_service.py does): no tenant is ever answered
from a numpy mirror there.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

import karpenter_tpu.tenancy as RT
from karpenter_tpu.faults import injected_faults as ref_injected_faults
from karpenter_tpu.metrics.registry import GaugeRegistry as RefRegistry
from karpenter_tpu.ops import fusedtick as RFT
from karpenter_tpu.ops.binpack import BinPackInputs as RefBinPackInputs
from karpenter_tpu.simulate import (
    multitenant_cost_inputs as ref_cost_inputs,
    multitenant_fleet_inputs as ref_fleet_inputs,
)
from karpenter_tpu.solver import SolverService as RefService
from karpenter_tpu.tenancy import scheduler as RS
from karpenter_tpu_torch import faults, tenancy as T, workloads
from karpenter_tpu_torch.forecast import models as M
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.ops import cost as CK
from karpenter_tpu_torch.ops import decision as D
from karpenter_tpu_torch.ops import fusedtick as FT
from karpenter_tpu_torch.ops.binpack import inputs_from_numpy
from karpenter_tpu_torch.simulate import (
    multitenant_cost_inputs,
    multitenant_fleet_inputs,
)
from karpenter_tpu_torch.solver import SolverService
from karpenter_tpu_torch.tenancy import scheduler as S

from test_tenancy import (
    random_cost_inputs,
    random_decide_inputs,
    random_forecast_inputs,
)
from test_torch_fusedtick import ref_inputs as ref_tick_inputs
from test_torch_mirrors import assert_same_bytes
from test_torch_solver_service import card_policy

TENANTS = 5


def port_world(n=TENANTS, weights=None, backend="auto", service=None,
               **kw):
    service = service or SolverService(
        registry=GaugeRegistry(), device="cpu", backend=backend
    )
    registry = T.TenantRegistry(
        service=service, registry=GaugeRegistry(),
        specs=[
            T.TenantSpec(id=f"t{i}", weight=weights[i] if weights else 1.0)
            for i in range(n)
        ],
    )
    return service, registry, T.MultiTenantScheduler(registry, service, **kw)


def ref_world(n=TENANTS, weights=None, service=None, **kw):
    service = service or RefService(registry=RefRegistry())
    registry = RT.TenantRegistry(
        service=service, registry=RefRegistry(),
        specs=[
            RT.TenantSpec(id=f"t{i}", weight=weights[i] if weights else 1.0)
            for i in range(n)
        ],
    )
    return service, registry, RT.MultiTenantScheduler(registry, service, **kw)


def tenant_lines(registry) -> list:
    return sorted(
        line for line in registry.expose_text().splitlines()
        if "karpenter_tenant_" in line
    )


def stats_of(scheduler) -> dict:
    return dataclasses.asdict(scheduler.stats)


# -- per-family draws: (reference inputs, port inputs) per tenant ------------


def decide_batch(sizes=(6, 3, 9, 1, 12), forecast=False):
    ref = {
        f"t{i}": random_decide_inputs(
            100 + i, n=n, m=1 + i % 3, k=1 + i % 2, forecast=forecast
        )
        for i, n in enumerate(sizes)
    }
    return ref, {t: D.DecisionInputs.from_arrays(i) for t, i in ref.items()}


def cost_batch(sizes=(6, 3, 9, 1, 12)):
    ref = {
        f"t{i}": random_cost_inputs(200 + i, n=n, m=1 + i % 3)
        for i, n in enumerate(sizes)
    }
    return ref, {t: CK.CostInputs.from_arrays(i) for t, i in ref.items()}


def forecast_batch(shapes=((4, 20), (2, 9), (6, 33), (1, 20), (3, 17))):
    ref = {
        f"t{i}": random_forecast_inputs(300 + i, s=s, t=t)
        for i, (s, t) in enumerate(shapes)
    }
    return ref, {t: M.ForecastInputs.from_arrays(i) for t, i in ref.items()}


def fused_batch(shapes=((8, 2, 6, 20), (4, 3, 5, 12), (12, 2, 10, 24),
                        (6, 1, 3, 20), (9, 2, 8, 40))):
    fields = {
        f"t{i}": workloads.build_fused_tick_inputs(400 + i, n, m, s, t)
        for i, (n, m, s, t) in enumerate(shapes)
    }
    # one tenant carries no cost group, one no forecast: stage presence
    # differs per tenant inside one round
    for name in ("ha_min", "ha_max", "unit_cost", "slo_weight",
                 "max_hourly_cost", "slo_valid", "slo_target", "observed",
                 "demand_base_valid", "prior_point", "prior_sigma2",
                 "prior_valid"):
        fields["t1"][name] = None
    for name in ("forecast", "series_row", "series_col", "series_need",
                 "series_blend"):
        fields["t3"][name] = None
    ref = {t: ref_tick_inputs(f) for t, f in fields.items()}
    return ref, {t: FT.FusedTickInputs.from_arrays(f) for t, f in fields.items()}


def solve_batch(n=TENANTS):
    fields = {
        f"t{i}": workloads.build_inputs(40 + 7 * i, 6 + i, 4, 4, seed=500 + i)
        for i in range(n)
    }
    ref = {t: RefBinPackInputs(**f) for t, f in fields.items()}
    port = {t: inputs_from_numpy(f, device="cpu") for t, f in fields.items()}
    return ref, port


FAMILIES = {
    # family: (draw, port call, reference call)
    "decide": (
        decide_batch,
        lambda s, b: s.decide_all(b),
        lambda s, b: s.decide_all(b),
    ),
    "decide_forecast": (
        lambda: decide_batch(forecast=True),
        lambda s, b: s.decide_all(b),
        lambda s, b: s.decide_all(b),
    ),
    "cost": (
        cost_batch,
        lambda s, b: s.cost_all(b),
        lambda s, b: s.cost_all(b, backend="numpy"),
    ),
    "forecast": (
        forecast_batch,
        lambda s, b: s.forecast_all(b),
        lambda s, b: s.forecast_all(b, backend="numpy"),
    ),
    "fused": (
        fused_batch,
        lambda s, b: s.fused_tick_all(b),
        lambda s, b: s.fused_tick_all(b, backend="numpy"),
    ),
    "solve": (
        solve_batch,
        lambda s, b: s.solve_all(b, buckets=16),
        lambda s, b: s.solve_all(b, buckets=16, backend="numpy"),
    ),
}


def run_family(family, backend, **world_kw):
    draw, port_call, ref_call = FAMILIES[family]
    ref_batch, port_batch = draw()
    svc, preg, sched = port_world(backend=backend, **world_kw)
    rsvc, rreg, rsched = ref_world(**world_kw)
    try:
        got = port_call(sched, port_batch)
        want = ref_call(rsched, ref_batch)
        return (got, want, sched, rsched, preg, rreg)
    finally:
        svc.close()
        rsvc.close()


class TestFamilyParity:
    """Each *_all family: every tenant's outputs equal the reference's
    (integers exact, f32 bitwise), on both CPU rungs of the port."""

    @pytest.mark.parametrize("backend", ["auto", "torch"])
    @pytest.mark.parametrize("family", sorted(FAMILIES))
    def test_each_tenant_equals_the_reference(self, family, backend):
        got, want, sched, rsched, _, _ = run_family(family, backend)
        assert sorted(got) == sorted(want)
        for tenant in want:
            assert_same_bytes(got[tenant], want[tenant], f"{family}.{tenant}")
        assert stats_of(sched) == stats_of(rsched)

    @pytest.mark.parametrize("family", ["decide", "cost", "forecast", "fused"])
    def test_rounds_deferrals_and_exposition(self, family):
        """A round budget smaller than the fleet: several admission
        rounds, deferred tenants, lone oversized tenants — the same
        schedule, counters and karpenter_tenant_* series."""
        weights = [3.0, 1.0, 0.5, 2.0, 1.0]
        got, want, sched, rsched, preg, rreg = run_family(
            family, "torch", weights=weights, max_rows_per_round=10
        )
        for tenant in want:
            assert_same_bytes(got[tenant], want[tenant], f"{family}.{tenant}")
        assert stats_of(sched) == stats_of(rsched)
        assert sched.stats.admission_rounds > 1
        if family != "forecast":  # forecast groups by T bucket first
            assert sched.stats.deferrals > 0
        assert tenant_lines(preg.metrics_registry) == tenant_lines(
            rreg.metrics_registry
        )

    def test_solve_all_rides_the_coalescing_queue(self):
        """Every tenant's bin-pack is submitted before any is awaited:
        the torch rung coalesces them into fewer dispatches than
        tenants, each answer equal to its own direct solve."""
        from karpenter_tpu_torch.ops.binpack import solve

        ref_batch, port_batch = solve_batch(8)
        svc, _, sched = port_world(8, backend="torch")
        svc.window_s = 0.05
        svc.adaptive_window = False
        try:
            out = sched.solve_all(port_batch, buckets=16)
            assert svc.stats.dispatches < len(port_batch)
            for tenant, inputs in port_batch.items():
                direct = solve(inputs, buckets=16, backend="torch",
                               device="cpu")
                for f in dataclasses.fields(direct):
                    np.testing.assert_array_equal(
                        np.asarray(getattr(out[tenant], f.name)),
                        getattr(direct, f.name).numpy(),
                        err_msg=f"{tenant}.{f.name}",
                    )
            assert sched.stats.solve_requests == 8
        finally:
            svc.close()


class TestConcatSliceParity:
    """The concatenation/scatter helpers build the same operands as the
    reference's, byte for byte, and a tenant's slice of a shared answer
    equals its own dispatch."""

    def test_decision_concat(self):
        ref, port = decide_batch(forecast=True)
        tenants = sorted(ref)
        assert_same_bytes(
            S.concat_decision_inputs([port[t] for t in tenants]),
            RS.concat_decision_inputs([ref[t] for t in tenants]),
            "decision",
        )

    def test_cost_concat(self):
        ref, port = cost_batch()
        tenants = sorted(ref)
        assert_same_bytes(
            S.concat_cost_inputs([port[t] for t in tenants]),
            RS.concat_cost_inputs([ref[t] for t in tenants]),
            "cost",
        )

    def test_forecast_concat(self):
        ref, port = forecast_batch(((4, 20), (2, 20), (6, 20)))
        tenants = sorted(ref)
        assert_same_bytes(
            S.concat_forecast_inputs([port[t] for t in tenants]),
            RS.concat_forecast_inputs([ref[t] for t in tenants]),
            "forecast",
        )

    def test_fused_concat_spans_and_slices(self):
        ref, port = fused_batch()
        tenants = sorted(ref)
        stacked, spans = S.concat_fused_inputs([port[t] for t in tenants])
        ref_stacked, ref_spans = RS.concat_fused_inputs(
            [ref[t] for t in tenants]
        )
        assert spans == ref_spans
        assert_same_bytes(stacked, ref_stacked, "fused")
        out = FT.fused_tick_numpy(stacked)
        offset = 0
        for tenant in tenants:
            n = int(np.asarray(port[tenant].decision.spec_replicas).shape[0])
            assert_same_bytes(
                S.slice_fused_outputs(out, offset, offset + n, spans[offset]),
                RS.slice_fused_outputs(
                    RFT.fused_tick_numpy(ref_stacked), offset, offset + n,
                    ref_spans[offset],
                ),
                tenant,
            )
            offset += n

    def test_mixed_now_epochs_refuse_to_concatenate(self):
        a = D.DecisionInputs.from_arrays(random_decide_inputs(1, now=10.0))
        b = D.DecisionInputs.from_arrays(random_decide_inputs(2, now=20.0))
        with pytest.raises(ValueError, match="now"):
            S.concat_decision_inputs([a, b])

    @pytest.mark.parametrize("family", ["decide", "cost", "fused"])
    def test_floors_equal_the_reference(self, family):
        ref, port = {
            "decide": decide_batch, "cost": cost_batch, "fused": fused_batch,
        }[family]()
        fn = {"decide": "decide_hold", "cost": "cost_blind",
              "fused": "fused_hold"}[family]
        for tenant in ref:
            assert_same_bytes(
                getattr(S, fn)(port[tenant]), getattr(RS, fn)(ref[tenant]),
                f"{fn}.{tenant}",
            )

    def test_forecast_floor_equals_the_reference(self):
        ref, port = forecast_batch()
        for tenant in ref:
            assert_same_bytes(
                S.forecast_invalid(port[tenant]),
                RS.forecast_invalid(ref[tenant]), tenant,
            )


class TestFairnessAndBreakers:
    @pytest.mark.parametrize("seed", range(4))
    def test_admission_rounds_equal_the_reference(self, seed):
        rng = np.random.RandomState(seed)
        tenants = [f"t{i}" for i in range(9)]
        demand = {t: int(rng.randint(1, 40)) for t in tenants}
        weights = {t: float(rng.choice([0.5, 1.0, 3.0])) for t in tenants}
        groups = {"t1": "g", "t4": "g"} if seed % 2 else {}
        port, ref = T.WeightedAdmission(budget_rows=32), RT.WeightedAdmission(
            budget_rows=32
        )
        for _ in range(5):
            assert port.rounds(demand, weights, groups) == ref.rounds(
                demand, weights, groups
            )

    def test_breaker_board_trip_probe_recover(self):
        now = {"t": 0.0}
        port = T.TenantBreakerBoard(threshold=2, reset_s=5.0,
                                    clock=lambda: now["t"])
        ref = RT.TenantBreakerBoard(threshold=2, reset_s=5.0,
                                    clock=lambda: now["t"])
        trail = []
        for board in (port, ref):
            now["t"] = 0.0
            seen = []
            seen.append(board.record_failure("a"))
            seen.append(board.record_failure("a"))
            seen.append(board.gate("a"))
            now["t"] = 6.0
            seen.append(board.gate("a"))
            seen.append(board.gate("a"))
            seen.append(board.record_success("a"))
            seen.append(board.gate("a"))
            trail.append(seen)
        assert trail[0] == trail[1]


class TestTenantRegistry:
    def test_namespaced_stacks_and_retirement(self):
        _, reg, sched = port_world(3)
        _, rreg, rsched = ref_world(3)
        for r in (reg, rreg):
            ctx = r.get("t1")
            assert ctx.store is not r.get("t0").store
            assert ctx.forecaster is not r.get("t0").forecaster
            r.remove("t1")
            assert "t1" not in r
        assert tenant_lines(reg.metrics_registry) == tenant_lines(
            rreg.metrics_registry
        )
        assert not any('name="t1"' in line
                       for line in tenant_lines(reg.metrics_registry))
        sched.service.close()
        rsched.service.close()

    def test_per_tenant_journal_dirs(self, tmp_path):
        reg = T.TenantRegistry(
            service=None, journal_dir=str(tmp_path / "p"),
            specs=[T.TenantSpec(id="a"), T.TenantSpec(id="b")],
        )
        rreg = RT.TenantRegistry(
            service=None, journal_dir=str(tmp_path / "r"),
            specs=[RT.TenantSpec(id="a"), RT.TenantSpec(id="b")],
        )
        for r, root in ((reg, "p"), (rreg, "r")):
            assert r.journal_dir_for("a") == str(tmp_path / root / "tenants" / "a")
            assert r.get("b").journal_dir == str(tmp_path / root / "tenants" / "b")
        assert (reg.get("a").recovery() is not None) == (
            rreg.get("a").recovery() is not None
        )
        reg.close()
        rreg.close()

    @pytest.mark.parametrize("doc,error", [
        ([{"id": "a", "weight": 2.0, "poolGroup": "g"}, {"id": "b"}], None),
        ({"tenants": [{"id": "a", "forecastHistory": 8}]}, None),
        ([{"id": "a"}, {"id": "a"}], "duplicate"),
        ([{"id": "a", "weight": 0}], "weight"),
        ([{"id": "a/b"}], "path-safe"),
        ({"tenants": {"id": "a"}}, "LIST"),
    ])
    def test_load_tenant_config_equals_the_reference(self, tmp_path, doc,
                                                     error):
        path = tmp_path / "tenants.json"
        path.write_text(json.dumps(doc))
        if error:
            with pytest.raises(ValueError, match=error):
                T.load_tenant_config(str(path))
            with pytest.raises(ValueError, match=error):
                RT.load_tenant_config(str(path))
            return
        got = [dataclasses.asdict(s) for s in T.load_tenant_config(str(path))]
        want = [
            {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
            for s in RT.load_tenant_config(str(path))
        ]
        assert got == want


class TestWeightedDeadlines:
    def _ticking(self):
        ticks = {"now": 0.0}

        def clock():
            ticks["now"] += 1.0
            return ticks["now"]

        return clock

    @pytest.mark.parametrize("deadline", [None, 10.0])
    def test_escapes_equal_the_reference(self, deadline):
        kw = dict(weights=[10.0, 0.1, 0.1], max_rows_per_round=6,
                  deadline_s=deadline)
        ref, port = cost_batch((6, 6, 6))
        svc, preg, sched = port_world(3, clock=self._ticking(), **kw)
        rsvc, rreg, rsched = ref_world(3, clock=self._ticking(), **kw)
        try:
            got = sched.cost_all(port)
            want = rsched.cost_all(ref, backend="numpy")
            for tenant in want:
                assert_same_bytes(got[tenant], want[tenant], tenant)
            assert stats_of(sched) == stats_of(rsched)
            assert (sched.stats.deadline_escapes > 0) == (deadline is not None)
            assert sched.stats.tenant_failures == 0
            assert tenant_lines(preg.metrics_registry) == tenant_lines(
                rreg.metrics_registry
            )
        finally:
            svc.close()
            rsvc.close()

    def test_budgets_scale_with_weight(self):
        svc, reg, sched = port_world(2, weights=[3.0, 1.0], deadline_s=8.0)
        try:
            budgets = sched._deadline_budgets(["t0", "t1"], reg.weights())
            assert budgets == {"t0": pytest.approx(12.0),
                               "t1": pytest.approx(4.0)}
        finally:
            svc.close()


def lockstep(package, fault_tenant=None, card=False, ticks=6):
    """docs/multitenancy.md's chaos case: four tenants stepped in
    lockstep (decide -> cost -> feed back), one optionally at 100%
    injected faults on its gather point. Returns (replicas, stats)."""
    if package == "ref":
        service, _, sched = ref_world(
            4, breaker_threshold=2, breaker_reset_s=3600.0
        )
        fleet, costs, inject = ref_fleet_inputs, ref_cost_inputs, \
            ref_injected_faults
        backend = "numpy"
    else:
        service = SolverService(registry=GaugeRegistry(), device="cpu",
                                backend="torch")
        if card:
            card_policy(service)
        service, _, sched = port_world(
            4, service=service, breaker_threshold=2, breaker_reset_s=3600.0
        )
        fleet, costs, inject = multitenant_fleet_inputs, \
            multitenant_cost_inputs, faults.injected_faults
        backend = None
    replicas = {f"t{i}": np.full(3, 2, np.int32) for i in range(4)}
    try:
        with inject(seed=11) as reg:
            if fault_tenant:
                reg.plan(f"tenancy.gather.{fault_tenant}", mode="error",
                         probability=1.0)
            for tick in range(ticks):
                now = 1000.0 + tick * 10.0
                batch = {
                    tid: fleet(i, 3, 2, 5, tick, replicas[tid], now)
                    for i, tid in enumerate(sorted(replicas))
                }
                decided = sched.decide_all(batch)
                refined = sched.cost_all(
                    {tid: costs(batch[tid], decided[tid].desired)
                     for tid in decided},
                    backend=backend,
                )
                for tid in refined:
                    replicas[tid] = np.asarray(refined[tid].desired, np.int32)
        return replicas, dataclasses.asdict(sched.stats)
    finally:
        service.close()


class TestIsolationChaos:
    def test_one_tenant_at_full_faults_both_packages(self):
        """All four tenants' lockstep trajectories equal the no-fault
        run, on the reference and on the port, and the two packages'
        trajectories and counters equal each other."""
        clean, _ = lockstep("port")
        ref_clean, _ = lockstep("ref")
        chaotic, stats = lockstep("port", fault_tenant="t1")
        ref_chaotic, ref_stats = lockstep("ref", fault_tenant="t1")
        for tid in clean:
            np.testing.assert_array_equal(clean[tid], ref_clean[tid])
            np.testing.assert_array_equal(clean[tid], chaotic[tid])
            np.testing.assert_array_equal(chaotic[tid], ref_chaotic[tid])
        assert stats == ref_stats
        assert stats["breaker_trips"] >= 1 and stats["mirror_served"] >= 1

    def test_shared_dispatch_failure_isolates_per_tenant(self):
        ref, port = cost_batch((6, 3, 9))
        svc, _, sched = port_world(3, backend="torch")
        rsvc, _, rsched = ref_world(3)
        try:
            with faults.injected_faults(seed=3) as reg:
                reg.plan("cost.score", mode="error", probability=1.0)
                got = sched.cost_all(port)
            with ref_injected_faults(seed=3) as reg:
                reg.plan("cost.score", mode="error", probability=1.0)
                want = rsched.cost_all(ref, backend="xla")
            for tenant in want:
                assert_same_bytes(got[tenant], want[tenant], tenant)
            assert stats_of(sched) == stats_of(rsched)
            assert sched.stats.mirror_served == 3
        finally:
            svc.close()
            rsvc.close()


class TestCardFailurePolicy:
    """The card rule (tenancy/scheduler.py): under the card's policy a
    degraded tenant takes an isolated device dispatch, never a numpy
    mirror; a floor answer keeps the tenant's error."""

    def test_chaos_trajectories_hold_with_no_mirror_serve(self):
        clean, _ = lockstep("port")
        chaotic, stats = lockstep("port", fault_tenant="t1", card=True)
        for tid in clean:
            np.testing.assert_array_equal(clean[tid], chaotic[tid], err_msg=tid)
        assert stats["mirror_served"] == 0
        assert stats["fallback_served"] == 0
        assert stats["breaker_trips"] >= 1
        assert stats["isolated_dispatches"] >= 1

    @pytest.mark.parametrize("family", ["cost", "forecast", "fused"])
    def test_degraded_tenant_is_served_by_its_own_dispatch(self, family):
        draw, port_call, _ = FAMILIES[family]
        _, batch = draw()
        service = card_policy(SolverService(
            registry=GaugeRegistry(), device="cpu", backend="torch"))
        svc, _, sched = port_world(service=service, breaker_threshold=1,
                                   breaker_reset_s=3600.0)
        clean_svc, _, clean = port_world(backend="torch")
        try:
            want = port_call(clean, batch)
            with faults.injected_faults(seed=1) as reg:
                reg.plan("tenancy.gather.t2", mode="error")
                for _ in range(3):
                    got = port_call(sched, batch)
                    for tenant in want:
                        assert_same_bytes(got[tenant], want[tenant], tenant)
            assert sched.breakers.is_open("t2")
            assert sched.stats.mirror_served == 0
            # t2's own dispatch each round (lone-tenant rounds count too)
            assert sched.stats.isolated_dispatches >= 3
            assert sched.errors == {}
        finally:
            svc.close()
            clean_svc.close()

    def test_cpu_keeps_the_numpy_mirror(self):
        _, batch = cost_batch()
        svc, _, sched = port_world(backend="torch", breaker_threshold=1)
        try:
            with faults.injected_faults(seed=1) as reg:
                reg.plan("tenancy.gather.t2", mode="error")
                sched.cost_all(batch)
                sched.cost_all(batch)
            assert sched.stats.mirror_served == 2
            assert not sched.card_rule
        finally:
            svc.close()

    def test_a_failed_isolated_dispatch_answers_the_floor_with_its_error(self):
        _, batch = cost_batch()
        service = card_policy(SolverService(
            registry=GaugeRegistry(), device="cpu", backend="torch",
            health_failure_threshold=100))
        svc, reg_, sched = port_world(service=service)
        try:
            with faults.injected_faults(seed=1) as reg:
                reg.plan("cost.score", mode="error")
                out = sched.cost_all(batch)
            for tenant, inputs in batch.items():
                assert_same_bytes(out[tenant], S.cost_blind(inputs), tenant)
                assert isinstance(sched.errors[tenant], faults.FaultInjected)
            assert sched.stats.mirror_served == 0
            assert sched.stats.fallback_served == len(batch)
            text = reg_.metrics_registry.expose_text()
            assert 'karpenter_tenant_fallback_served_total{name="t0"' in text
        finally:
            svc.close()

    def test_solve_all_serves_alone_on_the_device_or_reports_the_error(self):
        from karpenter_tpu_torch.ops.binpack import solve

        _, batch = solve_batch()
        service = card_policy(SolverService(
            registry=GaugeRegistry(), device="cpu", backend="torch",
            health_failure_threshold=100))
        svc, _, sched = port_world(service=service, breaker_threshold=1)
        try:
            with faults.injected_faults(seed=2) as reg:
                reg.plan("tenancy.gather.t3", mode="error")
                out = sched.solve_all(batch, buckets=16)
            assert sorted(out) == sorted(batch)
            direct = solve(batch["t3"], buckets=16, backend="torch",
                           device="cpu")
            np.testing.assert_array_equal(
                np.asarray(out["t3"].nodes_needed),
                direct.nodes_needed.numpy(),
            )
            assert sched.stats.mirror_served == 0
            assert sched.stats.isolated_dispatches == 1
            with faults.injected_faults(seed=2) as reg:
                reg.plan("solver.dispatch", mode="error")
                out = sched.solve_all(batch, buckets=16)
            # t3's breaker is open: its lone dispatch fails too, and no
            # tenant is answered from numpy
            assert out == {}
            assert sorted(sched.errors) == sorted(batch)
            assert sched.stats.mirror_served == 0
        finally:
            svc.close()

    def test_probe_on_a_running_clock_closes_the_breaker(self):
        now = {"t": 0.0}
        _, batch = cost_batch()
        service = card_policy(SolverService(
            registry=GaugeRegistry(), device="cpu", backend="torch"))
        svc, _, sched = port_world(
            service=service, breaker_threshold=2, breaker_reset_s=10.0,
            clock=lambda: now["t"],
        )
        try:
            with faults.injected_faults(seed=5) as reg:
                reg.plan("tenancy.gather.t1", mode="error")
                sched.cost_all(batch)
                sched.cost_all(batch)
            assert sched.breakers.is_open("t1")
            now["t"] = 11.0
            sched.cost_all(batch)
            assert sched.stats.probes == 1
            assert not sched.breakers.is_open("t1")
            assert sched.stats.mirror_served == 0
        finally:
            svc.close()
