"""The HorizontalAutoscaler reconcile tick of the port, end to end on the
CPU, against the reference's.

workloads.build_ha_fleet builds runtime.py's HA world (store, SNGs, HAs
with forecast / SLO / scaling rules, pool groups, queue gauges, the
forecast, cost and pool-group engines, BatchAutoscaler behind the HA
controller) from either package's classes (`api=`), with a solve service
of the same package behind every seam. Over 12 ticks the port and the
reference (CPU, backend="numpy") give the same replica trail, HA
statuses, error map and registry exposition, with the fused tick on and
off; fused on and off give the same trail, with one device program per
steady tick against two or more. This is the port's counterpart of
tests/test_fusedtick.py::TestFusedRuntimeFixedPoint. Integers are exact
and f32 bitwise (the statuses carry the f32-derived values as Python
floats, compared with ==).

Sizes: 48 HAs (N = 64 after pad_to) x 3 metrics, about 24 forecast
series (S bucket 32) with 16 history samples (T = 16), 2 pool groups of
4 pools.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib

import pytest

import karpenter_tpu.solver as ref_solver
from karpenter_tpu.metrics.registry import GaugeRegistry as RefRegistry
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.solver import SolverService
from karpenter_tpu_torch.utils import operands

REPO = pathlib.Path(__file__).resolve().parents[1]
N_HAS, METRICS, GROUPS, HISTORY, TICKS = 48, 3, 2, 16, 12


def reference_api():
    from karpenter_tpu import autoscaler, cost, forecast, poolgroups, store
    from karpenter_tpu.api import (
        core,
        horizontalautoscaler,
        poolgroup,
        scalablenodegroup,
    )
    from karpenter_tpu.controllers import horizontalautoscaler as controller
    from karpenter_tpu.metrics import clients, registry

    return workloads.ha_api_namespace({
        "api.core": core,
        "api.horizontalautoscaler": horizontalautoscaler,
        "api.poolgroup": poolgroup,
        "api.scalablenodegroup": scalablenodegroup,
        "autoscaler": autoscaler,
        "controllers.horizontalautoscaler": controller,
        "cost": cost,
        "forecast": forecast,
        "metrics.clients": clients,
        "metrics.registry": registry,
        "poolgroups": poolgroups,
        "store": store,
    })


def errors_of(results):
    return {
        key: None if err is None else (type(err).__name__, str(err))
        for key, err in results.items()
    }


def run(package, fused, backend="numpy", ticks=TICKS, seed=0, n_has=N_HAS):
    """(trail per tick, statuses per tick, error maps, final exposition,
    service stats) of one world."""
    if package == "port":
        svc = SolverService(
            registry=GaugeRegistry(), device="cpu", backend=backend
        )
        api = workloads.ha_api()
    else:
        svc = ref_solver.SolverService(registry=RefRegistry(), backend=backend)
        api = reference_api()
    trails, statuses, errors = [], [], []
    try:
        fleet = workloads.build_ha_fleet(
            n_has, METRICS, seed, service=svc, groups=GROUPS, pools=4,
            fused=fused, history=HISTORY, api=api,
        )
        for _ in range(ticks):
            errors.append(errors_of(fleet.tick()))
            svc.note_tick()
            trails.append(fleet.trail())
            statuses.append(fleet.statuses())
        stats = dataclasses.replace(svc.stats)
        return trails, statuses, errors, fleet.registry.expose_text(), stats
    finally:
        svc.close()


@pytest.fixture(scope="module")
def reference_worlds():
    return {fused: run("reference", fused) for fused in (False, True)}


class TestTheTickEqualsTheReference:
    @pytest.mark.parametrize("backend", ["numpy", "torch"])
    @pytest.mark.parametrize("fused", [False, True], ids=["chained", "fused"])
    def test_trail_statuses_errors_and_gauges(
        self, reference_worlds, fused, backend
    ):
        want = reference_worlds[fused]
        got = run("port", fused, backend=backend)
        for tick in range(TICKS):
            assert got[0][tick] == want[0][tick], f"trail, tick {tick}"
            assert got[1][tick] == want[1][tick], f"statuses, tick {tick}"
            assert got[2][tick] == want[2][tick], f"errors, tick {tick}"
        assert got[3] == want[3], "registry exposition"

    def test_the_world_exercises_every_stage(self, reference_worlds):
        trails, statuses, errors, text, stats = reference_worlds[False]
        # replicas move, no row fails, and every engine exported gauges
        assert trails[0] != trails[-1]
        assert all(err is None for tick in errors for err in tick.values())
        for series in ("karpenter_forecast_skill", "karpenter_cost_expected_hourly",
                       "karpenter_poolgroup_", "karpenter_queue_length{"):
            assert series in text, series
        assert stats.forecast_calls == TICKS
        assert stats.cost_calls == TICKS and stats.poolgroup_calls == TICKS
        conditions = {c[0] for row in statuses[-1] for c in row[3]}
        assert {"AbleToScale", "ScalingUnbounded", "Forecasting"} <= conditions


class TestFusedOnAndOff:
    def test_same_trail_one_program_per_tick(self):
        chained = run("port", False, backend="torch")
        fused = run("port", True, backend="torch")
        assert fused[0] == chained[0]
        assert fused[1] == chained[1]
        assert fused[3] == chained[3]
        fs, cs = fused[4], chained[4]
        assert fs.fused_calls == fs.fused_dispatches == TICKS
        assert fs.fused_chained_serves == fs.fused_mirror_serves == 0
        assert fs.last_dispatches_per_tick == 1
        assert cs.last_dispatches_per_tick >= 2
        assert cs.fused_calls == 0
        # a steady fleet keeps one fused shape class
        assert fs.compile_cache_misses == 1

    def test_each_family_call_fetches_once(self):
        """The decide, forecast, cost and poolgroup answers of a chained
        tick on the torch rung come back in one fetch per family call."""
        svc = SolverService(registry=GaugeRegistry(), device="cpu",
                            backend="torch")
        try:
            fleet = workloads.build_ha_fleet(
                N_HAS, METRICS, 1, service=svc, groups=GROUPS, pools=4,
                history=HISTORY,
            )
            fleet.tick()
            before = operands.FETCHES["count"]
            calls = (svc.stats.decide_calls + svc.stats.forecast_calls
                     + svc.stats.cost_calls + svc.stats.poolgroup_calls)
            fleet.tick()
            calls = (svc.stats.decide_calls + svc.stats.forecast_calls
                     + svc.stats.cost_calls + svc.stats.poolgroup_calls
                     - calls)
            assert calls == 4
            assert operands.FETCHES["count"] - before == calls
        finally:
            svc.close()

    def test_fused_tick_fetches_once(self):
        svc = SolverService(registry=GaugeRegistry(), device="cpu",
                            backend="torch")
        try:
            fleet = workloads.build_ha_fleet(
                N_HAS, METRICS, 2, service=svc, groups=GROUPS, pools=4,
                history=HISTORY, fused=True,
            )
            fleet.tick()
            before = operands.FETCHES["count"]
            fleet.tick()
            assert operands.FETCHES["count"] - before == 1
        finally:
            svc.close()


class TestTheWorld:
    def test_draw_is_deterministic_and_sized(self):
        svc = SolverService(registry=GaugeRegistry(), device="cpu")
        try:
            a = workloads.build_ha_fleet(N_HAS, METRICS, 5, service=svc,
                                         groups=GROUPS, history=HISTORY)
            b = workloads.build_ha_fleet(N_HAS, METRICS, 5, service=svc,
                                         groups=GROUPS, history=HISTORY)
            assert len(a.has) == N_HAS
            assert [h.metadata.name for h in a.has] == [
                h.metadata.name for h in b.has]
            assert a.trail() == b.trail()
            forecasting = [h for h in a.has if h.spec.behavior.forecast]
            assert 0 < len(forecasting) < N_HAS
            assert all(len(h.spec.metrics) == 1 for h in forecasting)
            assert len(a.store.list("PoolGroup")) == GROUPS
            assert a.clock["now"] == 1_000_000.0
            a.step_world()
            assert a.clock["now"] == 1_000_000.0 + workloads.TICK_S
        finally:
            svc.close()


    def test_queue_vector_layout_moves_no_decision(self):
        """The reference registers one queue vector; spreading the series
        over several vectors changes the queries' names and nothing the
        tick decides."""
        svc = SolverService(registry=GaugeRegistry(), device="cpu")
        try:
            runs = {}
            for vectors in (1, 4):
                fleet = workloads.build_ha_fleet(
                    N_HAS, METRICS, 3, service=svc, groups=GROUPS,
                    history=HISTORY, queue_vectors=vectors,
                )
                ticks = []
                for _ in range(3):
                    ticks.append((errors_of(fleet.tick()), fleet.trail()))
                text = fleet.registry.expose_text()
                names = {line.split("{")[0] for line in text.splitlines()
                         if line.startswith("karpenter_queue_length")}
                runs[vectors] = ticks, names
            assert runs[1][0] == runs[4][0]
            assert runs[1][1] == {"karpenter_queue_length"}
            assert runs[4][1] == {
                f"karpenter_queue_length_{v:03d}" for v in range(4)}
        finally:
            svc.close()


def filled(registry_cls):
    """A registry of either package with one gauge vec of three series
    and one histogram vec of one, set in the same order."""
    registry = registry_cls()
    gauge = registry.register("queue", "length")
    for name, ns, value in (("a", "default", 3.0), ("b", "default", 7.5),
                            ("a", "batch", 11.0)):
        gauge.set(name, ns, value)
    hist = registry.register("solve", "ms", kind="histogram")
    for value in (0.4, 2.0, 9.0):
        hist.observe("w", "default", value)
    return registry


def answer(client_cls, registry, query):
    try:
        metric = client_cls(registry)._evaluate(query)
    except Exception as err:
        return type(err).__name__, str(err)
    return metric.name, metric.labels, metric.value


@pytest.mark.parametrize("query", [
    'karpenter_queue_length{name="a", namespace="default"}',
    'karpenter_queue_length{namespace="batch",name="a"}',
    'karpenter_queue_length{name="c", namespace="default"}',
    'karpenter_queue_length{name="a"}',
    'karpenter_queue_length{name="b"}',
    'karpenter_queue_length{name="a", namespace="default", le="1"}',
    'karpenter_queue_length',
    'karpenter_solve_ms{name="w", namespace="default"}',
    'karpenter_absent{name="a", namespace="default"}',
])
def test_registry_client_answers_as_the_reference(query):
    """The port's in-process client reads a series named by exactly its
    name and namespace by its key, where the reference scans the vec:
    the same metric, labels and value, or the same error."""
    from karpenter_tpu.metrics.clients import RegistryMetricsClient as Ref
    from karpenter_tpu_torch.metrics.clients import RegistryMetricsClient

    assert answer(RegistryMetricsClient, filled(GaugeRegistry), query) == (
        answer(Ref, filled(RefRegistry), query))


def test_port_walk_covers_the_ha_subpackages():
    """TestPortIsStandalone walks every module of the port; the HA
    slice's subpackages are among them, and none imports jax or the
    reference."""
    port = REPO / "karpenter_tpu_torch"
    banned = ("jax", "jaxlib", "karpenter_tpu")
    for sub in ("autoscaler", "autoscaler/algorithms", "cost", "forecast",
                "poolgroups", "controllers", "api", "metrics",
                "observability", "recovery"):
        files = sorted((port / sub).glob("*.py"))
        assert files, sub
        for path in files:
            tree = ast.parse(path.read_text(), filename=str(path))
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                for name in names:
                    assert name.split(".")[0] not in banned, (path, name)
