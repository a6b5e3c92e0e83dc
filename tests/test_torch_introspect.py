"""The port's solver introspection plane
(karpenter_tpu_torch/observability/devicetelemetry.py, --introspect)
against the reference's, on the CPU.

  * the compile ledger, the storm detector, the memory watermark and the
    resident-entry gauges behave as the reference's on the same scripted
    inputs (both packages, one parametrized test each);
  * the port's service notes its first-time events: the first dispatch
    of a dispatch key (solve on the torch rung, forecast, preempt,
    fused) and the CUDA kernels' build (noted when the plane attaches);
    the cuda rung's cost attribution (ops/fused_assign.solve_cost, the
    kernels' analytic operations and bytes) reaches later dispatch
    spans of its key;
  * the snapshot has the reference's shape, and /debug/solver serves it;
  * a runtime with `introspect` builds the plane, ticks it, answers
    /debug/solver enabled: true, and its decisions equal the run with
    the plane off; the CPU reports no device memory (memory_source None).
"""

from __future__ import annotations

import importlib
import json
import types
import urllib.request

import pytest

from karpenter_tpu_torch import kernels, workloads
from karpenter_tpu_torch.api.serialization import to_dict
from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.observability import (
    FlightRecorder,
    MetricsServer,
    SolverIntrospection,
    default_tracer,
    reset_default_tracer,
    set_default_tracer,
)
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.ops.binpack import inputs_from_numpy
from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
from karpenter_tpu_torch.solver import SolverService
from karpenter_tpu_torch.store import Store

REF, PORT = "karpenter_tpu", "karpenter_tpu_torch"


def tele(package):
    return importlib.import_module(
        f"{package}.observability.devicetelemetry"
    )


def registry_of(package):
    return importlib.import_module(f"{package}.metrics.registry").GaugeRegistry()


def recorder_of(package):
    return importlib.import_module(
        f"{package}.observability.flightrecorder"
    ).FlightRecorder()


def binpack(pods=40, types=6, seed=0):
    return inputs_from_numpy(
        workloads.build_inputs(pods, types, 4, 4, seed=seed), device="cpu"
    )


class TestPlaneAgainstTheReference:
    @pytest.mark.parametrize("package", [REF, PORT])
    def test_ledger_tail_and_ring(self, package):
        ledger = tele(package).CompileLedger(capacity=4, clock=lambda: 5.0)
        for i in range(6):
            ledger.record(family="solve" if i % 2 else "fused", rung=f"r{i}",
                          seconds=0.1 * i, trace_ids=[f"t{i}"],
                          extents=(2, 1) if i == 5 else None,
                          flops=float(i), bytes_accessed=2.0 * i)
        rows = ledger.tail()
        assert [r["rung"] for r in rows] == ["r2", "r3", "r4", "r5"]
        assert rows[-1]["extents"] == (2, 1)
        assert ledger.by_family == {"fused": 3, "solve": 3}
        assert ledger.tail(limit=0) == []
        assert ledger.records_total == 6

    def test_ledgers_equal(self):
        tails = []
        for package in (REF, PORT):
            ledger = tele(package).CompileLedger(capacity=8, clock=lambda: 1.0)
            for i in range(3):
                ledger.record(family="solve", rung=f"r{i}", seconds=i / 3,
                              trace_ids=[f"t{i}"], flops=float(i))
            tails.append(ledger.tail())
        assert tails[0] == tails[1]

    @pytest.mark.parametrize("package", [REF, PORT])
    def test_storm_arms_trips_once_and_rearms(self, package):
        recorder = recorder_of(package)
        registry = registry_of(package)
        plane = tele(package).SolverIntrospection(
            enabled=True, registry=registry, recorder=recorder,
            storm_threshold=2, stats_source=lambda: [],
        )
        for n in (3, 1):  # a cold boot's taper: not armed yet
            for _ in range(n):
                plane.ledger.record(family="solve", rung="r", seconds=0.1)
            plane.on_tick()
        assert plane.storms_total == 0
        plane.on_tick()  # zero-record tick arms
        for i in range(3):
            plane.ledger.record(family="solve", rung=f"r{i}", seconds=0.1,
                                trace_ids=[f"t{i}"])
        plane.on_tick()
        plane.ledger.record(family="solve", rung="r9", seconds=0.1)
        plane.ledger.record(family="solve", rung="r10", seconds=0.1)
        plane.on_tick()  # same incident
        plane.on_tick()  # re-arms
        plane.ledger.record(family="fused", rung="r11", seconds=0.1)
        plane.ledger.record(family="fused", rung="r12", seconds=0.1)
        plane.on_tick()
        assert plane.storms_total == 2
        events = recorder.events(kind="compile_storm")
        assert [e["families"] for e in events] == [["solve"], ["fused"]]
        assert set(events[0]["trace_ids"]) == {"t0", "t1", "t2"}
        assert registry.gauge("solver", "compile_storms_total").get(
            "-", "-") == 2.0

    @pytest.mark.parametrize("package", [REF, PORT])
    def test_memory_watermark_and_gauges(self, package):
        registry = registry_of(package)
        stats = [{"device": "cuda:0", "bytes_in_use": 950,
                  "bytes_limit": 1000}]
        plane = tele(package).SolverIntrospection(
            enabled=True, registry=registry, recorder=recorder_of(package),
            stats_source=lambda: stats, watermark=0.9,
        )
        plane.on_tick()
        assert registry.gauge("device", "bytes_in_use").get(
            "cuda:0", "-") == 950.0
        assert registry.gauge("device", "bytes_limit").get(
            "cuda:0", "-") == 1000.0
        assert plane.memory_source() is True
        stats[0]["bytes_in_use"] = 100
        plane.on_tick()
        assert plane.memory_source() is False
        plane.enabled = False
        assert plane.memory_source() is None

    @pytest.mark.parametrize("package", [REF, PORT])
    def test_resident_entry_gauges_publish_and_retire(self, package):
        registry = registry_of(package)
        entries = [
            {"slot": "entry0", "bytes": 128, "rows": 8, "shape": (8, 2),
             "mode": "single", "tenant": "t1", "age_s": 1.0},
            {"slot": "entry1", "bytes": 256, "rows": 8, "shape": (8, 2),
             "mode": "single", "tenant": None, "age_s": 0.5},
        ]
        plane = tele(package).SolverIntrospection(
            enabled=True, registry=registry, recorder=recorder_of(package),
            stats_source=lambda: [],
        )
        plane.service = types.SimpleNamespace(_resident=types.SimpleNamespace(
            entries=lambda now=None: list(entries)))
        plane.on_tick()
        vec = registry.gauge("solver", "resident_entry_bytes")
        assert vec.get("entry0", "t1") == 128.0
        assert vec.get("entry1", "-") == 256.0
        del entries[1]
        plane.on_tick()
        assert vec.get("entry1", "-") is None

    @pytest.mark.parametrize("package", [REF, PORT])
    def test_disabled_plane_is_mark_free(self, package):
        plane = tele(package).SolverIntrospection(
            enabled=False, stats_source=lambda: [
                {"device": "d", "bytes_in_use": 99, "bytes_limit": 100}],
        )
        plane.note_compile("solve", ("k",), 1.0, cost_fn=lambda: {"flops": 1})
        plane.on_tick()
        assert plane.ledger.records_total == 0
        assert plane.memory_source() is None
        assert plane.snapshot() == {"enabled": False}
        assert plane.dispatch_cost_args(("k",)) == {}

    def test_extract_cost_equals_the_reference(self):
        for analysis in ({"flops": 3, "bytes accessed": 4.5}, [{"flops": 1}],
                         [], None, {"other": 1}):
            assert tele(PORT).extract_cost(analysis) == tele(REF).extract_cost(
                analysis)


class TestServiceLedger:
    def _service(self, **kw):
        registry = GaugeRegistry()
        service = SolverService(registry=registry, device="cpu",
                                backend="torch", **kw)
        plane = SolverIntrospection(
            enabled=True, registry=registry, recorder=FlightRecorder(),
        ).attach(service)
        return service, plane, registry

    def test_first_dispatch_of_a_key_is_noted_once(self):
        service, plane, registry = self._service()
        try:
            service.solve(binpack(seed=0))
            assert plane.ledger.records_total == 1
            row = plane.ledger.tail()[0]
            assert row["family"] == "solve" and row["seconds"] > 0
            assert row["rung"].startswith("torch/")
            # the same bucket again: a hit, no row
            service.solve(binpack(seed=1))
            assert plane.ledger.records_total == 1
            assert registry.gauge("solver", "compile_seconds").count(
                "solve", "-") == 1
        finally:
            service.close()

    def test_forecast_preempt_and_fused_families(self):
        from karpenter_tpu_torch.forecast import models as M
        from karpenter_tpu_torch.ops import fusedtick as FT

        from test_tenancy import random_forecast_inputs

        service, plane, _ = self._service()
        try:
            service.forecast(M.ForecastInputs.from_arrays(
                random_forecast_inputs(0, s=3, t=16)))
            service.preempt(workloads.build_preempt_inputs(2, 6, 10, 0))
            fields = workloads.build_fused_tick_inputs(0, 8, 2, 6, 16)
            service.fused_tick(FT.FusedTickInputs.from_arrays(fields))
            service.fused_tick(FT.FusedTickInputs.from_arrays(fields))
            assert plane.ledger.by_family == {
                "forecast": 1, "preempt": 1, "fused": 1}
        finally:
            service.close()

    def test_kernel_build_is_noted_when_the_plane_attaches(self):
        registry = GaugeRegistry()
        service = SolverService(registry=registry, device="cpu")
        service._kernels_unnoted = 1.25  # as _ensure_kernels leaves it
        try:
            plane = SolverIntrospection(
                enabled=True, registry=registry, recorder=FlightRecorder(),
            ).attach(service)
            row, = plane.ledger.tail()
            assert (row["family"], row["seconds"]) == ("kernels", 1.25)
            assert row["rung"] == "kernels/cuda/" + "+".join(kernels.SOURCES)
            plane.on_tick()
            service._note_kernels()  # once only
            assert plane.ledger.records_total == 1
        finally:
            service.close()

    def test_cost_attribution_reaches_later_spans(self):
        """The cuda rung's attribution (solve_cost) keyed at the first
        dispatch rides every later dispatch span of the key."""
        inputs = binpack(pods=60, types=9, seed=3)
        service, plane, _ = self._service()
        try:
            key = ("cuda", (60, 9), 32, ())
            service._note_compile(
                "solve", key, 0.01,
                cost_fn=lambda: TF.solve_cost(inputs, 32),
            )
            args = service._span_cost_args(key)
            assert args["flops"] > 0 and args["bytes"] > 0
            row = plane.ledger.tail()[0]
            assert (row["flops"], row["bytes_accessed"]) == (
                args["flops"], args["bytes"])
        finally:
            service.close()

    def test_solve_cost_sums_the_kernels_analytic_work(self):
        inputs = binpack(pods=120, types=12, seed=5)
        assigned, hist, _, _ = TF.fused_assign_reference(inputs, 32)
        parts = TF.kernel_cost(inputs, 32, assigned.numpy(), hist.numpy())
        cost = TF.solve_cost(inputs, 32)
        assert cost == {
            "flops": float(sum(p[0] for p in parts.values())),
            "bytes accessed": float(sum(p[1] for p in parts.values())),
        }
        # the fused scan visits at least one group per valid row
        assert parts["fused_assign"][0] >= 120
        before = dict(TF.LAUNCHES)
        TF.solve_cost(inputs, 32)
        assert TF.LAUNCHES == before  # the plain version: no launch

    def test_snapshot_has_the_reference_shape(self):
        """Every section and key of the reference's document, with a
        service attached; the port's shard section is one card's."""
        from karpenter_tpu.observability.devicetelemetry import (
            SolverIntrospection as RefPlane,
        )
        from karpenter_tpu.solver.service import SolverService as RefService

        from test_introspect import _binpack_inputs

        service, plane, _ = self._service()
        ref_service = RefService(registry=registry_of(REF), backend="xla")
        ref_plane = RefPlane(enabled=True, registry=registry_of(REF),
                             recorder=recorder_of(REF),
                             stats_source=lambda: []).attach(ref_service)
        try:
            service.solve(binpack())
            ref_service.solve(_binpack_inputs())
            plane.on_tick()
            ref_plane.on_tick()
            doc, ref_doc = plane.snapshot(), ref_plane.snapshot()
            assert doc.keys() == ref_doc.keys()
            for section in doc:
                if isinstance(doc[section], dict):
                    assert doc[section].keys() == ref_doc[section].keys(), (
                        section)
            assert doc["compile"]["cache"]["rungs"].keys() == {"solve"}
            assert doc["device_memory"]["devices"] == []
            assert doc["shard"]["devices"] == 0
            json.dumps(doc)
        finally:
            service.close()
            ref_service.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


def runtime_world(introspect: bool):
    store, provider = Store(), FakeFactory()
    world = workloads.build_runtime_world(store, provider, 300, 4, 8, 2, 0,
                                          groups=1)
    clock = {"now": 1_000_000.0}
    rt = KarpenterRuntime(
        Options(device="cpu", introspect=introspect,
                introspect_storm_threshold=2),
        store=store, cloud_provider_factory=provider,
        clock=lambda: clock["now"],
    )
    rt.solver_service.backend = "torch"  # a rung that counts its keys
    return rt, world, clock, store, provider


def tick_world(rt, world, clock, ticks):
    for _ in range(ticks):
        clock["now"] += 5.0
        world.step_queues()
        workloads.churn_reconcile(world.cluster, 10)()
        rt.manager.reconcile_all()


class TestRuntimePlane:
    def test_debug_solver_and_metrics(self):
        rt, world, clock, _, _ = runtime_world(True)
        server = MetricsServer(rt.registry, port=0, host="127.0.0.1",
                               introspection=rt.solver_introspection)
        port = server.start()
        try:
            tick_world(rt, world, clock, 3)
            status, doc = _get(f"http://127.0.0.1:{port}/debug/solver")
            assert status == 200 and doc["enabled"] is True
            families = {row["family"] for row in doc["compile"]["ledger_tail"]}
            assert "solve" in families
            assert doc["compile"]["cache"]["misses"] >= 1
            assert doc["device_memory"]["devices"] == []
            text = rt.registry.expose_text()
            assert "karpenter_solver_compile_seconds" in text
            # the CPU reports no memory: the self-SLO source stays quiet
            assert rt.solver_introspection.memory_source() is None
            assert rt.selfslo.scoreboard()["device_memory"] == "off"
        finally:
            server.stop()
            rt.close()

    def test_off_and_on_decide_the_same(self):
        """The plane observes; it never changes a decision. Off, it
        records nothing."""
        snapshots, records = [], []
        for introspect in (False, True):
            rt, world, clock, store, provider = runtime_world(introspect)
            try:
                tick_world(rt, world, clock, 3)
                snapshots.append(workloads.runtime_snapshot(
                    store, rt.registry, provider, to_dict,
                    skip=workloads.SNAPSHOT_SKIP + ("karpenter_solver_",)))
                records.append(rt.solver_introspection.ledger.records_total)
            finally:
                rt.close()
        assert snapshots[0] == snapshots[1]
        assert records[0] == 0 and records[1] > 0

    def test_reset_caches_storm_records_one_event(self):
        rt, world, clock, _, _ = runtime_world(True)
        recorder = rt.flight_recorder
        try:
            tick_world(rt, world, clock, 2)
            rt.solver_introspection.on_tick()  # a zero-record tick arms
            before = len(recorder.events(kind="compile_storm"))
            rt.solver_service.reset_caches()
            rt.solver_service.solve(binpack(pods=50, types=4, seed=1),
                                    backend="torch")
            rt.solver_service.solve(binpack(pods=300, types=40, seed=2),
                                    backend="torch")
            rt.solver_introspection.on_tick()
            assert rt.solver_introspection.storms_total == 1
            assert len(recorder.events(kind="compile_storm")) == before + 1
        finally:
            rt.close()


@pytest.fixture(autouse=True)
def _own_tracer():
    saved = default_tracer()
    reset_default_tracer()
    yield
    set_default_tracer(saved)
