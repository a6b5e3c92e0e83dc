"""One span system on the profiler's clock (observability/tracing.py), on
the CPU:

  * a Tracer span opened while a torch profiler records is also a
    record_function range of the same name on the same OS thread, and
    its exported start lies within 200 us of the profiler's event;
  * `export_jsonl` and the profiler's `export_chrome_trace` of one
    process agree on pid, tid and timebase (`baseTimeNanoseconds`);
  * with no profiler recording a span opens no range;
  * the solve path's spans: binpack_fused opens its steps as children
    of the caller's span, and a SolverService request's spans share its
    trace id while the worker's solver.wait and solver.gauges are roots
    of their own; a wait begun under a profiler is a range in its
    capture, and so is each turn of the worker's loop (`Tracer.range`:
    a range that never enters the ring);
  * publish_gauges' percentiles equal np.percentile's bit for bit.

The cuda rung's stages and events run on the card:
tests/test_torch_trace_cuda.py.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.observability import profiler as P
from karpenter_tpu_torch.observability import tracing as T
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.ops.binpack import BinPackInputs, inputs_from_numpy
from karpenter_tpu_torch.solver import SolverService


@pytest.fixture
def tracer():
    saved = T.default_tracer()
    fresh = T.reset_default_tracer()
    yield fresh
    T.set_default_tracer(saved)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=torch.profiler._ExperimentalConfig(
            profile_all_threads=True
        ),
    )


def _profiled_spans(tracer, tmp_path, names):
    """Open one span of each name (the first on this thread, the rest on
    a second thread) inside a profiler window; returns (the profiler's
    Chrome trace, the tracer's exported events), both as dicts."""
    # the process's first range pays torch's lazy set-up: warm it
    with _profile():
        with tracer.span("warm"):
            pass

    def open_span(name):
        with tracer.span(name):
            time.sleep(0.002)

    with _profile() as prof:
        open_span(names[0])
        for name in names[1:]:
            worker = threading.Thread(target=open_span, args=(name,))
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
    prof.export_chrome_trace(str(tmp_path / "capture.json"))
    tracer.export_jsonl(str(tmp_path / "spans.jsonl"))
    capture = json.loads((tmp_path / "capture.json").read_text())
    spans = [json.loads(line)
             for line in (tmp_path / "spans.jsonl").read_text().splitlines()]
    return capture, spans


class TestOneClock:
    def test_span_is_a_range_on_its_thread_within_200us(self, tracer,
                                                        tmp_path):
        names = ("trace.main_thread", "trace.other_thread")
        capture, spans = _profiled_spans(tracer, tmp_path, names)
        assert capture["baseTimeNanoseconds"] == T.CHROME_BASE_NS
        for name in names:
            (ours,) = [e for e in spans if e["name"] == name]
            (theirs,) = [e for e in capture["traceEvents"]
                         if e.get("name") == name]
            assert theirs["cat"] == "user_annotation"
            assert (ours["pid"], ours["tid"]) == (theirs["pid"],
                                                  theirs["tid"])
            assert abs(ours["ts"] - theirs["ts"]) <= 200.0, (ours, theirs)
            # the span lies inside its range, up to the 20 us that torch's
            # conversion of its own clock to unix time may be off
            assert ours["ts"] >= theirs["ts"] - 20.0
            assert (ours["ts"] + ours["dur"]
                    <= theirs["ts"] + theirs["dur"] + 20.0)
        assert len({e["tid"] for e in spans if e["name"] in names}) == 2

    def test_exports_agree_on_pid_tid_and_timebase(self, tracer, tmp_path):
        capture, spans = _profiled_spans(tracer, tmp_path, ("trace.one",))
        (ours,) = [e for e in spans if e["name"] == "trace.one"]
        (theirs,) = [e for e in capture["traceEvents"]
                     if e.get("name") == "trace.one"]
        assert ours["pid"] == theirs["pid"] == os.getpid()
        assert ours["tid"] == theirs["tid"] == threading.get_native_id()
        # ts is microseconds after the capture's declared base
        now_us = (time.time_ns() - capture["baseTimeNanoseconds"]) / 1e3
        assert 0 < now_us - ours["ts"] < 60e6
        record = tracer.snapshot()[-1]
        assert record["ts_us"] == pytest.approx(ours["ts"], abs=1e-3)
        assert record["tid"] == ours["tid"]

    def test_base_is_kinetos_trimester_floor(self):
        period_ns = 7_889_238 * 10**9
        assert T.CHROME_BASE_NS % period_ns == 0
        assert 0 <= time.time_ns() - T.CHROME_BASE_NS < 2 * period_ns


class _CountingRange:
    opened = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).opened += 1
        return self

    def __exit__(self, *exc):
        return False


class TestRangesOnlyUnderAProfiler:
    @pytest.fixture
    def counting(self, monkeypatch):
        _CountingRange.opened = 0
        monkeypatch.setattr(P, "_ANNOTATION_CLS", _CountingRange)
        return _CountingRange

    def test_no_profiler_no_range(self, tracer, counting):
        assert not T.profiling()
        with tracer.trace("tick"):
            with tracer.span("solver.dispatch"):
                pass
        assert counting.opened == 0
        assert [s["name"] for s in tracer.snapshot()] == [
            "solver.dispatch", "tick"]

    def test_under_a_profiler_each_span_opens_one_range(self, tracer,
                                                        counting):
        with _profile():
            assert T.profiling()
            with tracer.trace("tick"):
                with tracer.span("solver.dispatch"):
                    pass
            handle = tracer.begin("solver.request")  # cross-thread: none
            handle.close()
        assert counting.opened == 2

    def test_a_range_is_never_in_the_ring(self, tracer, counting):
        with tracer.range("solver.worker"):
            pass
        assert counting.opened == 0
        with _profile():
            with tracer.range("solver.worker"):
                pass
        assert counting.opened == 1
        assert tracer.snapshot() == [] and tracer.spans_total == 0

    def test_disabled_tracer_keeps_the_range(self, tracer, counting):
        tracer.enabled = False
        with tracer.span("solver.dispatch"):
            pass
        assert counting.opened == 0
        with _profile():
            with tracer.span("solver.dispatch"):
                pass
        assert counting.opened == 1
        assert tracer.snapshot() == []


def _await_turns(tracer, n, timeout=60.0):
    """Return once the worker has served `n` batches (each closes with a
    solver.gauges span) and had time to block for the next request."""
    deadline = time.monotonic() + timeout
    while sum(s["name"] == "solver.gauges" for s in tracer.snapshot()) < n:
        assert time.monotonic() < deadline, "the worker never finished"
        time.sleep(0.01)
    time.sleep(0.05)


def _inputs(pods=64, types=12, seed=3):
    return BinPackInputs(**workloads.build_inputs(pods, types, 8, 8, seed))


class TestSolveSpans:
    def test_solve_steps_are_children_of_the_callers_span(self, tracer):
        with tracer.trace("caller") as root:
            TF.binpack_fused(inputs_from_numpy(
                workloads.build_inputs(64, 12, 8, 8, 4), device="cpu"))
        spans = {s["name"]: s for s in tracer.snapshot()}
        for name in ("solver.shelf", "solver.tail"):
            assert spans[name]["trace"] == root.trace_id, name
            assert spans[name]["parent"] == root.span_id, name

    def test_request_spans_share_its_trace_and_wait_is_a_root(self, tracer):
        service = SolverService(device="cpu", registry=GaugeRegistry())
        try:
            host = _inputs()
            with tracer.trace("tick") as first:
                service.solve(host, backend="torch")
            _await_turns(tracer, 1)  # the worker then blocks for work
            with tracer.trace("tick") as second:
                out = service.solve(host, backend="torch")
        finally:
            service.close()
        assert np.asarray(out.assigned).shape == (64,)
        spans = tracer.snapshot()
        for root in (first, second):
            names = {s["name"] for s in spans if s["trace"] == root.trace_id}
            assert {"solver.request", "solver.dispatch"} <= names, names
        waits = [s for s in spans if s["name"] == "solver.wait"]
        assert waits, [s["name"] for s in spans]
        # a wait belongs to no request: a root of its own trace
        assert all(s["parent"] is None for s in waits)
        assert not {s["trace"] for s in waits} & {first.trace_id,
                                                  second.trace_id}
        # the wait between the two ticks lies between them
        request_ids = [s for s in spans if s["name"] == "solver.request"]
        end_first = request_ids[0]["ts_us"] + request_ids[0]["dur_us"]
        assert any(s["ts_us"] >= end_first - 1e3 for s in waits)
        gauges = [s for s in spans if s["name"] == "solver.gauges"]
        assert gauges and all(s["parent"] is None for s in gauges)
        worker_tids = {s["tid"] for s in spans
                       if s["name"] in ("solver.wait", "solver.dispatch")}
        assert len(worker_tids) == 1
        assert threading.get_native_id() not in worker_tids

    def test_a_wait_begun_under_a_profiler_is_in_its_capture(self, tracer):
        """The worker blocks for work on a plain condition wait: a wait
        begun while a profiler records is a solver.wait range in its
        capture (one begun before the capture has none)."""
        service = SolverService(device="cpu", registry=GaugeRegistry())
        try:
            host = _inputs()
            service.solve(host, backend="torch")
            _await_turns(tracer, 1)
            with _profile() as prof:
                service.solve(host, backend="torch")
                _await_turns(tracer, 2)  # it blocks again, in the window
                time.sleep(0.2)
                service.solve(host, backend="torch")
                _await_turns(tracer, 3)
        finally:
            service.close()
        events = prof.profiler.kineto_results.events()
        waits = [e for e in events if e.name() == "solver.wait"]
        assert waits
        assert max(e.duration_ns() for e in waits) >= 0.1e9
        assert [e for e in events if e.name() == "solver.gauges"]
        # the worker's turns are ranges in the capture, never spans
        assert [e for e in events if e.name() == "solver.worker"]
        assert "solver.worker" not in {s["name"] for s in tracer.snapshot()}

    def test_an_idle_worker_sleeps_without_waking(self, tracer,
                                                   monkeypatch):
        """An idle worker blocks on its condition with no timeout, so it
        wakes only for work (or the close)."""
        waits = []
        plain_wait = threading.Condition.wait

        def counted_wait(cond, timeout=None):
            if threading.current_thread().name == "solver-service":
                waits.append(timeout)
            return plain_wait(cond, timeout)

        monkeypatch.setattr(threading.Condition, "wait", counted_wait)
        service = SolverService(device="cpu", registry=GaugeRegistry())
        try:
            service.solve(_inputs(), backend="torch")
            _await_turns(tracer, 1)
            seen = len(waits)
            time.sleep(0.3)
            assert len(waits) == seen
        finally:
            service.close()
        assert waits and set(waits) == {None}


class TestGaugePercentiles:
    @pytest.mark.parametrize("n", [1, 2, 3, 7, 100, 255, 256])
    def test_equal_to_numpy_bit_for_bit(self, n):
        from karpenter_tpu_torch.solver.service import _p50_p99

        rng = np.random.default_rng(n)
        for scale in (1e-3, 1.0, 1e3):
            samples = list(rng.random(n) * scale)
            samples += [samples[0]] * (n // 3)  # ties
            want = np.percentile(samples, (50, 99))
            assert _p50_p99(samples) == (float(want[0]), float(want[1]))

    def test_publish_gauges_sets_both_per_stage(self):
        registry = GaugeRegistry()
        service = SolverService(device="cpu", registry=registry)
        try:
            for ms in (1.0, 2.0, 3.0, 10.0):
                service._record_stage("upload", ms / 1e3)
            service.publish_gauges()
        finally:
            service.close()
        text = registry.expose_text()
        want = np.percentile([1.0, 2.0, 3.0, 10.0], (50, 99))
        assert service._g_stage_p50.get("upload", "-") == float(want[0])
        assert service._g_stage_p99.get("upload", "-") == float(want[1])
        assert service._g_upload.get("-", "-") == float(want[0])
        assert "upload" in text


FUSED_CHILDREN = ("solver.fused.pad", "solver.fused.upload",
                  "solver.fused.replay", "solver.fused.fetch")
FUSED_STAGES = ("fused_pad", "fused_upload", "fused_replay", "fused_fetch",
                "fused")


class TestFusedTickSpans:
    """The service's fused tick: one solver.fused_tick span whose children
    are the door's pad and the program's upload, replay and fetch, in
    order, each a stage in the service's rings."""

    @staticmethod
    def _tick(service, seed=0):
        # 40 series pad up the S ladder (48) at the door
        return service.fused_tick(workloads.build_fused_tick_inputs(
            seed, 64, 3, 40, 16, groups=6, pools=4), backend="torch")

    def test_children_in_order_under_one_tick_span(self, tracer):
        service = SolverService(device="cpu", registry=GaugeRegistry())
        try:
            with tracer.trace("tick") as root:
                out = self._tick(service)
        finally:
            service.close()
        assert out.forecast.point.shape == (40,)
        spans = tracer.snapshot()
        (tick,) = [s for s in spans if s["name"] == "solver.fused_tick"]
        assert tick["parent"] == root.span_id
        assert tick["args"] == {"backend": "torch"}
        children = [s for s in spans if s["parent"] == tick["id"]]
        assert tuple(s["name"] for s in children) == FUSED_CHILDREN
        starts = [s["ts_us"] for s in children]
        assert starts == sorted(starts)
        ends = [s["ts_us"] + s["dur_us"] for s in children]
        assert all(end <= start + 1.0 for end, start
                   in zip(ends, starts[1:]))
        assert ends[-1] <= tick["ts_us"] + tick["dur_us"] + 1.0

    def test_stages_fill_their_rings(self, tracer):
        service = SolverService(device="cpu", registry=GaugeRegistry())
        try:
            for seed in range(3):
                self._tick(service, seed)
            samples = {s: service.stage_samples(s) for s in FUSED_STAGES}
            stages = service.stage_percentiles()
        finally:
            service.close()
        for stage in FUSED_STAGES:
            assert len(samples[stage]) == 3, stage
            assert all(ms >= 0 for ms in samples[stage]), stage
            assert stages[stage]["n"] == 3, stage
        # the CPU has no device events
        assert service.stage_samples("fused_device") == []
        # the program's three stages lie inside the rungs' stage
        for i in range(3):
            inside = sum(samples[s][i] for s in FUSED_STAGES[1:4])
            assert inside <= samples["fused"][i] + 1e-6

    def test_the_numpy_rung_opens_no_program_span(self, tracer):
        service = SolverService(device="cpu", registry=GaugeRegistry())
        try:
            service.fused_tick(workloads.build_fused_tick_inputs(
                1, 64, 3, 40, 16), backend="numpy")
        finally:
            service.close()
        names = [s["name"] for s in tracer.snapshot()]
        assert names == ["solver.fused.pad", "solver.fused.numpy",
                         "solver.fused_tick"]
        assert service.stage_samples("fused_upload") == []
