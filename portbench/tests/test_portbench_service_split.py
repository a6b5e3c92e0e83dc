"""The readers of the solve service's split Solve: the cuda rung's
`upload`, `launch`, `sync` and `device` stages, and the share of the
traced window the worker spent in `solver.wait`, on fake records."""

import pytest

from portbench import harness, tracing
from portbench.harness import Call

STAGE_METRICS = {
    "service_upload_ms.binpack": "upload",
    "service_launch_ms.binpack": "launch",
    "service_sync_ms.binpack": "sync",
    "solve_device_ms.binpack": "device",
}
WAIT = "service_wait_pct.binpack"


def reader(name):
    return harness.load_module(harness.PKG / "layer_metrics" / f"{name}.py")


def _trace(events=(), host=(), window=(0, 100)):
    t = tracing.Trace.__new__(tracing.Trace)
    t.events, t.host, t.window_ns = list(events), list(host), window
    return t


def _record(trace=None, calls=(), quiet_from=0.0, stages=None):
    return {"trace": trace, "kernel_cost": {}, "calls": list(calls),
            "seconds": 1.0, "quiet_from": quiet_from,
            "counters": {"stages": stages or {}}}


# four answered requests, sent at 0.1, 0.6, 0.7 and 0.8 s
CALLS = [Call(0, k, t, t, t + 0.05, True)
         for k, t in enumerate((0.1, 0.6, 0.7, 0.8))]


@pytest.mark.parametrize("name,stage", sorted(STAGE_METRICS.items()))
def test_stage_metric_reads_its_stage_past_the_profiler(name, stage):
    stages = {s: {"p50_ms": 1.0 + i, "p99_ms": 9.0, "n": 3}
              for i, s in enumerate(("upload", "launch", "sync", "device",
                                     "dispatch"))}
    read = reader(name).read
    assert read(_record(calls=CALLS, quiet_from=0.5, stages=stages)) == \
        stages[stage]["p50_ms"]
    # a ring of 3 with only 2 requests sent after the profiler: nothing
    assert read(_record(calls=CALLS, quiet_from=0.65, stages=stages)) is None
    # a program without the stage (the parent's cuda rung): nothing
    assert read(_record(calls=CALLS, quiet_from=0.5,
                        stages={"dispatch": stages["dispatch"]})) is None


def test_wait_share_is_the_clipped_union():
    host = [("solver.wait", -50, 10),    # clipped to [0, 10]
            ("solver.wait", 20, 40),
            ("solver.wait", 30, 50),     # overlaps: [20, 50] once
            ("solver.wait", 90, 150),    # clipped to [90, 100]
            ("solver.dispatch", 50, 90),
            ("solver.gauges", 88, 89),
            ("solver.wait", 200, 300)]   # past the window
    value = reader(WAIT).read(_record(_trace(host=host)))
    assert value == pytest.approx(100.0 * (10 + 30 + 10) / 100)


def test_wait_share_is_silent_without_a_trace_or_the_spans():
    read = reader(WAIT).read
    assert read(_record(None)) is None
    # the parent's program opens no worker span
    assert read(_record(_trace(host=[("solver.dispatch", 0, 50)]))) is None
    # a worker that publishes its gauges but never waited
    assert read(_record(_trace(host=[("solver.gauges", 0, 1)]))) == 0.0


def test_breakdown_names_a_gap_by_the_wait():
    t = _trace([("k", 0, 20), ("k", 70, 100)],
               host=[("solver.wait", 25, 65), ("solver.gauges", 20, 24)])
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0] == ["solver.wait", pytest.approx(50e-9)]
