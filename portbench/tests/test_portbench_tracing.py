"""The traced window's reduction: busy time as the union of the device's
intervals, the idle gaps named by the host's innermost range, and the
readers that work from it."""

import pytest

from portbench import readers, tracing
from portbench.harness import Call


def _trace(events, host=(), window=(0, 100)):
    t = tracing.Trace.__new__(tracing.Trace)
    t.events, t.host, t.window_ns = list(events), list(host), window
    return t


def test_busy_is_the_union_and_gaps_the_rest():
    t = _trace([("k1", 10, 30), ("copy", 20, 40), ("k2", 60, 70)])
    assert t.busy_s() == pytest.approx(40e-9)
    assert t.gaps() == [(0, 10), (40, 60), (70, 100)]
    assert t.window_s == pytest.approx(100e-9)


def test_breakdown_names_gaps_by_innermost_host_range():
    t = _trace([("k", 10, 30), ("k", 60, 70)],
               host=[("solver.dispatch", 30, 65), ("aten::copy_", 35, 55)])
    out = t.breakdown()
    assert out["device_ops"] == [["k", pytest.approx(30e-9)]]
    assert out["idle_gaps"][0] == ["aten::copy_", pytest.approx(30e-9)]
    assert ["no host range", pytest.approx(10e-9)] in out["idle_gaps"]


def _record(trace, cost=None, calls=(), quiet_from=0.0, stages=None):
    return {"trace": trace, "kernel_cost": cost or {}, "calls": list(calls),
            "seconds": 1.0, "quiet_from": quiet_from,
            "counters": {"stages": stages or {}}}


def test_roofline_reads_the_launches_of_the_trace():
    # two launches, each 1 us of assign_kernel + 1 us of its reduction:
    # 2 us per launch; the least time of 3.35e6 bytes is 1 us: 50%
    t = _trace([("assign_kernel<3>", 0, 1000), ("demand_reduce_kernel", 1000, 2000),
                ("assign_kernel<3>", 5000, 6000), ("demand_reduce_kernel", 6000, 7000)],
               window=(0, 10_000))
    rec = _record(t, {"fused_assign": (0, 3.35e6)})
    value = readers.kernel_roofline_pct(
        rec, "fused_assign", "assign_kernel",
        ("assign_kernel", "demand_reduce_kernel"))
    assert value == pytest.approx(50.0)
    assert readers.kernel_roofline_pct(
        _record(None, {"fused_assign": (0, 1)}), "fused_assign",
        "assign_kernel", ("assign_kernel",)) is None
    assert readers.kernel_roofline_pct(
        _record(_trace([]), {"fused_assign": (0, 1)}), "fused_assign",
        "assign_kernel", ("assign_kernel",)) is None


def test_idle_share():
    t = _trace([("k", 0, 25)], window=(0, 100))
    assert readers.idle_pct(_record(t)) == pytest.approx(75.0)
    assert readers.idle_pct(_record(None)) is None


def test_kernel_time_per_answer_reads_only_a_whole_window_trace():
    # 3 answered requests; kernels and a memset 60 ns, copies left out
    t = _trace([("assign_kernel", 0, 20), ("Memset (Device)", 20, 30),
                ("Memcpy HtoD (Pageable -> Device)", 30, 90),
                ("shelf_bfd", 90, 120)], window=(0, 200))
    calls = [Call(0, 0, 0.0, 0.1, 0.2, True), Call(0, 1, 0.5, 0.6, 1.4, True),
             Call(1, 0, 0.2, 0.2, 0.5, True), Call(1, 1, 0.4, 0.4, 0.5, False)]
    rec = dict(_record(t, calls=calls), trace_whole=True)
    assert readers.kernel_ms_per_answer(rec) == pytest.approx(60e-6 / 3)
    assert readers.kernel_ms_per_answer(dict(rec, trace_whole=False)) is None
    assert readers.kernel_ms_per_answer(
        dict(rec, trace=None, trace_whole=True)) is None


def test_quiet_rate_counts_answers_after_the_profiler():
    calls = [Call(0, k, t, t, t + 0.1, True) for k, t in
             enumerate((0.1, 1.0, 2.0, 2.5, 3.0))]
    calls.append(Call(1, 0, 2.0, 2.0, 2.2, False))
    rec = dict(_record(_trace([]), calls=calls, quiet_from=1.0), seconds=3.0)
    # answered in [1.0, 3.0]: at 1.1, 2.1, 2.6 (3.1 is past the close)
    assert readers.quiet_rate(rec) == pytest.approx(1.5)
    assert readers.quiet_rate(dict(rec, quiet_from=2.5)) is None
    assert readers.quiet_rate(dict(rec, trace=None)) is None


def test_stage_is_read_only_when_its_ring_is_past_the_profiler():
    # a ring of 3 samples: read where at least 3 answered requests were
    # sent once the profiler was done (at 0.5 s), else nothing
    calls = [Call(0, k, t, t, t + 0.05, True) for k, t in
             enumerate((0.1, 0.6, 0.7, 0.8))]
    stages = {"dispatch": {"p50_ms": 4.5, "p99_ms": 9.0, "n": 3}}
    assert readers.stage_p50_ms(
        _record(None, calls=calls, quiet_from=0.5, stages=stages),
        "dispatch") == 4.5
    assert readers.stage_p50_ms(
        _record(None, calls=calls, quiet_from=0.65, stages=stages),
        "dispatch") is None
    assert readers.stage_p50_ms(_record(None, calls=calls), "queue") is None
