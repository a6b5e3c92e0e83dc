"""The port's seeded `--simulate` worlds against the reference's, on the
CPU, through the CLI a user runs (`python -m karpenter_tpu_torch
--simulate --<world> --device cpu`): each ported scenario's JSON report
equals the reference's at its default seed (this file) and at one other
--sim-seed (tests/test_torch_simulate_seeds.py), and the digests the
reference's tests pin hold on the port's reports (tests/test_simulate.py:
constraints and poolgroups; tests/test_simlab.py::TestCLI: constraints
at --sim-seed 8).

Fields the reference reads off the wall clock differ run to run in
either package and are left out of the comparison: WALL_CLOCK names
each one. Every (world, seed, package) runs once per module.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import zlib

import pytest

REF, PORT = "karpenter_tpu", "karpenter_tpu_torch"

# world -> (flags, the other --sim-seed, or None for an unseeded world);
# the eventloop and restart-storm worlds at fewer arrivals and crashes
# than their CLI defaults, to keep the file's time
WORLDS = {
    "constraints": (["--constraints"], 8),
    "eventloop": (["--eventloop", "--eventloop-arrivals", "30",
                   "--eventloop-storm", "300"], 3),
    "poolgroups": (["--poolgroups"], 5),
    "cost": (["--cost"], 2),
    "forecast": (["--forecast"], 4),
    "restart-storm": (["--restart-storm", "--storm-crashes", "2"], 6),
    "preempt": (["--preempt"], 1),
    "trace": (["--trace-export", "{tmp}/trace.jsonl"], None),
}

# report paths read off the wall clock (the e2e-latency histogram the cost
# replay's runtimes fill on the host clock) and the trace file's path
# tests/test_simulate.py's pinned constraints digests at the default seed
CONSTRAINTS_DIGESTS = {"before": 1761739094, "after": 2968639679}

WALL_CLOCK = {
    "cost": (("e2e_seconds",), ("runs", "warm_on", "e2e_seconds"),
             ("runs", "warm_off", "e2e_seconds")),
    "trace": (("trace_export",),),
}


# spans the port opens where the reference opens none: its solve
# worker's waits and gauge publishes, the cuda rung's steps, and the
# sites that were profiler ranges alone before the port's one span
# system (observability/tracing.py)
PORT_ONLY_SPANS = {
    "solver.wait", "solver.gauges",
    "solver.upload", "solver.fold", "solver.pack", "solver.assign",
    "solver.shelf", "solver.tail", "solver.sync", "solver.fetch",
    "solver.answer", "solver.forecast", "solver.preempt", "solver.shard",
    "pendingcapacity.solve", "autoscaler.decide", "autoscaler.fused_tick",
    "sidecar.solve", "sidecar.decide",
}


def _without_port_spans(report: dict) -> dict:
    """The trace world's span, trace and event counts without the spans
    only the port opens, recounted from its export."""
    with open(report["trace_export"]) as f:
        spans = [e for e in map(json.loads, f) if e["ph"] == "X"]
    kept = [e for e in spans if e["name"] not in PORT_ONLY_SPANS]
    return dict(
        report, spans=len(kept), traces=len({e["cat"] for e in kept}),
        trace_events=report["trace_events"] - (len(spans) - len(kept)),
    )


def _drop(report: dict, paths) -> dict:
    report = json.loads(json.dumps(report))
    for path in paths:
        node = report
        for key in path[:-1]:
            node = node[key]
        assert path[-1] in node, path
        del node[path[-1]]
    return report


def _run(package, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = importlib.import_module(f"{package}.__main__").main(argv)
    assert rc == 0, (package, argv)
    return json.loads(out.getvalue())


def report_cache(tmp_path_factory):
    """get(world, seed, package) -> the world's report, each run once."""
    cache = {}

    def get(world, seed, package):
        key = (world, seed, package)
        if key not in cache:
            tmp = tmp_path_factory.mktemp(f"{world}-{package}")
            flags = [f.format(tmp=tmp) for f in WORLDS[world][0]]
            argv = ["--simulate", *flags, "--no-leader-elect"]
            if seed is not None:
                argv += ["--sim-seed", str(seed)]
            if package == PORT:
                argv += ["--device", "cpu"]
            cache[key] = _run(package, argv)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    return report_cache(tmp_path_factory)


@pytest.mark.parametrize("world", list(WORLDS))
def test_report_equals_the_reference(reports, world):
    skip = WALL_CLOCK.get(world, ())
    port = reports(world, None, PORT)
    if world == "trace":
        port = _without_port_spans(port)
    assert _drop(port, skip) == _drop(reports(world, None, REF), skip)


def test_constraints_digests_pinned(reports):
    default = reports("constraints", None, PORT)
    assert default["digests"] == CONSTRAINTS_DIGESTS
    assert default["dead_zone"] == "z3"


def test_poolgroups_digest_pinned(reports):
    report = reports("poolgroups", None, PORT)
    canon = json.dumps(report, sort_keys=True, separators=(",", ":"))
    assert zlib.crc32(canon.encode()) == 762078142
    assert report["band"]["held_through_storm"] is True


def test_cost_wall_clock_fields_have_the_reference_shape(reports):
    port, ref = reports("cost", None, PORT), reports("cost", None, REF)
    for arm in ("warm_on", "warm_off"):
        got, want = port["runs"][arm]["e2e_seconds"], ref["runs"][arm]["e2e_seconds"]
        assert set(got) == set(want) == {"n", "p50_s", "p99_s"}
        assert got["n"] == want["n"] and got["p99_s"] >= got["p50_s"] > 0


def test_trace_export_written(reports, tmp_path_factory):
    report = reports("trace", None, PORT)
    assert report["trace_events"] > 0 and report["dispatch_spans"] >= 1
    with open(report["trace_export"]) as f:
        assert sum(1 for _ in f) == report["trace_events"]


def test_restart_storm_contract(reports):
    report = reports("restart-storm", None, PORT)
    assert report["duplicate_actuations"] == 0
    assert report["stale_replay_applied"] is False
    assert report["resumed_not_recordoned"] is True


def test_eventloop_contract(reports):
    report = reports("eventloop", None, PORT)
    assert report["fixed_point_match"]
    assert report["event_driven"]["e2e_seconds"]["p99_s"] < 1.0 < \
        report["tick_paced"]["e2e_seconds"]["p99_s"]
