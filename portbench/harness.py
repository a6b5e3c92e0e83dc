"""Runs one cell once: set-up, the measured window, the check, the result.

Everything is found by name. The cell `<config>.<traffic>` in
BENCHMARK.json names a configuration (a file under configs/) and a mix
(mixes/<traffic>.json). The configuration names three modules, each a
file found by path: its program entry ("entry", entries/<name>.py), its
generator ("generator", generators/<name>.py, see traffic.py) and its
plain reference ("reference", reference/<name>.py: `answer(config,
ops)`, `control(config, ops)`, optionally `work(config, ops, answer)`
for the roofline's counts and `NOT_COMPARED`). A mix may name modules of
its own under the same keys, which take precedence. Each metric the cell
reports is a reader file, end_to_end/<name>.py or
layer_metrics/<name>.py, with `read(record)` returning a number, or None
where it finds nothing to read (the metric is then left out). A new
configuration, mix, behaviour of traffic or metric is new files plus
entries in BENCHMARK.json.

The run: draw the traffic from the seed; build the entry (the program's
set-up); warm every shape the traffic uses with the untouched operands
(`warm`); start the profiler once outside the window where the run
reads a trace: a traced run (`--trace 1`) for the mix's
`trace_seconds` (or the whole window), an untraced one whose cell has an
end-to-end metric from the device's trace until the last request sent
in the window is answered; then open the window. Each client sends its
requests on the mix's schedule (traffic.py) until the window closes;
requests still out are waited for, a minute at most.
The program is then closed and its memory freed, and the judge rebuilds
the operands of a sample of each client's answers (drawn from the seed)
and compares them with the plain reference's (judge.py).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

from portbench import judge, traffic

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
LATE_S = 60.0  # how long past the close an answer is waited for


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A file of the benchmark as a module, by path (metric names hold
    dots, which an import statement cannot)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_file_{path.parent.name}_{path.stem}", path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int

    def module(self, role: str) -> ModuleType:
        """The cell's "entry", "generator" or "reference" module: the
        mix's choice, else the configuration's."""
        folder = {"entry": "entries", "generator": "generators",
                  "reference": "reference"}[role]
        name = self.mix.get(role, self.config[role])
        return load_module(PKG / folder / f"{name}.py")

    def traffic(self, seed: int):
        return self.module("generator").Traffic(self.config, self.mix, seed)


def compared(reference: ModuleType, want: dict) -> dict:
    """A reference's answer without what it keeps uncompared."""
    skip = getattr(reference, "NOT_COMPARED", ())
    return {n: v for n, v in want.items() if n not in skip}


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    mix = load_json(PKG / "mixes" / f"{cell['traffic']}.json")
    return Cell(
        name=name, config=config, mix=mix,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        chips=int(cell["chips"]),
    )


@dataclass
class Call:
    client: int
    k: int
    due: float  # seconds after the window opened
    sent: float
    done: float = float("nan")
    ok: bool = False


@dataclass
class Sample:
    """One client's reservoir of answers to check (Algorithm R over its
    answers in order, its draws from the seed)."""

    size: int
    rng: np.random.Generator
    seen: int = 0
    kept: Dict[int, dict] = field(default_factory=dict)

    def offer(self, k: int, answer: dict) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept[k] = answer
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            del self.kept[sorted(self.kept)[j]]
            self.kept[k] = answer


@dataclass
class Outcome:
    result: dict
    lines: List[str]  # the numbers compared, each beside its limit


def drive(entry, gen, mix, seconds: float, trace_s: Optional[float],
            samples: List[Sample], tracer):
    """Drive the clients through one window. The tracer, if any, stops
    `trace_s` seconds into the window, or with `trace_s` None once every
    request sent in the window has been answered (or given up on), so
    that its trace holds all their device work. Returns (t0 on the
    perf_counter clock, the calls, the traced span (start, stop, and the
    end of the profiler's own processing after it) in window seconds or
    None, the clients still out a minute past the close)."""
    clients, rate = int(mix["clients"]), float(mix["rate_per_s"])
    calls: List[Call] = []
    lock = threading.Lock()
    closing = threading.Event()
    if tracer is not None:
        tracer.start()
    t0 = time.perf_counter() + 0.005
    t_end = t0 + seconds

    def client(c: int) -> None:
        k = 0
        while True:
            due = t0 + traffic.due_offset(c, k, clients, rate)
            if due >= t_end or time.perf_counter() >= t_end:
                return  # the window has closed: no new request
            gen.update(c, k)
            ops = gen.operands(c)
            wait = due - time.perf_counter()
            if wait > 0 and closing.wait(wait):
                return
            call = Call(c, k, due - t0, time.perf_counter() - t0)
            try:
                answer = entry.call(ops)
                call.ok = True
            except Exception as error:  # noqa: BLE001 — counted as failed
                answer = None
                print(f"client {c} request {k}: {type(error).__name__}: "
                      f"{error}", flush=True, file=sys.stderr)
            call.done = time.perf_counter() - t0
            with lock:
                calls.append(call)
            if answer is not None:
                samples[c].offer(k, answer)
            k += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                name=f"portbench-client-{c}")
               for c in range(clients)]
    traced = None
    while time.perf_counter() < t0:
        time.sleep(0.001)
    for t in threads:
        t.start()

    def stop_tracer():
        tracer.stop()
        return (tracer.started - t0, tracer.stopped - t0,
                time.perf_counter() - t0)

    if tracer is not None and trace_s is not None:
        time.sleep(max(0.0, t0 + min(trace_s, seconds) - time.perf_counter()))
        traced = stop_tracer()
    time.sleep(max(0.0, t_end - time.perf_counter()))
    closing.set()
    deadline = time.perf_counter() + LATE_S
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    hung = sum(t.is_alive() for t in threads)
    if tracer is not None and trace_s is None:
        traced = stop_tracer()
    with lock:
        return t0, list(calls), traced, hung


def warm(entry, gen) -> None:
    """Every shape the traffic uses, with the untouched operands: two
    rounds of one call per client (the first pays lazy loading and the
    allocator's growth)."""
    for _ in range(2):
        for c in range(gen.clients):
            entry.call(gen.operands(c))


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        device, started: float, platform: dict) -> Outcome:
    """One run of `cell`. `device` is where the program runs (the card;
    the CPU only in the benchmark's own tests), `started` the process's
    start on the perf_counter clock, `platform` the result's device
    block without its readings."""
    import torch

    config, mix = cell.config, cell.mix
    on_card = torch.device(device).type == "cuda"
    marks = [("start", started), ("imports", time.perf_counter())]
    gen = cell.traffic(seed)
    marks.append(("draws", time.perf_counter()))
    reference = cell.module("reference")
    entry = cell.module("entry").Entry(config, device)
    marks.append(("program", time.perf_counter()))
    warm(entry, gen)
    if on_card:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    # a traced run profiles the mix's `trace_seconds` and leaves the rest
    # of its window untraced; an untraced run with an end-to-end metric
    # from the device's trace profiles its whole window, up to the last
    # answer
    whole = not trace and any(m["source"] == "device_trace"
                              for m in cell.end_to_end)
    tracer = None
    if trace or whole:
        from portbench import tracing

        tracing.warm()
        tracer = tracing.Trace()
    marks.append(("profiler", time.perf_counter()))
    samples = [Sample(int(mix["sample_per_client"]),
                      traffic.sampler_rng(seed, c))
               for c in range(gen.clients)]
    gc.collect()
    t0, calls, traced, hung = drive(
        entry, gen, mix, seconds,
        mix.get("trace_seconds", seconds) if trace else None,
        samples, tracer)
    setup_s = t0 - started
    marks.append(("the window's opening", t0))
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    counters = entry.counters()
    entry.close()
    del entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the check: the sampled answers against the plain reference's
    pairs, costs = [], []
    for c, sample in enumerate(samples):
        for k, ops in gen.replay(c, sample.kept).items():
            want = reference.answer(config, ops)
            if trace and hasattr(reference, "work") and len(costs) < 2:
                costs.append(reference.work(config, ops, want))
            pairs.append((sample.kept[k], compared(reference, want)))
    failed = sum(not call.ok for call in calls) + hung
    correct, checks = judge.judge(pairs, failed, config["limits"])

    record = {
        "seconds": seconds, "setup_s": setup_s, "calls": calls,
        "counters": counters, "trace": tracer,
        "kernel_cost": {
            name: tuple(float(np.mean([c[name][i] for c in costs]))
                        for i in (0, 1))
            for name in (costs[0] if costs else {})
        },
        "quiet_from": traced[2] if traced else 0.0,
        "trace_whole": whole,
    }
    metrics = {}
    for kind, specs in (("end_to_end", cell.end_to_end),
                        ("layer_metrics", cell.per_layer)):
        if (kind == "end_to_end") == bool(trace):
            continue
        for spec in specs:
            reader = load_module(PKG / kind / f"{spec['name']}.py")
            value = reader.read(record)
            if value is not None:
                metrics[spec["name"]] = {"value": float(value),
                                         "unit": spec["unit"]}
    device_block = dict(platform, memory_peak_bytes=int(memory_peak))
    result = {"correct": bool(correct), "attempted": len(calls) + hung,
              "failed": failed, "metrics": metrics, "device": device_block}
    if trace:
        device_block["busy_s"] = tracer.busy_s()
        device_block["window_s"] = tracer.window_s
        result["breakdown"] = tracer.breakdown()
    result["checks"] = checks
    lines = ["set-up: " + ", ".join(
        f"{name} {b - a:.3f} s"
        for (_, a), (name, b) in zip(marks, marks[1:]))]
    lines.append(f"checked {len(pairs)} answers of {len(calls)} requests")
    lines += [f"check {name} {c['value']!r} limit {c['limit']!r}"
              for name, c in checks.items()]
    return Outcome(result, lines)

