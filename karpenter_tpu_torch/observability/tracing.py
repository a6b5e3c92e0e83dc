"""Reconcile tracing: per-reconcile trace IDs, spans, Chrome-trace export.

The control plane is eight subsystems deep (solver, consolidation,
faults, forecast, preemption, recovery, sharding) but until this layer
the only correlation between them was log interleaving: when 8 coalesced
requests ride one sharded dispatch and a circuit opens two ticks later,
nothing connects the watch event to the dispatch to the actuation. This
module is the correlation layer:

  * TRACE IDS are minted at the reconcile entry points (the manager
    tick, the simulate replays) by `Tracer.trace(...)`; everything that
    runs inside — producer encodes, the HA fleet decide, solver
    requests, SNG actuation — opens child spans that inherit the trace
    ID through a thread-local span stack, so in-tick code needs no
    plumbing.
  * CROSS-THREAD WORK (the solver worker) cannot use the stack: a
    request captures the submitter's span with `begin()` (explicitly
    parented, no TLS), and the worker's coalesced dispatch span LINKS
    the N request spans that rode it — the one-to-many join the
    coalescing queue otherwise erases. Pipeline-split chunks and
    sharded dispatches carry the same links.
  * EXPORT is Chrome-trace/Perfetto JSONL (`export_jsonl`): one event
    object per line — complete ("X") events for spans, flow ("s"/"f")
    events for dispatch links. `/debug/traces` (observability.server)
    serves the same spans as JSON for a live process.
  * ONE SPAN SYSTEM WITH THE PROFILER: a span opened with `with` (span,
    trace) also opens a torch.profiler `record_function` range of the
    same name on the same thread while a torch profiler is recording
    (observability.profiler's probe-once, guarded range), so a capture
    (`/debug/profile`, `--profiler-port`) names its kernels and idle
    gaps by the spans. With no profiler recording, a span makes one
    flag read and no range. `Tracer.range` opens the range alone, for a
    step a capture must name and no trace reads. Spans are stamped on the profiler's clock:
    a span starts at `time.time_ns()` (the unix clock that torch's
    record_function events carry) and lasts what the monotonic
    `perf_counter_ns` measures. The export writes the real pid, the
    OS thread id (`threading.get_native_id()`, the tid kineto writes)
    and `ts` in microseconds after kineto's Chrome-trace base
    (`CHROME_BASE_NS`: the unix time floored to 7,889,238-second
    periods, the `baseTimeNanoseconds` a capture's JSON declares). So
    a `--trace-export` file and a capture of the same process overlay
    in Perfetto: load both, and each span lies over its range.
    `/debug/traces` gives the base as `base_time_ns`. A cross-thread
    span (`begin`/`close`) stays in the ring only: a range cannot open
    on one thread and close on another.
  * END-TO-END LEAD TIME: the BLITZSCALE observable is
    event-observed -> actuation-acked, not solve latency. The tracer
    keeps per-object observation marks (`mark_observed` at watch/tick
    entry, `ack_observed` when the provider write returns) and
    publishes the distance as the `karpenter_reconcile_e2e_seconds`
    histogram (metrics/registry.py native histograms).

Overhead posture: the span ring is a bounded deque; a disabled tracer
(`enabled = False`) returns a shared no-op context manager (the bare
profiler range while a profiler records, so captures keep their names)
and None handles — the hot path pays two attribute reads. `make bench-trace`
publishes the enabled-vs-disabled tick overhead (<5% target,
docs/BENCHMARKS.md); tests/test_observability.py pins a regression
ceiling.

The port's copy of karpenter_tpu/observability/tracing.py; the
crash-safe export writes through the port's recovery/journal.py.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import torch.autograd.profiler as _autograd_profiler

SUBSYSTEM = "trace"

# karpenter_reconcile_e2e_seconds ladder: watch-event -> actuation-ack
# spans sub-ms (in-process store, fake provider) through the tens of
# seconds a real cloud resize takes
E2E_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


# kineto writes a Chrome trace's `ts` in microseconds after this base (its
# ChromeTraceBaseTime: the unix time floored to 7,889,238-second periods,
# fixed once per process), and declares it as `baseTimeNanoseconds`
_CHROME_PERIOD_S = 7_889_238
CHROME_BASE_NS = (
    int(_time.time()) // _CHROME_PERIOD_S * _CHROME_PERIOD_S * 1_000_000_000
)


def profiling() -> bool:
    """Whether a torch profiler is recording in this process: the flag
    torch.autograd.profiler sets for the length of every profiler window
    (torch.profiler.profile included), read without a call."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def _open_range(name: str):
    """An entered record_function range named `name` (profiler.py's
    guarded range: it never raises on set-up or teardown)."""
    from karpenter_tpu_torch.observability.profiler import solver_trace

    annotation = solver_trace(name)
    annotation.__enter__()
    return annotation


class _NoopSpan:
    """Shared allocation-free no-op context manager: the disabled
    tracer's span AND (via observability.profiler) the profiler-less
    solver_trace — one class so the two no-op paths cannot diverge."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class OpenSpan:
    """A span in progress. Context-manager use (`with tracer.span(...)`)
    threads the TLS stack; `begin()`/`close()` use skips it (cross-thread
    spans must not corrupt another thread's stack)."""

    __slots__ = (
        "_tracer", "name", "trace_id", "span_id", "parent_id",
        "t0", "t0_ns", "args", "links", "_on_stack", "_closed", "_range",
    )

    def __init__(self, tracer, name, trace_id, span_id, parent_id,
                 args, links, on_stack):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.args = args
        self.links = links
        self._on_stack = on_stack
        self._closed = False
        self._range = None
        self._stamp()

    def _stamp(self) -> None:
        # the start on the profiler's (unix) clock; the duration on the
        # monotonic one
        self.t0 = _time.perf_counter_ns()
        self.t0_ns = _time.time_ns()

    def ref(self) -> Tuple[str, str]:
        return (self.trace_id, self.span_id)

    def close(self, **extra) -> None:
        """Finish the span (idempotent — the solver's first-finisher-wins
        request completion may race a stale worker)."""
        if self._closed:
            return
        self._closed = True
        if extra:
            self.args.update(extra)
        self._tracer._finish(self)

    def __enter__(self) -> "OpenSpan":
        if self._on_stack:
            self._tracer._stack().append(self)
            if profiling():
                # the range opens first and the span starts inside it,
                # so a capture shows the span within its range
                self._range = _open_range(self.name)
                self._stamp()
        return self

    def __exit__(self, *exc) -> bool:
        if self._on_stack:
            stack = self._tracer._stack()
            if stack and stack[-1] is self:
                stack.pop()
        if exc and exc[0] is not None:
            self.close(error=exc[0].__name__)
        else:
            self.close()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return False


class Tracer:
    """Bounded in-memory span collector (module docstring)."""

    def __init__(self, capacity: int = 8192, clock=_time.perf_counter):
        self.enabled = True
        self.capacity = capacity
        # the e2e lead-time marks' clock; spans run on the profiler's
        # (module docstring)
        self._clock = clock
        self._lock = threading.Lock()
        # itertools.count is atomic under the GIL: span-id minting needs
        # no lock on the hot path
        self._seq = itertools.count(1)
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._tls = threading.local()
        self.spans_total = 0
        self.spans_dropped = 0
        # e2e lead-time marks: (kind, namespace, name) -> observed ts
        self._observed: Dict[tuple, float] = {}
        self.e2e_observed = 0
        self._c_spans = self._c_dropped = self._h_e2e = None

    # -- wiring ------------------------------------------------------------

    def bind_registry(self, registry) -> None:
        """Publish the tracer's own counters and the e2e histogram into
        a runtime's GaugeRegistry (karpenter_trace_*,
        karpenter_reconcile_e2e_seconds). The counters sync when a ROOT
        span closes (once per tick) rather than per span — per-span vec
        locking is measurable at the tick rate, and a scrape only needs
        counter freshness at tick granularity."""
        self._c_spans = registry.register(
            SUBSYSTEM, "spans_total", kind="counter"
        )
        self._c_dropped = registry.register(
            SUBSYSTEM, "spans_dropped_total", kind="counter"
        )
        self._h_e2e = registry.register(
            "reconcile", "e2e_seconds", kind="histogram",
            buckets=E2E_BUCKETS,
        )

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _native_id(self) -> int:
        # the OS thread id, read once a thread (a system call each time)
        tid = getattr(self._tls, "tid", None)
        if tid is None:
            tid = self._tls.tid = threading.get_native_id()
        return tid

    def current(self) -> Optional[OpenSpan]:
        """The innermost span open on THIS thread (None outside any)."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def current_trace_id(self) -> Optional[str]:
        span = self.current()
        return span.trace_id if span is not None else None

    def _mint(self) -> int:
        return next(self._seq)

    @staticmethod
    def _resolve_parent(parent) -> Optional[Tuple[str, str]]:
        if parent is None:
            return None
        if isinstance(parent, OpenSpan):
            return parent.ref()
        trace_id, span_id = parent  # (trace_id, span_id) tuple
        return (trace_id, span_id)

    def _open(self, name, parent, new_trace, links, args, on_stack):
        seq = self._mint()
        span_id = f"s{seq:08x}"
        ref = self._resolve_parent(parent)
        if new_trace or ref is None:
            trace_id, parent_id = f"t{seq:08x}", None
        else:
            trace_id, parent_id = ref
        link_refs = [
            self._resolve_parent(link) for link in links
            if link is not None
        ] if links else []
        # args is the caller's fresh **kwargs dict — owned, no copy
        return OpenSpan(
            self, name, trace_id, span_id, parent_id,
            args, link_refs, on_stack,
        )

    # -- span API ----------------------------------------------------------

    def trace(self, name: str, **args):
        """Mint a NEW trace id and open its root span (the watch/tick
        entry points call this)."""
        if not self.enabled:
            return _profiler_range(name)
        return self._open(name, None, True, (), args, on_stack=True)

    def span(self, name: str, parent=None, links: Sequence = (), **args):
        """Open a child span: of `parent` when given (an OpenSpan or a
        (trace_id, span_id) ref), else of this thread's current span;
        with neither, a fresh trace (orphan work is still captured).
        `links` joins other spans' refs — the coalesced-dispatch
        one-to-many edge."""
        if not self.enabled:
            return _profiler_range(name)
        if parent is None:
            parent = self.current()
        return self._open(
            name, parent, False, links, args, on_stack=True
        )

    def range(self, name: str):
        """A profiler range alone, never in the ring: for a step that a
        capture must name and no trace reads (the solve worker's turn of
        its loop, around its spans). Open with `with`."""
        return _profiler_range(name)

    def begin(self, name: str, parent=None, **args) -> Optional[OpenSpan]:
        """Open a span WITHOUT touching the TLS stack — for spans closed
        on another thread (solver requests). Close with `.close()`."""
        if not self.enabled:
            return None
        if parent is None:
            parent = self.current()
        return self._open(
            name, parent, False, (), args, on_stack=False
        )

    def _finish(self, span: OpenSpan) -> None:
        now = _time.perf_counter_ns()
        args = span.args
        if args:
            args = {k: v for k, v in args.items() if v is not None}
        record = {
            "name": span.name,
            "trace": span.trace_id,
            "id": span.span_id,
            "parent": span.parent_id,
            "ts_us": (span.t0_ns - CHROME_BASE_NS) / 1e3,
            "dur_us": max(0, now - span.t0) / 1e3,
            "tid": self._native_id(),
            "args": args,
            "links": [sid for (_tid, sid) in span.links],
        }
        with self._lock:
            dropped = len(self._spans) >= self.capacity
            self._spans.append(record)
            self.spans_total += 1
            if dropped:
                self.spans_dropped += 1
        # counters sync on ROOT closes (bind_registry docstring): a
        # monotone set() at tick granularity instead of a vec-locked
        # inc() per span
        if span.parent_id is None and self._c_spans is not None:
            self._c_spans.set("-", "-", float(self.spans_total))
            self._c_dropped.set("-", "-", float(self.spans_dropped))

    # -- e2e lead time (BLITZSCALE observable) -----------------------------

    def mark_observed(self, key: tuple, overwrite: bool = True) -> None:
        """Stamp WHEN work for an object was observed. The engine passes
        overwrite=False everywhere (watch events AND tick entries):
        marks are retired on ack/convergence, so the earliest stamp
        since retirement is the observation of the CURRENT divergence —
        overwriting would let the engine's own status-patch
        notifications re-stamp a pending mark every tick and
        under-report multi-tick actuations. Disabled tracer: no-op
        (the marks are O(objects)/tick on the reconcile hot path, and
        the e2e histogram is trace-derived telemetry)."""
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            if overwrite or key not in self._observed:
                self._observed[key] = now

    def drop_observed(self, key: tuple) -> None:
        """Retire a mark without an actuation: the object converged (or
        was deleted) — a stale stamp must not inflate a later ack.
        Runs even when disabled (clears marks left by a mid-flight
        toggle), but skips the lock when there is nothing to drop."""
        if not self._observed:
            return  # racy read is fine: empty means nothing to drop
        with self._lock:
            self._observed.pop(key, None)

    def ack_observed(self, key: tuple) -> Optional[float]:
        """Actuation acked for `key`: observe event->ack lead time into
        karpenter_reconcile_e2e_seconds and return it (None without a
        mark)."""
        if not self._observed:
            return None
        now = self._clock()
        with self._lock:
            t0 = self._observed.pop(key, None)
        if t0 is None:
            return None
        lead = max(0.0, now - t0)
        self.e2e_observed += 1
        if self._h_e2e is not None:
            self._h_e2e.observe(key[0], "-", lead)
        return lead

    # -- export ------------------------------------------------------------

    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        """Most-recent-last copy of the finished-span ring."""
        with self._lock:
            spans = list(self._spans)
        if limit is not None and limit >= 0:
            # limit=0 means NONE (spans[-0:] would be the whole ring)
            spans = spans[-limit:] if limit else []
        return spans

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def chrome_events(self) -> List[dict]:
        """Chrome-trace event objects: one complete ("X") event per
        span, plus flow ("s"/"f") event pairs rendering dispatch links
        as arrows in Perfetto; pid, tid and ts as a torch profiler
        capture of this process writes them (module docstring)."""
        events: List[dict] = []
        pid = os.getpid()
        spans = self.snapshot()
        by_id = {span["id"]: span for span in spans}
        for span in spans:
            args = dict(span["args"])
            args["trace_id"] = span["trace"]
            if span["parent"]:
                args["parent_id"] = span["parent"]
            if span["links"]:
                args["links"] = list(span["links"])
            events.append({
                "ph": "X",
                "name": span["name"],
                "cat": span["trace"],
                "pid": pid,
                "tid": span["tid"],
                "ts": round(span["ts_us"], 3),
                "dur": round(span["dur_us"], 3),
                "id": span["id"],
                "args": args,
            })
            for linked_id in span["links"]:
                linked = by_id.get(linked_id)
                if linked is None:
                    continue  # the linked span aged out of the ring
                # flow ids are PER EDGE (src>dst): two dispatches
                # linking the same request (the sharded->single-device
                # retry) would otherwise emit duplicate begin events
                # under one id — malformed per the Chrome trace format,
                # and Perfetto misdraws exactly the degraded dispatches
                edge = f"{linked_id}>{span['id']}"
                events.append({
                    "ph": "s", "name": "link", "cat": "link",
                    "id": edge, "pid": pid, "tid": linked["tid"],
                    "ts": round(linked["ts_us"], 3),
                })
                events.append({
                    "ph": "f", "bp": "e", "name": "link", "cat": "link",
                    "id": edge, "pid": pid, "tid": span["tid"],
                    "ts": round(span["ts_us"], 3),
                })
        return events

    def export_jsonl(self, path: str) -> int:
        """Write the Chrome-trace events as JSONL (one event object per
        line), crash-safely (the recovery journal's tmp + fsync +
        rename sequence). Returns the event count."""
        from karpenter_tpu_torch.recovery.journal import atomic_write

        events = self.chrome_events()
        atomic_write(
            path,
            "".join(
                json.dumps(event, sort_keys=True) + "\n"
                for event in events
            ),
        )
        return len(events)


def _profiler_range(name: str):
    """The bare profiler range while a torch profiler records, else the
    shared no-op: `Tracer.range`, and a disabled tracer's span, so
    captures keep their names."""
    if profiling():
        from karpenter_tpu_torch.observability.profiler import solver_trace

        return solver_trace(name)
    return _NOOP_SPAN


# -- process default ----------------------------------------------------------
# One tracer per process, like faults._active: instrumentation sites read
# it through default_tracer() so trace context crosses module boundaries
# (manager -> producers -> solver -> controller) with no parameter
# threading; the runtime binds its registry to it at boot.

_default = Tracer()


def default_tracer() -> Tracer:
    return _default


def set_default_tracer(tracer: Tracer) -> Tracer:
    global _default
    _default = tracer
    return tracer


def reset_default_tracer() -> Tracer:
    """Swap in a fresh default tracer (test isolation)."""
    return set_default_tracer(Tracer())
