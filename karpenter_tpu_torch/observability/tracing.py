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
    events for dispatch links — loadable in Perfetto/chrome://tracing
    next to an xprof device timeline captured over the same wall
    clock. `/debug/traces` (observability.server) serves the same
    spans as JSON for a live process.
  * END-TO-END LEAD TIME: the BLITZSCALE observable is
    event-observed -> actuation-acked, not solve latency. The tracer
    keeps per-object observation marks (`mark_observed` at watch/tick
    entry, `ack_observed` when the provider write returns) and
    publishes the distance as the `karpenter_reconcile_e2e_seconds`
    histogram (metrics/registry.py native histograms).

Overhead posture: the span ring is a bounded deque; a disabled tracer
(`enabled = False`) returns a shared no-op context manager and None
handles — the hot path pays one attribute read. `make bench-trace`
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
import threading
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

SUBSYSTEM = "trace"

# karpenter_reconcile_e2e_seconds ladder: watch-event -> actuation-ack
# spans sub-ms (in-process store, fake provider) through the tens of
# seconds a real cloud resize takes
E2E_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


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
        "t0", "args", "links", "_on_stack", "_closed",
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
        self.t0 = tracer._clock()

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
        return False


class Tracer:
    """Bounded in-memory span collector (module docstring)."""

    def __init__(self, capacity: int = 8192, clock=_time.perf_counter):
        self.enabled = True
        self.capacity = capacity
        self._clock = clock
        self._epoch = clock()
        # wall-clock anchor of the epoch, so exported ts_us correlate
        # with xprof's wall-clock device timelines
        self.epoch_unix = _time.time()
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
            return _NOOP_SPAN
        return self._open(name, None, True, (), args, on_stack=True)

    def span(self, name: str, parent=None, links: Sequence = (), **args):
        """Open a child span: of `parent` when given (an OpenSpan or a
        (trace_id, span_id) ref), else of this thread's current span;
        with neither, a fresh trace (orphan work is still captured).
        `links` joins other spans' refs — the coalesced-dispatch
        one-to-many edge."""
        if not self.enabled:
            return _NOOP_SPAN
        if parent is None:
            parent = self.current()
        return self._open(
            name, parent, False, links, args, on_stack=True
        )

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
        now = self._clock()
        args = span.args
        if args:
            args = {k: v for k, v in args.items() if v is not None}
        record = {
            "name": span.name,
            "trace": span.trace_id,
            "id": span.span_id,
            "parent": span.parent_id,
            "ts_us": (span.t0 - self._epoch) * 1e6,
            "dur_us": max(0.0, (now - span.t0) * 1e6),
            "tid": threading.get_ident() & 0xFFFF,
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
        as arrows in Perfetto."""
        events: List[dict] = []
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
                "pid": 1,
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
                    "id": edge, "pid": 1, "tid": linked["tid"],
                    "ts": round(linked["ts_us"], 3),
                })
                events.append({
                    "ph": "f", "bp": "e", "name": "link", "cat": "link",
                    "id": edge, "pid": 1, "tid": span["tid"],
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
