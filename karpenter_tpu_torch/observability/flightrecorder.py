"""Flight recorder: bounded structured event ring with crash-safe dumps.

Counters say HOW OFTEN the degradation ladder fired; they cannot say
WHICH requests a trip degraded or what preceded it. The flight recorder
keeps the last N structured events — fault injections, solver FSM trips,
actuation circuit opens, fence rejections, shard fallbacks, watchdog
restarts, journal compactions — each stamped with wall time, a sequence
number, and TRACE-ID BACKLINKS into the span ring
(observability.tracing), so a post-mortem reads "trip #3 degraded traces
t00000a1/t00000a4" instead of "fsm_trips_total went from 2 to 3".

Dump discipline: trip-class events (`DUMP_KINDS`) dump the whole ring
into `dump_dir` (the runtime wires `--journal-dir`) crash-safely — tmp
file + atomic rename, same idiom as the recovery checkpoint — keeping
the newest `keep_dumps` files, so the dump that explains a crash loop
survives the crash loop. `/debug/flightrecorder` serves the live ring.

The port's copy of karpenter_tpu/observability/flightrecorder.py;
dumps write through the port's recovery/journal.py.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time as _time
from typing import List, Optional, Sequence

SUBSYSTEM = "flightrecorder"

DUMP_PREFIX = "flightrecorder-"

# event kinds that snapshot the ring to disk when they land: each marks
# a degradation an operator will want the surrounding context for
# (selfslo_burn: the self-SLO monitor's fast-burn trip —
# observability/selfslo.py — whose whole point is arriving WITH the
# ring of events that burned the budget; compile_storm: the solver
# introspection plane's steady-state compile-miss burst —
# observability/devicetelemetry.py — the dump carries the ledger's
# trace backlinks to the ticks that paid the compiles)
DUMP_KINDS = frozenset((
    "fsm_trip", "circuit_open", "fence_rejection", "watchdog_restart",
    "selfslo_burn", "compile_storm",
))


class FlightRecorder:
    def __init__(
        self,
        capacity: int = 1024,
        clock=_time.time,
        dump_dir: Optional[str] = None,
        keep_dumps: int = 8,
        dump_cooldown_s: float = 30.0,
    ):
        self.capacity = capacity
        self._clock = clock
        self.dump_dir = dump_dir
        self.keep_dumps = keep_dumps
        # auto-dumps run synchronously on the recording (reconcile)
        # thread: without a per-kind cooldown, a fleet-wide incident
        # (N circuit opens in one tick) would pay N fsync pairs AND
        # prune away the incident-origin dumps in favor of the newest
        self.dump_cooldown_s = dump_cooldown_s
        self._last_auto_dump: dict = {}
        self._events: collections.deque = collections.deque(
            maxlen=capacity
        )
        self._lock = threading.Lock()
        self._seq = 0
        self.dumps_written = 0
        self._c_events = self._c_dumps = None

    def configure(
        self,
        dump_dir: Optional[str] = None,
        keep_dumps: Optional[int] = None,
        dump_cooldown_s: Optional[float] = None,
    ) -> None:
        """Late wiring (the runtime knows --journal-dir, the module
        global is built first)."""
        if dump_dir is not None:
            self.dump_dir = dump_dir
        if keep_dumps is not None:
            self.keep_dumps = keep_dumps
        if dump_cooldown_s is not None:
            self.dump_cooldown_s = dump_cooldown_s

    def bind_registry(self, registry) -> None:
        """karpenter_flightrecorder_{events,dumps}_total{name=<kind>}."""
        self._c_events = registry.register(
            SUBSYSTEM, "events_total", kind="counter"
        )
        self._c_dumps = registry.register(
            SUBSYSTEM, "dumps_total", kind="counter"
        )

    # -- recording ---------------------------------------------------------

    def record(
        self, kind: str, trace_ids: Sequence[str] = (),
        auto_dump: bool = True, **fields
    ) -> dict:
        """Append one structured event. `trace_ids` backlinks the event
        to the reconcile traces it concerns; when omitted, the
        recording thread's CURRENT trace (if any) is captured — an
        event fired inside a tick is automatically attributed to it."""
        if not trace_ids:
            from karpenter_tpu_torch.observability.tracing import default_tracer

            current = default_tracer().current_trace_id()
            trace_ids = (current,) if current else ()
        with self._lock:
            self._seq += 1
            event = {
                "seq": self._seq,
                "kind": kind,
                "ts": self._clock(),
                "trace_ids": [t for t in trace_ids if t],
                **fields,
            }
            self._events.append(event)
        if self._c_events is not None:
            self._c_events.inc(kind, "-")
        if auto_dump:
            self.maybe_auto_dump(kind)
        return event

    def maybe_auto_dump(self, kind: str) -> Optional[str]:
        """Cooldown-respecting ring snapshot for a trip-class kind.
        Callers recording two causally-linked trip events for ONE
        incident (watchdog restart that also trips the FSM) pass
        `auto_dump=False` on the first record and invoke this only if
        the second never fires, so an incident writes one dump — not
        two near-identical fsync'd files eating two retention slots."""
        if kind not in DUMP_KINDS or not self.dump_dir:
            return None
        now = self._clock()
        last = self._last_auto_dump.get(kind)
        if last is not None and now - last < self.dump_cooldown_s:
            return None
        self._last_auto_dump[kind] = now
        return self.dump(reason=kind)

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            events = list(self._events)
        if kind is not None:
            events = [e for e in events if e["kind"] == kind]
        return events

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # -- dumping -----------------------------------------------------------

    def dump(
        self, path: Optional[str] = None, reason: str = "manual"
    ) -> Optional[str]:
        """Write the ring as one JSON document, crash-safely (tmp +
        atomic rename). Default path: dump_dir/flightrecorder-<seq>-
        <reason>.json, pruning past keep_dumps. Returns the path, or
        None when there is nowhere to write (no dump_dir and no path) —
        recording must never raise into the degradation path it
        records."""
        if path is None:
            if not self.dump_dir:
                return None
            with self._lock:
                seq = self._seq
            path = os.path.join(
                self.dump_dir,
                f"{DUMP_PREFIX}{seq:06d}-{reason}.json",
            )
        doc = {
            "dumped_at": self._clock(),
            "reason": reason,
            "events": self.events(),
        }
        # the recovery journal's durability sequence (tmp + fsync +
        # rename + dir fsync): a rename-durable-but-data-torn dump
        # would defeat "the dump that explains a crash loop survives
        # the crash loop"
        from karpenter_tpu_torch.recovery.journal import atomic_write

        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            atomic_write(path, json.dumps(doc, sort_keys=True))
        except OSError:
            return None
        self.dumps_written += 1
        if self._c_dumps is not None:
            self._c_dumps.inc(reason, "-")
        self._prune_dumps(os.path.dirname(path))
        return path

    def _prune_dumps(self, directory: str) -> None:
        try:
            dumps = sorted(
                name for name in os.listdir(directory or ".")
                if name.startswith(DUMP_PREFIX)
                and name.endswith(".json")
            )
            # keep_dumps <= 0 keeps NOTHING (dumps[:-0] would silently
            # invert the bound and keep everything)
            stales = (
                dumps if self.keep_dumps <= 0
                else dumps[:-self.keep_dumps]
            )
            for stale in stales:
                os.unlink(os.path.join(directory, stale))
        except OSError:
            pass  # pruning is best-effort


# -- process default ----------------------------------------------------------

_default = FlightRecorder()


def default_flight_recorder() -> FlightRecorder:
    return _default


def set_default_flight_recorder(recorder: FlightRecorder) -> FlightRecorder:
    global _default
    _default = recorder
    return recorder


def reset_default_flight_recorder() -> FlightRecorder:
    """Swap in a fresh default recorder (test isolation)."""
    return set_default_flight_recorder(FlightRecorder())
