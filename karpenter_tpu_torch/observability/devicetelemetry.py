"""Solver introspection plane: compile ledger, device memory telemetry,
and cost attribution (docs/observability.md "Device telemetry &
introspection").

The port's copy of karpenter_tpu/observability/devicetelemetry.py. Three
surfaces, as in the reference:

  * COMPILE LEDGER — every first-time event the SolverService pays for
    is recorded as one columnar-ring row: kernel family, rung, wall
    seconds, the trace ids that paid for it, and the cost attribution.
    Nothing is compiled per shape here, so a "compile" is one of:
      - the first dispatch of a family at a new dispatch key (the torch
        rung's shape bucket; the cuda rung's request shape), which pays
        lazy CUDA module loading and the caching allocator's growth;
      - a FusedTickProgram CUDA-graph capture (family "fused");
      - the one-time build or load of the CUDA kernels (kernels.py,
        family "kernels").
    Exported as `karpenter_solver_compile_seconds` (histogram,
    `name`=family). A COMPILE STORM — >= `storm_threshold` records
    inside one manager tick window AFTER the plane reached steady state
    (a tick with zero records) — records a `compile_storm`
    flight-recorder event (a trip-class kind), once per incident.
  * DEVICE MEMORY TELEMETRY — per tick, poll `torch.cuda.memory_stats`
    of the service's card (bytes allocated) against its
    `get_device_properties(...).total_memory` into
    `karpenter_device_{bytes_in_use,bytes_limit}` (`name`=device), plus
    exact byte accounting of the ResidentFleetState LRU as
    `karpenter_solver_resident_entry_bytes` (`name`=entry slot,
    `namespace`=tenant). A service on the CPU reports no memory stats
    (the reference's CPU backend reports none either), so the self-SLO
    memory source stays None there. A high-watermark breach
    (bytes_in_use/bytes_limit >= `watermark`) feeds the self-SLO
    monitor as its fourth source (`memory_source`).
  * COST ATTRIBUTION — the analytic bytes and operations of the two
    CUDA kernels behind a cuda-rung solve (ops/fused_assign.solve_cost,
    the count chip_smoke.py's bound uses), captured at the key's first
    dispatch, so every later dispatch span of that key carries
    flops/bytes args. Other families report (None, None), as the
    reference does where XLA has no cost analysis.

`/debug/solver` (observability/server.py) reports the solver posture in
ONE JSON document: dispatch keys per family + hit/miss counters + the
ledger tail, resident LRU contents, the shard route and its mesh
extents, backend FSM state, and queue/pipeline depths.

Posture: DEFAULT OFF behind `--introspect`. Disabled, the hot path pays
one attribute read per hook and nothing else.
"""

from __future__ import annotations

import collections
import threading
import time as _time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

SUBSYSTEM = "solver"
DEVICE_SUBSYSTEM = "device"

# metric names (module constants so the doc-drift lint's AST scan
# resolves them — tests/test_metrics.py TestMetricsDocDrift)
COMPILE_SECONDS = "compile_seconds"
COMPILE_STORMS = "compile_storms_total"
BYTES_IN_USE = "bytes_in_use"
BYTES_LIMIT = "bytes_limit"
RESIDENT_ENTRY_BYTES = "resident_entry_bytes"

# flight-recorder kind for a compile storm (a DUMP_KINDS member: the
# ring dumps crash-safely into --journal-dir when one lands)
STORM_EVENT = "compile_storm"

# record wall times run from milliseconds (a first dispatch, a graph
# capture) to a minute (nvcc building the kernels from source)
_COMPILE_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0, 60.0, 120.0,
)

# ledger columns, in tail()-render order
_COLUMNS = (
    "seq", "ts", "family", "rung", "extents", "seconds",
    "trace_ids", "flops", "bytes_accessed",
)


def extract_cost(analysis) -> Tuple[Optional[float], Optional[float]]:
    """(flops, bytes accessed) out of a cost-analysis result: a dict
    (or a one-element list of dicts, the reference's older form) with
    "flops" and "bytes accessed"; (None, None) when it holds neither."""
    if isinstance(analysis, (list, tuple)):
        analysis = analysis[0] if analysis else {}
    if not isinstance(analysis, dict):
        return None, None
    flops = analysis.get("flops")
    bytes_accessed = analysis.get("bytes accessed")
    return (
        float(flops) if flops is not None else None,
        float(bytes_accessed) if bytes_accessed is not None else None,
    )


class CompileLedger:
    """Bounded COLUMNAR ring of compile-cache misses (the provenance-
    ledger discipline: parallel per-column deques, O(columns) slice
    work per record, dicts materialized only at query time)."""

    def __init__(self, capacity: int = 256, clock=_time.time):
        self.capacity = capacity
        self._clock = clock
        self._lock = threading.Lock()
        self._cols: Dict[str, collections.deque] = {
            name: collections.deque(maxlen=capacity) for name in _COLUMNS
        }
        self._seq = 0
        self.records_total = 0
        # per-family miss counters ({} when nothing recorded)
        self.by_family: Dict[str, int] = {}

    def record(
        self,
        family: str,
        rung: str,
        seconds: float,
        extents: Optional[tuple] = None,
        trace_ids: Sequence[str] = (),
        flops: Optional[float] = None,
        bytes_accessed: Optional[float] = None,
    ) -> int:
        with self._lock:
            self._seq += 1
            row = {
                "seq": self._seq,
                "ts": self._clock(),
                "family": family,
                "rung": rung,
                "extents": tuple(extents) if extents else None,
                "seconds": round(float(seconds), 6),
                "trace_ids": list(trace_ids),
                "flops": flops,
                "bytes_accessed": bytes_accessed,
            }
            for name in _COLUMNS:
                self._cols[name].append(row[name])
            self.records_total += 1
            self.by_family[family] = self.by_family.get(family, 0) + 1
            return self._seq

    def tail(self, limit: Optional[int] = None) -> List[dict]:
        """Newest-last row dicts (the /debug/solver ledger tail)."""
        with self._lock:
            rows = [list(self._cols[name]) for name in _COLUMNS]
        records = [
            dict(zip(_COLUMNS, values)) for values in zip(*rows)
        ]
        if limit is not None and limit >= 0:
            records = records[-limit:] if limit else []
        return records


class SolverIntrospection:
    """The introspection plane one SolverService carries (module
    docstring). Seams are injectable so tests compose pieces freely:

      service        the SolverService to snapshot (attach() wires the
                     back-pointer so dispatch sites can note compiles)
      stats_source   () -> [{"device", "bytes_in_use", "bytes_limit"}]
                     (default: torch.cuda.memory_stats of the
                     service's card; none on the CPU)
      recorder       the flight recorder storm trips dump through
                     (default: the process default)

    DISABLED (the default) every entry point returns after one
    attribute read and records nothing — the mark-free off path the
    property pin holds to."""

    def __init__(
        self,
        service=None,
        enabled: bool = False,
        registry=None,
        clock=_time.time,
        recorder=None,
        stats_source: Optional[Callable[[], List[dict]]] = None,
        storm_threshold: int = 4,
        watermark: float = 0.9,
        ledger_capacity: int = 256,
    ):
        self.enabled = enabled
        self.service = service
        self._clock = clock
        self._recorder = recorder
        self._stats_source = stats_source
        # >= this many compile-cache misses inside ONE tick window,
        # after steady state, is a storm
        self.storm_threshold = storm_threshold
        # bytes_in_use/bytes_limit at or above this on ANY device is
        # the high-watermark trip the self-SLO memory source reports
        self.watermark = watermark
        self.ledger = CompileLedger(capacity=ledger_capacity, clock=clock)
        # (cache key) -> (flops, bytes) attribution captured at compile
        # time; bounded like the compile cache it mirrors
        self._cost_by_key: Dict[tuple, Tuple[float, float]] = {}
        self._cost_lock = threading.Lock()
        # storm detector: ARMED only after a zero-miss tick (a cold
        # boot's compile taper is not a storm; a mid-run cache reset
        # after steady state is), one trip per incident
        self._armed = False
        self._tripped = False
        self._misses_at_tick = 0
        self.storms_total = 0
        self.last_tick_misses = 0
        # device-memory high-watermark state (the self-SLO source)
        self.memory_high: Optional[bool] = None
        self._last_memory: List[dict] = []
        # resident-entry gauge series published last tick (retired when
        # the LRU churns them out — no frozen per-entry series)
        self._entry_series: set = set()
        self._h_compile = None
        self._c_storms = None
        self._g_bytes_in_use = None
        self._g_bytes_limit = None
        self._g_entry_bytes = None
        if registry is not None:
            self.bind_registry(registry)

    def bind_registry(self, registry) -> None:
        reg = registry.register
        self._h_compile = reg(
            SUBSYSTEM, COMPILE_SECONDS, kind="histogram",
            buckets=_COMPILE_BUCKETS,
        )
        self._c_storms = reg(SUBSYSTEM, COMPILE_STORMS, kind="counter")
        self._g_bytes_in_use = reg(DEVICE_SUBSYSTEM, BYTES_IN_USE)
        self._g_bytes_limit = reg(DEVICE_SUBSYSTEM, BYTES_LIMIT)
        self._g_entry_bytes = reg(SUBSYSTEM, RESIDENT_ENTRY_BYTES)

    def attach(self, service) -> "SolverIntrospection":
        """Wire the back-pointer both ways: the service's dispatch
        sites note compile misses here, and snapshot() reads the
        service's caches/FSM/queue."""
        self.service = service
        service.attach_introspection(self)
        return self

    def _recorder_or_default(self):
        if self._recorder is not None:
            return self._recorder
        from karpenter_tpu_torch.observability.flightrecorder import (
            default_flight_recorder,
        )

        return default_flight_recorder()

    # -- compile ledger (called from SolverService dispatch sites) ---------

    def note_compile(
        self,
        family: str,
        key: tuple,
        seconds: float,
        trace_ids: Sequence[str] = (),
        extents: Optional[tuple] = None,
        cost_fn: Optional[Callable[[], object]] = None,
    ) -> None:
        """Record one compile-cache miss: the wall time the first
        dispatch paid, the trace ids riding it, and — via `cost_fn`, a
        lazy thunk so disabled planes never pay for it — the cost
        analysis of the compiled program. Never raises into the
        dispatch path it observes."""
        if not self.enabled:
            return
        flops = bytes_accessed = None
        if cost_fn is not None:
            try:
                flops, bytes_accessed = extract_cost(cost_fn())
            except Exception:  # noqa: BLE001 — attribution is best-effort
                pass
            if flops is not None or bytes_accessed is not None:
                with self._cost_lock:
                    # bounded alongside the compile cache it mirrors
                    if len(self._cost_by_key) >= 512:
                        self._cost_by_key.clear()
                    self._cost_by_key[key] = (flops, bytes_accessed)
        from karpenter_tpu_torch.solver.bucketing import rung_label

        self.ledger.record(
            family=family,
            rung=rung_label(key),
            seconds=seconds,
            extents=extents,
            trace_ids=trace_ids,
            flops=flops,
            bytes_accessed=bytes_accessed,
        )
        if self._h_compile is not None:
            self._h_compile.observe(family, "-", float(seconds))

    def dispatch_cost_args(self, key: tuple) -> dict:
        """{flops, bytes} span args for a dispatch riding `key`, {}
        when disabled or unattributed — the off path adds nothing to
        any span (the byte-identical pin)."""
        if not self.enabled:
            return {}
        cost = self._cost_by_key.get(key)
        if cost is None:
            return {}
        flops, bytes_accessed = cost
        args = {}
        if flops is not None:
            args["flops"] = flops
        if bytes_accessed is not None:
            args["bytes"] = bytes_accessed
        return args

    # -- the per-tick evaluation (manager tick hook) -----------------------

    def on_tick(self) -> None:
        """One evaluation pass: close the tick's compile-miss window
        (storm detection) and poll the device-memory surfaces. Runs on
        the manager tick hook; disabled planes return immediately."""
        if not self.enabled:
            return
        self._evaluate_storm()
        self._poll_memory()
        self._publish_resident_entries()

    def _evaluate_storm(self) -> None:
        total = self.ledger.records_total
        misses = total - self._misses_at_tick
        self._misses_at_tick = total
        self.last_tick_misses = misses
        if misses == 0:
            # steady state: arm the detector (and re-arm after a trip)
            self._armed = True
            self._tripped = False
            return
        if (
            self._armed
            and not self._tripped
            and misses >= self.storm_threshold
        ):
            self._tripped = True
            self.storms_total += 1
            if self._c_storms is not None:
                self._c_storms.inc("-", "-")
            tail = self.ledger.tail(limit=misses)
            trace_ids = [
                tid for row in tail for tid in row["trace_ids"]
            ]
            families = sorted({row["family"] for row in tail})
            # trip-class kind: the recorder auto-dumps the ring into
            # --journal-dir with the storm's rows still in context
            self._recorder_or_default().record(
                STORM_EVENT,
                trace_ids=list(dict.fromkeys(trace_ids)),
                subsystem="solver",
                misses=misses,
                threshold=self.storm_threshold,
                families=families,
            )

    def _device_stats(self) -> List[dict]:
        """[{device, bytes_in_use, bytes_limit}] for the service's card
        (torch.cuda.memory_stats' allocated bytes against the card's
        total memory); [] for a service on the CPU, which reports no
        memory stats."""
        if self._stats_source is not None:
            return list(self._stats_source())
        device = getattr(self.service, "device", None)
        if device is None or getattr(device, "type", None) != "cuda":
            return []
        try:
            import torch

            mem = torch.cuda.memory_stats(device)
            in_use = mem.get("allocated_bytes.all.current")
            if in_use is None:
                return []
            limit = torch.cuda.get_device_properties(device).total_memory
            index = device.index if device.index is not None else 0
            return [{
                "device": f"cuda:{index}",
                "bytes_in_use": int(in_use),
                "bytes_limit": int(limit) if limit else None,
            }]
        except Exception:  # noqa: BLE001 — observation only
            return []

    def _poll_memory(self) -> None:
        stats = self._device_stats()
        self._last_memory = stats
        high: Optional[bool] = None
        for entry in stats:
            if self._g_bytes_in_use is not None:
                self._g_bytes_in_use.set(
                    entry["device"], "-", float(entry["bytes_in_use"])
                )
            limit = entry.get("bytes_limit")
            if limit:
                if self._g_bytes_limit is not None:
                    self._g_bytes_limit.set(
                        entry["device"], "-", float(limit)
                    )
                breached = (
                    entry["bytes_in_use"] / limit >= self.watermark
                )
                high = breached if high is None else (high or breached)
        self.memory_high = high

    def _publish_resident_entries(self) -> None:
        """Exact per-entry byte accounting of the resident LRU:
        one series per live entry (`name`=slot, `namespace`=tenant),
        entries evicted since last tick RETIRED (no frozen series —
        the gauge-retirement discipline of every per-object family)."""
        if self._g_entry_bytes is None or self.service is None:
            return
        entries = self._resident_entries()
        current = set()
        for entry in entries:
            series = (entry["slot"], entry["tenant"] or "-")
            current.add(series)
            self._g_entry_bytes.set(
                series[0], series[1], float(entry["bytes"])
            )
        for stale in self._entry_series - current:
            self._g_entry_bytes.remove(*stale)
        self._entry_series = current

    def _resident_entries(self) -> List[dict]:
        resident = getattr(self.service, "_resident", None)
        if resident is None:
            return []
        try:
            # ages must be computed on the SAME clock that stamped
            # created_at — the owning service's, not the plane's (the
            # runtime wires them differently: scripted vs monotonic)
            clock = getattr(self.service, "_clock", self._clock)
            return resident.entries(now=clock())
        except Exception:  # noqa: BLE001 — observation only
            return []

    # -- the self-SLO memory source ----------------------------------------

    def memory_source(self) -> Optional[bool]:
        """The self-SLO monitor's fourth source (selfslo.memory_source
        contract): True = high-watermark breached this tick (bad
        event), False = telemetry healthy (good event), None = no
        telemetry (disabled plane, or a backend with no memory stats)
        — quiet, no event either way."""
        if not self.enabled:
            return None
        return self.memory_high

    # -- /debug/solver ----------------------------------------------------

    def snapshot(self, ledger_limit: int = 32) -> dict:
        """The full solver posture as one JSON-ready document. A
        DISABLED plane reports only {"enabled": false} — --introspect
        is the opt-in for the whole surface (compile rungs, per-tenant
        resident entries, queue internals), not just the ledger."""
        if not self.enabled:
            return {"enabled": False}
        doc: dict = {
            "enabled": self.enabled,
            "compile": {
                "records_total": self.ledger.records_total,
                "by_family": dict(self.ledger.by_family),
                "storms_total": self.storms_total,
                "storm_threshold": self.storm_threshold,
                "storm_armed": self._armed,
                "last_tick_misses": self.last_tick_misses,
                "ledger_tail": self.ledger.tail(limit=ledger_limit),
            },
            "device_memory": {
                "devices": self._last_memory,
                "watermark": self.watermark,
                "high": self.memory_high,
            },
        }
        service = self.service
        if service is None:
            return doc
        from karpenter_tpu_torch.solver.bucketing import rung_label

        with service._cond:
            seen = list(service._compile_seen)
            queue_depth = len(service._queue)
            inflight = len(service._inflight)
        rungs: Dict[str, List[str]] = {}
        for key in seen:
            family = (
                key[0] if key and key[0] in ("forecast", "preempt", "fused")
                else "solve"
            )
            rungs.setdefault(family, []).append(rung_label(key))
        for family in rungs:
            rungs[family].sort()
        stats = service.stats
        doc["compile"]["cache"] = {
            "rungs": rungs,
            "hits": stats.compile_cache_hits,
            "misses": stats.compile_cache_misses,
        }
        doc["resident"] = {
            "bytes": service._resident.resident_bytes(),
            "rows": service._resident.resident_rows(),
            "entries": self._resident_entries(),
            "hits": stats.resident_hits,
            "scatters": stats.resident_scatters,
            "rebuilds": stats.resident_rebuilds,
            "drops": stats.resident_drops,
        }
        mesh = service._mesh
        doc["shard"] = {
            "threshold": service.shard_threshold,
            "broken": service._shard_broken,
            "devices": mesh.size if mesh is not None else 0,
            "extents": (
                tuple(int(x) for x in mesh.devices.shape)
                if mesh is not None else None
            ),
            "requests": stats.shard_requests,
            "dispatches": stats.shard_dispatches,
            "fallbacks": stats.shard_fallbacks,
        }
        doc["backend"] = {
            "state": service.backend_health(),
            "device_failures": stats.device_failures,
            "fsm_trips": stats.fsm_trips,
            "fsm_recoveries": stats.fsm_recoveries,
            "watchdog_restarts": stats.watchdog_restarts,
        }
        doc["queue"] = {
            "depth": queue_depth,
            "inflight": inflight,
            "max_queue": service.max_queue,
            "pipeline_depth": service.pipeline_depth,
            "window_ms": service._window_now_s * 1e3,
            "requests": stats.requests,
            "dispatches": stats.dispatches,
            "fallbacks": stats.fallbacks,
        }
        return doc
