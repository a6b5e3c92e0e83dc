"""Observability HTTP surface: /metrics, health, and the debug endpoints
(the port's copy of karpenter_tpu/observability/server.py; /debug/profile
captures with torch.profiler, and /debug/solver renders the runtime's
introspection plane, observability/devicetelemetry.py).

reference: the manager serves controller metrics on :8080
(cmd/controller/main.go:52,61) scraped by a dedicated Prometheus via a 5s
ServiceMonitor (config/prometheus/monitor.yaml:10-14); health/readiness
come from the manager. Here the same server additionally serves:

  /healthz               liveness ONLY: the process is up and serving —
                         always "ok" (a degraded-but-supervising control
                         plane must NOT be restarted by its liveness
                         probe; degradation is what /readyz reports)
  /readyz                readiness wired to REAL state via the
                         `readiness` callable: 503 during recovery
                         warm-up ticks and while the solver backend
                         health FSM is tripped (__main__.py wires it)
  /metrics               Prometheus text exposition (gauges, counters,
                         and native histograms — metrics/registry.py)
  /debug/traces          recent reconcile spans as JSON (?limit=N;
                         ?tenant=ID keeps the traces that touched that
                         tenant), same records `--trace-export` writes
                         as Chrome-trace JSONL (observability.tracing)
  /debug/flightrecorder  the flight-recorder event ring as JSON
                         (?kind=fsm_trip and ?tenant=ID filter)
  /debug/decisions       the decision provenance ledger as JSON
                         (?kind=&tenant=&group=&name=&limit= filter) —
                         observability.provenance, --provenance to
                         enable recording
  /debug/selfslo         the self-SLO scoreboard: per-window burn
                         rates/budget + solver FSM + per-tenant breaker
                         degradation (observability.selfslo)
  /debug/replicas        the replicated-control-plane scoreboard: this
                         replica's identity, the live-replica set,
                         per-partition lease holders, and per-tenant
                         handoff state (replication/plane.py;
                         enabled: false without --partitions)
  /debug/solver          the full solver posture as ONE JSON document:
                         compile-cache rungs + hit/miss + the compile
                         ledger tail, resident LRU contents, shard
                         route + extents, backend FSM, queue/pipeline
                         depths (observability.devicetelemetry,
                         --introspect; ?limit=N bounds the ledger tail)
  /debug/profile?ms=N    one bounded single-flight torch.profiler capture
                         (a Chrome trace) written atomically into --journal-dir next to
                         the flight-recorder dumps, stamped with the
                         active trace id; 503 when the profiler probe
                         failed, a capture is in flight, or no
                         --journal-dir is configured
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.observability.tracing import CHROME_BASE_NS

# readiness callable contract: () -> (ready, reason)
ReadinessCheck = Callable[[], Tuple[bool, str]]


def _parse_limit(query: dict) -> Optional[int]:
    """?limit=N as an int, None when absent or malformed (a broken
    limit serves everything rather than erroring a debug page)."""
    try:
        if "limit" in query:
            return int(query["limit"][0])
    except (ValueError, IndexError):
        pass
    return None


class MetricsServer:
    """Serves the gauge registry in Prometheus text exposition format
    plus the health/debug endpoints (module docstring).

    port=0 binds an ephemeral port (tests); `port` attribute holds the
    bound port after start(). `readiness` gates /readyz (None = always
    ready); `tracer`/`recorder` back the debug endpoints (None = the
    process defaults).
    """

    def __init__(
        self,
        registry: GaugeRegistry,
        port: int = 8080,
        host: str = "0.0.0.0",
        readiness: Optional[ReadinessCheck] = None,
        tracer=None,
        recorder=None,
        ledger=None,
        selfslo=None,
        introspection=None,
        profile_dir: Optional[str] = None,
        replication=None,
    ):
        self.registry = registry
        self.host = host
        self.port = port
        self.readiness = readiness
        self._tracer = tracer
        self._recorder = recorder
        self._ledger = ledger
        self._selfslo = selfslo
        # the solver introspection plane backing /debug/solver
        # (observability.devicetelemetry; None = endpoint reports
        # enabled: false) and the directory /debug/profile captures
        # into (the runtime wires --journal-dir; None = 503)
        self._introspection = introspection
        self._profile_dir = profile_dir
        # the replicated control plane backing /debug/replicas
        # (replication/plane.py scoreboard; None = endpoint reports
        # enabled: false — the single-replica deployment)
        self._replication = replication
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _tracer_or_default(self):
        if self._tracer is not None:
            return self._tracer
        from karpenter_tpu_torch.observability.tracing import default_tracer

        return default_tracer()

    def _recorder_or_default(self):
        if self._recorder is not None:
            return self._recorder
        from karpenter_tpu_torch.observability.flightrecorder import (
            default_flight_recorder,
        )

        return default_flight_recorder()

    def _ledger_or_default(self):
        if self._ledger is not None:
            return self._ledger
        from karpenter_tpu_torch.observability.provenance import default_ledger

        return default_ledger()

    # -- responses ---------------------------------------------------------

    def _respond_ready(self) -> Tuple[int, bytes, str]:
        if self.readiness is None:
            return 200, b"ok", "text/plain"
        try:
            ready, reason = self.readiness()
        except Exception as error:  # noqa: BLE001 — a broken check is NOT ready
            ready, reason = False, f"readiness check failed: {error}"
        if ready:
            return 200, b"ok", "text/plain"
        return 503, reason.encode(), "text/plain"

    def _respond_traces(self, query: dict) -> Tuple[int, bytes, str]:
        limit = _parse_limit(query)
        tracer = self._tracer_or_default()
        tenant = query.get("tenant", [None])[0]
        if tenant is not None:
            # per-tenant view (docs/multitenancy.md): keep whole TRACES
            # that touched the tenant — any span stamped tenant=<id>
            # (the tenancy serve spans, tenant-stamped solver requests)
            # selects its trace, and every span of a selected trace is
            # returned so the tick context around the tenant's work
            # survives the filter. The limit applies AFTER filtering.
            spans = tracer.snapshot()
            traces = {
                span["trace"] for span in spans
                if span["args"].get("tenant") == tenant
            }
            spans = [s for s in spans if s["trace"] in traces]
            if limit is not None and limit >= 0:
                spans = spans[-limit:] if limit else []
        else:
            spans = tracer.snapshot(limit=limit)
        body = json.dumps({
            "base_time_ns": CHROME_BASE_NS,
            "spans_total": tracer.spans_total,
            "spans_dropped": tracer.spans_dropped,
            "spans": spans,
        }, sort_keys=True).encode()
        return 200, body, "application/json"

    def _respond_flightrecorder(self, query: dict) -> Tuple[int, bytes, str]:
        kind = query.get("kind", [None])[0]
        tenant = query.get("tenant", [None])[0]
        events = self._recorder_or_default().events(kind=kind)
        if tenant is not None:
            events = [e for e in events if e.get("tenant") == tenant]
        body = json.dumps({
            "events": events,
        }, sort_keys=True).encode()
        return 200, body, "application/json"

    def _respond_decisions(self, query: dict) -> Tuple[int, bytes, str]:
        limit = _parse_limit(query)
        ledger = self._ledger_or_default()
        body = json.dumps({
            "enabled": ledger.enabled,
            "records_total": ledger.records_total,
            "records_dropped": ledger.records_dropped,
            "decisions": ledger.query(
                kind=query.get("kind", [None])[0],
                tenant=query.get("tenant", [None])[0],
                group=query.get("group", [None])[0],
                name=query.get("name", [None])[0],
                limit=limit,
            ),
        }, sort_keys=True).encode()
        return 200, body, "application/json"

    def _respond_solver(self, query: dict) -> Tuple[int, bytes, str]:
        if self._introspection is None:
            body = json.dumps({"enabled": False}).encode()
            return 200, body, "application/json"
        limit = _parse_limit(query)
        snapshot = self._introspection.snapshot(
            ledger_limit=limit if limit is not None else 32
        )
        body = json.dumps(snapshot, sort_keys=True).encode()
        return 200, body, "application/json"

    def _respond_profile(self, query: dict) -> Tuple[int, bytes, str]:
        """One on-demand torch.profiler capture (observability.profiler
        capture_profile): bounded, single-flight, written atomically
        into the journal dir; every no-can-do answers 503 with the
        reason so an operator's curl explains itself."""
        from karpenter_tpu_torch.observability.profiler import (
            ProfileBusy,
            ProfileUnavailable,
            capture_profile,
        )

        if not self._profile_dir:
            return (
                503,
                b"no --journal-dir configured: nowhere to write the "
                b"capture",
                "text/plain",
            )
        try:
            ms = int(query.get("ms", ["100"])[0])
        except (ValueError, IndexError):
            return 400, b"?ms=N must be an integer", "text/plain"
        tracer = self._tracer_or_default()
        # the active trace id: the serving thread carries no span, so
        # fall back to the newest recorded span's trace — the tick the
        # operator is (almost certainly) asking about
        trace_id = tracer.current_trace_id()
        if trace_id is None:
            newest = tracer.snapshot(limit=1)
            trace_id = newest[0]["trace"] if newest else None
        try:
            report = capture_profile(
                ms, self._profile_dir, trace_id=trace_id
            )
        except (ProfileUnavailable, ProfileBusy) as error:
            return 503, str(error).encode(), "text/plain"
        except Exception as error:  # noqa: BLE001 — capture must not 500-loop
            return (
                503,
                f"profiler capture failed: {error}".encode(),
                "text/plain",
            )
        body = json.dumps(report, sort_keys=True).encode()
        return 200, body, "application/json"

    def _respond_selfslo(self) -> Tuple[int, bytes, str]:
        if self._selfslo is None:
            body = json.dumps({"enabled": False}).encode()
        else:
            body = json.dumps(
                {"enabled": True, **self._selfslo.scoreboard()},
                sort_keys=True,
            ).encode()
        return 200, body, "application/json"

    def _respond_replicas(self) -> Tuple[int, bytes, str]:
        if self._replication is None:
            body = json.dumps({"enabled": False}).encode()
        else:
            body = json.dumps(
                {"enabled": True, **self._replication.scoreboard()},
                sort_keys=True,
            ).encode()
        return 200, body, "application/json"

    def _route(self, path: str, query: dict) -> Optional[Tuple[int, bytes, str]]:
        """(status, body, content-type) or None for 404."""
        if path in ("", "/healthz"):
            return 200, b"ok", "text/plain"
        if path == "/metrics":
            return (
                200,
                self.registry.expose_text().encode(),
                "text/plain; version=0.0.4",
            )
        handlers = {
            "/readyz": lambda q: self._respond_ready(),
            "/debug/traces": self._respond_traces,
            "/debug/flightrecorder": self._respond_flightrecorder,
            "/debug/decisions": self._respond_decisions,
            "/debug/selfslo": lambda q: self._respond_selfslo(),
            "/debug/replicas": lambda q: self._respond_replicas(),
            "/debug/solver": self._respond_solver,
            "/debug/profile": self._respond_profile,
        }
        handler = handlers.get(path)
        return handler(query) if handler is not None else None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> int:
        route = self._route

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                split = urlsplit(self.path)
                response = route(
                    split.path.rstrip("/"), parse_qs(split.query)
                )
                if response is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                status, body, content_type = response
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet: scrapes every 5s
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
