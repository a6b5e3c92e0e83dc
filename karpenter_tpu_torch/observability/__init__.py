"""Observability: reconcile tracing, the flight recorder, the decision
ledger, the self-SLO monitor and the HTTP surface (the port's copy of
karpenter_tpu/observability, less device telemetry).

  tracing.py         per-reconcile trace IDs + spans, coalesced-dispatch
                     links, Chrome-trace/Perfetto JSONL export
  flightrecorder.py  bounded structured event ring (fault injections,
                     FSM trips, watchdog restarts) with trace-ID
                     backlinks and crash-safe dumps
  provenance.py      the decision provenance ledger: a bounded
                     columnar ring answering "why did this group scale
                     to N this tick" (default off)
  selfslo.py         the control plane's self-SLO monitor: multi-window
                     burn rates over karpenter_reconcile_e2e_seconds +
                     the solver FSM (/debug/selfslo)
  server.py          /metrics, /healthz, /readyz and the /debug/*
                     endpoints
  profiler.py        solver_trace (a torch.profiler range around a
                     device section) and /debug/profile's bounded
                     single-flight torch.profiler capture

Copies of the reference's modules of the same names, except
profiler.py, whose jax.profiler calls become torch.profiler ones (the
remote xprof server has no counterpart). Device telemetry
(devicetelemetry.py, --introspect) is not ported yet.
"""

from karpenter_tpu_torch.observability.flightrecorder import (
    FlightRecorder,
    default_flight_recorder,
    reset_default_flight_recorder,
    set_default_flight_recorder,
)
from karpenter_tpu_torch.observability.profiler import solver_trace
from karpenter_tpu_torch.observability.provenance import (
    DecisionLedger,
    default_ledger,
    reset_default_ledger,
    set_default_ledger,
)
from karpenter_tpu_torch.observability.selfslo import SelfSLOMonitor
from karpenter_tpu_torch.observability.server import MetricsServer
from karpenter_tpu_torch.observability.tracing import (
    Tracer,
    default_tracer,
    reset_default_tracer,
    set_default_tracer,
)

__all__ = [
    "DecisionLedger",
    "FlightRecorder",
    "MetricsServer",
    "SelfSLOMonitor",
    "Tracer",
    "default_flight_recorder",
    "default_ledger",
    "default_tracer",
    "reset_default_flight_recorder",
    "reset_default_ledger",
    "reset_default_tracer",
    "set_default_flight_recorder",
    "set_default_ledger",
    "set_default_tracer",
    "solver_trace",
]
