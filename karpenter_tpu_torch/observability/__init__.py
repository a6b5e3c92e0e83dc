"""Observability: reconcile tracing, the flight recorder, the decision
ledger, the self-SLO monitor, the solver introspection plane and the
HTTP surface (the port's copy of karpenter_tpu/observability).

  tracing.py         per-reconcile trace IDs + spans, coalesced-dispatch
                     links, Chrome-trace/Perfetto JSONL export; a span
                     is also a torch.profiler range while a profiler
                     records, on the profiler's clock
  flightrecorder.py  bounded structured event ring (fault injections,
                     FSM trips, watchdog restarts) with trace-ID
                     backlinks and crash-safe dumps
  provenance.py      the decision provenance ledger: a bounded
                     columnar ring answering "why did this group scale
                     to N this tick" (default off)
  selfslo.py         the control plane's self-SLO monitor: multi-window
                     burn rates over karpenter_reconcile_e2e_seconds +
                     the solver FSM + tenant breakers + device memory
                     (/debug/selfslo)
  devicetelemetry.py the solver introspection plane: compile ledger
                     (first dispatches, graph captures, the kernels'
                     build), card memory telemetry, the kernels' cost
                     attribution (/debug/solver; default off,
                     --introspect)
  server.py          /metrics, /healthz, /readyz and the /debug/*
                     endpoints
  profiler.py        solver_trace (the guarded torch.profiler range a
                     span opens, probed once), the profiler server
                     (--profiler-port: GET /profile answers a Chrome
                     trace) and /debug/profile's bounded single-flight
                     torch.profiler capture

Copies of the reference's modules of the same names, except
profiler.py, whose jax.profiler calls become torch.profiler ones (its
xprof server becomes an HTTP server of Chrome traces), and
devicetelemetry.py, whose
sources are torch.cuda's memory stats and the service's first-time
events (its module docstring).
"""

from karpenter_tpu_torch.observability.devicetelemetry import (
    CompileLedger,
    SolverIntrospection,
)
from karpenter_tpu_torch.observability.flightrecorder import (
    FlightRecorder,
    default_flight_recorder,
    reset_default_flight_recorder,
    set_default_flight_recorder,
)
from karpenter_tpu_torch.observability.profiler import (
    solver_trace,
    start_profiler_server,
)
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
    "CompileLedger",
    "DecisionLedger",
    "FlightRecorder",
    "MetricsServer",
    "SelfSLOMonitor",
    "SolverIntrospection",
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
    "start_profiler_server",
]
