"""Observability: reconcile tracing and the flight recorder (the part of
karpenter_tpu/observability that the solve service needs).

  tracing.py         per-reconcile trace IDs + spans, coalesced-dispatch
                     links, Chrome-trace/Perfetto JSONL export
  flightrecorder.py  bounded structured event ring (fault injections,
                     FSM trips, watchdog restarts) with trace-ID
                     backlinks and crash-safe dumps
  provenance.py      the decision provenance ledger: a bounded
                     columnar ring answering "why did this group scale
                     to N this tick" (default off)
  profiler.py        solver_trace: a torch.profiler range around a
                     device section

Copies of the reference's modules of the same names, except
profiler.py, which keeps only solver_trace. The self-SLO monitor, device
telemetry and the HTTP server come with later slices.
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
from karpenter_tpu_torch.observability.tracing import (
    Tracer,
    default_tracer,
    reset_default_tracer,
    set_default_tracer,
)

__all__ = [
    "DecisionLedger",
    "FlightRecorder",
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
