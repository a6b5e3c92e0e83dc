"""HorizontalAutoscaler controller (reference:
pkg/controllers/horizontalautoscaler/v1alpha1/controller.go:40-50).

Unlike the reference's one-object-at-a-time Reconcile, the batch path hands
the whole fleet to the BatchAutoscaler for a single device evaluation — this
is the singleton-architecture note at controller.go:45-46 resolved the TPU
way: no sharded controllers, one array program.

The port's copy of karpenter_tpu/controllers/horizontalautoscaler.py,
changed only in its imports.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from karpenter_tpu_torch.api.horizontalautoscaler import HorizontalAutoscaler
from karpenter_tpu_torch.autoscaler import BatchAutoscaler


class HorizontalAutoscalerController:
    """`solver_service` (solver/service.py) is the shared solve service:
    the BatchAutoscaler's decision kernel is already routed through it as
    the `decider` seam (runtime.py wiring); the controller additionally
    records each fleet evaluation into the service's latency surface so
    /metrics shows the decide stage next to the bin-pack stages."""

    def __init__(
        self, batch_autoscaler: BatchAutoscaler, solver_service=None
    ):
        self.autoscaler = batch_autoscaler
        self.solver_service = solver_service

    def kind(self) -> str:
        return HorizontalAutoscaler.KIND

    def interval(self) -> float:
        return 10.0

    @staticmethod
    def event_routes() -> tuple:
        """Event-driven mode (engine module docstring): autoscalers
        decide off producer-published gauges, and producers run first in
        tick order precisely so those signals are fresh — a refreshed
        producer status is therefore the 'new signal available' edge
        that should trigger a re-decide now, not at the next interval.
        Tick-paced mode never registers this watch."""
        return ("MetricsProducer",)

    def on_deleted(self, ha) -> None:
        """Engine pruning signal: drop the deleted autoscaler's metric
        history, skill state, and forecast gauges (forecast/engine.py) —
        the ring buffers are bounded, but a deleted object's series must
        not linger until eviction."""
        forecaster = getattr(self.autoscaler, "forecaster", None)
        if forecaster is not None:
            forecaster.prune(ha.metadata.namespace, ha.metadata.name)
        cost_engine = getattr(self.autoscaler, "cost_engine", None)
        if cost_engine is not None:
            cost_engine.prune(ha.metadata.namespace, ha.metadata.name)

    def reconcile(self, ha) -> None:
        error = self.reconcile_batch([ha]).get(
            (ha.metadata.namespace, ha.metadata.name)
        )
        if error is not None:
            raise error

    def reconcile_batch(
        self, has: List[HorizontalAutoscaler]
    ) -> Dict[tuple, Optional[Exception]]:
        """Keyed by (namespace, name)."""
        if self.solver_service is not None:
            with self.solver_service.track("reconcile_batch"):
                return self.autoscaler.reconcile_batch(has)
        return self.autoscaler.reconcile_batch(has)
