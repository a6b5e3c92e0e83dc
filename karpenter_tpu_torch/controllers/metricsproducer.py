"""MetricsProducer controller (reference:
pkg/controllers/metricsproducer/v1alpha1/controller.go:40-47; the port's
copy of karpenter_tpu/controllers/metricsproducer.py).

Batch hook: all pendingCapacity producers due in a tick are solved in ONE
device bin-pack call (the reference reconciles each producer independently;
pending-pods is inherently a global problem — DESIGN.md "Pending Pods").
"""

from __future__ import annotations

from typing import Dict, List, Optional

from karpenter_tpu_torch.api.metricsproducer import MetricsProducer
from karpenter_tpu_torch.metrics.producers.pendingcapacity import solve_pending

# every per-producer gauge SUBSYSTEM: the deletion hook below retires a
# deleted producer's {name, namespace} series from every vec registered
# under these — without this, a deleted queue's karpenter_queue_length
# (and the whole resources x metric-types reserved_capacity family)
# froze at its last value forever (the same frozen-series bug the cost
# engine's karpenter_cost_* series had). Subsystem-wide removal
# (GaugeRegistry.remove_series) so families added later are covered
# without re-enumerating metric names here.
_PRODUCER_SUBSYSTEMS = (
    "queue",
    "reserved_capacity",
    "scheduled_capacity",
    "pending_capacity",
)


class MetricsProducerController:
    def __init__(self, producer_factory):
        self.factory = producer_factory

    def kind(self) -> str:
        return MetricsProducer.KIND

    def interval(self) -> float:
        return 5.0

    @staticmethod
    def event_routes() -> tuple:
        """Event-driven mode (engine module docstring): a Pod appearing,
        binding, or vanishing — and a Node joining or draining — changes
        the very capacity picture pendingCapacity producers exist to
        measure, so those events pull every producer due-now into the
        next coalesced event pass instead of waiting out the interval.
        Tick-paced mode never registers these watches."""
        return ("Pod", "Node")

    def on_deleted(self, mp) -> None:
        """Retire a deleted producer's gauge series (module constant):
        series are keyed {name, namespace} per producer, so a deleted
        object's last values must leave /metrics with it."""
        for subsystem in _PRODUCER_SUBSYSTEMS:
            self.factory.registry.remove_series(
                subsystem, mp.metadata.name, mp.metadata.namespace
            )

    def reconcile(self, mp) -> None:
        self.factory.for_producer(mp).reconcile()

    def _solve_pending_batch(self, pending, key, results) -> None:
        """One device bin-pack call for every due pendingCapacity producer."""
        try:
            outcomes = solve_pending(
                self.factory.store,
                pending,
                self.factory.registry,
                solver=self.factory.solver,
                feed=self.factory.pending_feed(),
                template_resolver=self.factory.template_resolver(),
            )
            for mp in pending:
                # per-ROW outcome: a poisoned spec fails only itself
                results[key(mp)] = outcomes.get(key(mp))
        except Exception as e:  # noqa: BLE001 — global failure
            for mp in pending:
                results[key(mp)] = e

    def reconcile_batch(
        self, mps: List[MetricsProducer]
    ) -> Dict[tuple, Optional[Exception]]:
        key = lambda mp: (mp.metadata.namespace, mp.metadata.name)
        results: Dict[tuple, Optional[Exception]] = {}
        pending = [mp for mp in mps if mp.spec.pending_capacity is not None]
        others = [mp for mp in mps if mp.spec.pending_capacity is None]

        if pending:
            self._solve_pending_batch(pending, key, results)

        for mp in others:
            try:
                self.factory.for_producer(mp).reconcile()
                results[key(mp)] = None
            except Exception as e:  # noqa: BLE001
                results[key(mp)] = e
        return results
