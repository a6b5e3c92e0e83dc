"""Queue producer: queue length + oldest message age as scaling signals.

reference: pkg/metrics/producers/queue/{producer,gauges}.go.

The port's copy of karpenter_tpu/metrics/producers/queue.py.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.api.metricsproducer import QueueStatus
from karpenter_tpu_torch.metrics.registry import GaugeRegistry, default_registry

SUBSYSTEM = "queue"
LENGTH = "length"
OLDEST_MESSAGE_AGE_SECONDS = "oldest_message_age_seconds"


def register_gauges(registry: GaugeRegistry) -> None:
    registry.register(SUBSYSTEM, LENGTH)
    registry.register(SUBSYSTEM, OLDEST_MESSAGE_AGE_SECONDS)


class QueueProducer:
    def __init__(self, mp, queue, registry: Optional[GaugeRegistry] = None):
        self.mp = mp
        self.queue = queue
        self.registry = registry if registry is not None else default_registry()
        register_gauges(self.registry)

    def reconcile(self) -> None:
        length = self.queue.length()
        oldest = self.queue.oldest_message_age_seconds()
        self.mp.status.queue = QueueStatus(
            length=length, oldest_message_age_seconds=oldest
        )
        name, namespace = self.mp.metadata.name, self.mp.metadata.namespace
        self.registry.gauge(SUBSYSTEM, LENGTH).set(name, namespace, float(length))
        self.registry.gauge(SUBSYSTEM, OLDEST_MESSAGE_AGE_SECONDS).set(
            name, namespace, float(oldest)
        )
