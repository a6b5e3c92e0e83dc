"""Metrics layer of the port: the gauge registry, the metric types, the
metrics clients and the pending-capacity producer (copies of
karpenter_tpu/metrics/registry.py, types.py, clients.py and
producers/pendingcapacity/)."""

from karpenter_tpu_torch.metrics.registry import (
    GaugeRegistry,
    default_registry,
    reset_default_registry,
)
from karpenter_tpu_torch.metrics.types import Metric, MetricsClient, Producer

__all__ = [
    "GaugeRegistry",
    "default_registry",
    "reset_default_registry",
    "Metric",
    "MetricsClient",
    "Producer",
]
