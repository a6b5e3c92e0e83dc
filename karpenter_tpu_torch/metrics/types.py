"""Metric value + producer/client protocols (reference: pkg/metrics/types.go:28-38).

The port's copy of karpenter_tpu/metrics/types.py, changed only in its
imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Protocol


@dataclass
class Metric:
    """Current value of a metric."""

    name: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    value: float = 0.0


class Producer(Protocol):
    def reconcile(self) -> None:
        """Compute and publish the producer's current metric values."""


class MetricsClient(Protocol):
    def get_current_value(self, metric_spec) -> Metric:
        """Return the current value for the specified metric source."""
