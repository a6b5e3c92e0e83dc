"""ScheduledCapacity producer: time-based replica schedules.

reference: pkg/metrics/producers/scheduledcapacity/{producer,crontabs}.go —
for each behavior, compute the next cron match of its start and end patterns
in the configured timezone; a behavior is active when the next end comes at
or before the next start (i.e. we are inside the window). First active
behavior wins; otherwise defaultReplicas.

The port's copy of karpenter_tpu/metrics/producers/scheduledcapacity.py.
"""

from __future__ import annotations

import datetime
import zoneinfo
from typing import Optional

from karpenter_tpu_torch.api.metricsproducer import ScheduledCapacityStatus
from karpenter_tpu_torch.metrics.registry import GaugeRegistry, default_registry

SUBSYSTEM = "scheduled_capacity"
VALUE = "value"


def register_gauges(registry: GaugeRegistry) -> None:
    registry.register(SUBSYSTEM, VALUE)


class ScheduledCapacityProducer:
    def __init__(self, mp, registry: Optional[GaugeRegistry] = None, clock=None):
        self.mp = mp
        self.registry = registry if registry is not None else default_registry()
        self.clock = clock or (lambda: datetime.datetime.now(datetime.timezone.utc))
        register_gauges(self.registry)

    def reconcile(self) -> None:
        schedule = self.mp.spec.schedule
        if schedule.timezone is not None:
            try:
                tz = zoneinfo.ZoneInfo(schedule.timezone)
            except (zoneinfo.ZoneInfoNotFoundError, ValueError):
                raise RuntimeError("timezone was not a valid input")
        else:
            tz = datetime.timezone.utc
        now = self.clock().astimezone(tz)

        value = schedule.default_replicas
        for behavior in schedule.behaviors:
            next_start = behavior.start.to_cron().next_after(now)
            next_end = behavior.end.to_cron().next_after(now)
            # Inside the window iff the next end fires no later than the next
            # start (reference: producer.go:61-66). Spec order resolves
            # collisions: first match wins.
            if next_end <= next_start:
                value = behavior.replicas
                break

        self.mp.status.scheduled_capacity = ScheduledCapacityStatus(
            current_value=value
        )
        self.registry.gauge(SUBSYSTEM, VALUE).set(
            self.mp.metadata.name, self.mp.metadata.namespace, float(value)
        )
