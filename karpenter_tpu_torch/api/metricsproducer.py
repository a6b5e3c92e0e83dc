"""MetricsProducer resource: one-of spec for scaling-signal producers.

reference: pkg/apis/autoscaling/v1alpha1/metricsproducer.go:22-122,
metricsproducer_status.go:24-79, metricsproducer_validation.go:47-166.
"""

from __future__ import annotations

import re
import zoneinfo
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.api.conditions import ACTIVE, Condition, ConditionManager
from karpenter_tpu_torch.api.core import ObjectMeta
from karpenter_tpu_torch.constraints.spec import (
    ConstraintGroup,
    validate_constraints,
)

AWS_SQS_QUEUE_TYPE = "AWSSQSQueue"
# TPU-native queue type: a pluggable in-cluster work queue (the reference's
# AWSSQSQueue analog for non-AWS deployments).
FAKE_QUEUE_TYPE = "FakeQueue"


@dataclass(slots=True)
class ReservedCapacitySpec:
    node_selector: Dict[str, str] = field(default_factory=dict)

    def validate(self) -> None:
        """reference: metricsproducer_validation.go:90-95"""
        if len(self.node_selector) != 1:
            raise ValueError(
                "reserved capacity must refer to exactly one node selector"
            )


@dataclass(slots=True)
class PendingCapacitySpec:
    node_selector: Dict[str, str] = field(default_factory=dict)
    # scale-from-zero: when node_selector matches NO nodes, profile the
    # group from the cloud provider's NodeTemplate for this
    # ScalableNodeGroup (same namespace). Live nodes always win —
    # observed truth over declared shape.
    node_group_ref: str = ""
    # declarative constraint groups (karpenter_tpu/constraints): pod
    # anti-affinity / compact placement / zone spread / reservation
    # claims compiled into the batched solve's masked integer operands.
    # Empty = today's unconstrained wire, byte-identical.
    constraints: List[ConstraintGroup] = field(default_factory=list)

    def validate(self) -> None:
        """reference: metricsproducer_validation.go:85-87, plus the
        constraint-group rules (constraints/spec.py)."""
        if self.constraints:
            validate_constraints(self.constraints)


@dataclass(slots=True)
class QueueSpec:
    type: str = ""
    id: str = ""


# Element-at-a-time regexes (reference: metricsproducer_validation.go:98-110)
_WEEKDAY_RE = re.compile(
    r"^((sun(day)?|0|7)|(mon(day)?|1)|(tue(sday)?|2)|(wed(nesday)?|3)"
    r"|(thu(rsday)?|4)|(fri(day)?|5)|(sat(urday)?|6))$"
)
_MONTH_RE = re.compile(
    r"^((jan(uary)?|1)|(feb(ruary)?|2)|(mar(ch)?|3)|(apr(il)?|4)|(may|5)"
    r"|(june?|6)|(july?|7)|(aug(ust)?|8)|(sep(tember)?|9)|((oct(ober)?)|(10))"
    r"|(nov(ember)?|(11))|(dec(ember)?|(12)))$"
)
_NUMBER_RE = re.compile(r"^\d+$")

# Numeric bounds per field, enforced at admission so a spec that validates
# can always be evaluated by utils.cron (the reference validated only \d+ and
# let robfig/cron reject out-of-range values at reconcile time — a spec
# accepted by its webhook could still fail every reconcile).
_FIELD_BOUNDS = {"days": (1, 31), "hours": (0, 23), "minutes": (0, 59)}


def _validate_field(value: Optional[str], pattern: re.Pattern, name: str) -> None:
    if value is None:
        return
    for elem in value.split(","):
        elem = elem.strip().lower()
        if not elem or not pattern.match(elem):
            raise ValueError(f"unable to parse: {value}")
        if name in _FIELD_BOUNDS and elem.isdigit():
            lo, hi = _FIELD_BOUNDS[name]
            if not lo <= int(elem) <= hi:
                raise ValueError(
                    f"{name} element {elem} out of range [{lo},{hi}]"
                )


@dataclass(slots=True)
class Pattern:
    """Strongly-typed crontab (reference: metricsproducer.go:70-83)."""

    minutes: Optional[str] = None
    hours: Optional[str] = None
    days: Optional[str] = None
    months: Optional[str] = None
    weekdays: Optional[str] = None

    def validate(self) -> None:
        _validate_field(self.weekdays, _WEEKDAY_RE, "weekdays")
        _validate_field(self.months, _MONTH_RE, "months")
        _validate_field(self.days, _NUMBER_RE, "days")
        _validate_field(self.hours, _NUMBER_RE, "hours")
        _validate_field(self.minutes, _NUMBER_RE, "minutes")

    def to_cron(self):
        """Compile to a utils.cron.Cron (reference: crontabs.go:33-49)."""
        from karpenter_tpu_torch.utils.cron import Cron

        return Cron(
            minutes=self.minutes,
            hours=self.hours,
            days=self.days,
            months=self.months,
            weekdays=self.weekdays,
        )


@dataclass(slots=True)
class ScheduledBehavior:
    replicas: int = 0
    start: Optional[Pattern] = None
    end: Optional[Pattern] = None


@dataclass(slots=True)
class ScheduleSpec:
    behaviors: List[ScheduledBehavior] = field(default_factory=list)
    timezone: Optional[str] = None
    default_replicas: int = 0

    def validate(self) -> None:
        """reference: metricsproducer_validation.go:61-82"""
        for behavior in self.behaviors:
            for which, pattern in (("start", behavior.start), ("end", behavior.end)):
                if pattern is None:
                    raise ValueError(f"{which} pattern is required")
                try:
                    pattern.validate()
                except ValueError as e:
                    raise ValueError(f"{which} pattern could not be parsed, {e}")
            if behavior.replicas < 0:
                raise ValueError("behavior.replicas cannot be negative")
        if self.default_replicas < 0:
            raise ValueError("defaultReplicas cannot be negative")
        if self.timezone is not None:
            try:
                zoneinfo.ZoneInfo(self.timezone)
            except (zoneinfo.ZoneInfoNotFoundError, ValueError):
                raise ValueError("timezone region could not be parsed")


@dataclass(slots=True)
class MetricsProducerSpec:
    pending_capacity: Optional[PendingCapacitySpec] = None
    queue: Optional[QueueSpec] = None
    reserved_capacity: Optional[ReservedCapacitySpec] = None
    schedule: Optional[ScheduleSpec] = None


# Pluggable per-cloud queue validators
# (reference: metricsproducer_validation.go:146-166)
_queue_validators = {}


def register_queue_validator(queue_type: str, validator) -> None:
    _queue_validators[queue_type] = validator


def validate_queue(spec: QueueSpec) -> None:
    validator = _queue_validators.get(spec.type)
    if validator is None:
        raise ValueError(f"unexpected queue type {spec.type}")
    validator(spec)


@dataclass(slots=True)
class QueueStatus:
    length: int = 0
    oldest_message_age_seconds: int = 0


@dataclass(slots=True)
class ScheduledCapacityStatus:
    current_value: Optional[int] = None
    next_value_time: Optional[float] = None
    next_value: Optional[int] = None


@dataclass(slots=True)
class PendingCapacityStatus:
    """Per-node-group pending-pods signal. The reference's status struct is
    empty (metricsproducer_status.go:44-45); we surface the solver outputs."""

    pending_pods: int = 0  # pending pods this group would absorb
    additional_nodes_needed: int = 0  # shelf-BFD node count for those pods
    lp_lower_bound: int = 0  # LP-relaxation lower bound (diagnostic)
    unschedulable_pods: int = 0  # cluster-wide: pods no group can take


@dataclass(slots=True)
class MetricsProducerStatus:
    pending_capacity: Optional[PendingCapacityStatus] = None
    queue: Optional[QueueStatus] = None
    reserved_capacity: Dict[str, str] = field(default_factory=dict)
    scheduled_capacity: Optional[ScheduledCapacityStatus] = None
    conditions: List[Condition] = field(default_factory=list)


@dataclass(slots=True)
class MetricsProducer:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: MetricsProducerSpec = field(default_factory=MetricsProducerSpec)
    status: MetricsProducerStatus = field(default_factory=MetricsProducerStatus)

    KIND = "MetricsProducer"

    def status_conditions(self) -> ConditionManager:
        return ConditionManager([ACTIVE], self.status.conditions)

    def validate(self) -> None:
        """One-of dispatch (reference: metricsproducer_validation.go:47-58)."""
        for validator in (
            self.spec.pending_capacity,
            self.spec.reserved_capacity,
            self.spec.schedule,
        ):
            if validator is not None:
                validator.validate()
                return

    def default(self) -> None:
        pass
