"""Status conditions with knative living-condition-set semantics.

The reference manages status through knative's ConditionManager (reference:
pkg/apis/autoscaling/v1alpha1/horizontalautoscaler_status.go:89-95 and
metricsproducer_status.go / scalablenodegroup_status.go): each resource
declares a set of dependent condition types, all of "true-happy" polarity,
plus a derived top-level Ready condition that is True iff every dependent is
True. Tests converge on "happy" = all conditions True
(pkg/test/expectations/expectations.go:51-61).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Dict, List, Optional

TRUE = "True"
FALSE = "False"
UNKNOWN = "Unknown"

READY = "Ready"
# Shared condition types (reference: pkg/apis/autoscaling/v1alpha1/doc.go and
# the per-resource *_status.go files).
ACTIVE = "Active"
ABLE_TO_SCALE = "AbleToScale"
SCALING_UNBOUNDED = "ScalingUnbounded"
STABILIZED = "Stabilized"

# Forecasting: set only on HorizontalAutoscalers whose spec opts into
# predictive scaling (behavior.forecast, docs/forecasting.md). True =
# forecasts are blending into scale-up decisions; False = degraded to
# reactive-only, with the reason naming why (warming up, skill below
# the confidence floor, forecast path unavailable). NOT a dependent of
# Ready — a degraded forecast is a posture, not a failure.
FORECASTING = "Forecasting"

# Structured condition REASONS (machine-readable; the message carries the
# human detail). ActuationCircuitOpen: the per-node-group actuation
# circuit breaker is open after repeated provider failures — the message
# threads the last RetryableError.code and the next-probe ETA
# (docs/resilience.md "Circuit breaker").
ACTUATION_CIRCUIT_OPEN = "ActuationCircuitOpen"


@dataclass(slots=True)
class Condition:
    type: str
    status: str = UNKNOWN
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


class ConditionManager:
    """Living condition set over a resource's .conditions list."""

    def __init__(self, dependents: List[str], conditions: List[Condition]):
        self.dependents = list(dependents)
        self.conditions = conditions

    def _index(self) -> Dict[str, Condition]:
        return {c.type: c for c in self.conditions}

    def get(self, condition_type: str) -> Optional[Condition]:
        return self._index().get(condition_type)

    def initialize(self) -> None:
        index = self._index()
        for t in self.dependents + [READY]:
            if t not in index:
                self.conditions.append(Condition(type=t, status=UNKNOWN))

    def _set(self, condition_type: str, status: str, reason: str, message: str):
        index = self._index()
        existing = index.get(condition_type)
        if existing is None:
            existing = Condition(type=condition_type)
            self.conditions.append(existing)
        if (existing.status, existing.reason, existing.message) != (
            status,
            reason,
            message,
        ):
            existing.status = status
            existing.reason = reason
            existing.message = message
            existing.last_transition_time = _time.time()
        self._recompute_ready()

    def _recompute_ready(self):
        index = self._index()
        status = TRUE
        reason, message = "", ""
        for t in self.dependents:
            dep = index.get(t)
            if dep is None or dep.status == UNKNOWN:
                status = UNKNOWN
            elif dep.status == FALSE:
                status, reason, message = FALSE, dep.reason, dep.message
                break
        ready = index.get(READY)
        if ready is None:
            ready = Condition(type=READY)
            self.conditions.append(ready)
        if (ready.status, ready.reason, ready.message) != (status, reason, message):
            ready.status = status
            ready.reason = reason
            ready.message = message
            ready.last_transition_time = _time.time()

    def mark_true(self, condition_type: str) -> None:
        self._set(condition_type, TRUE, "", "")

    def mark_false(self, condition_type: str, reason: str = "", message: str = ""):
        self._set(condition_type, FALSE, reason, message)

    def mark_unknown(self, condition_type: str, reason: str = "", message: str = ""):
        self._set(condition_type, UNKNOWN, reason, message)

    def is_happy(self) -> bool:
        """True iff every condition on the resource is True."""
        if not self.conditions:
            return False
        return all(c.status == TRUE for c in self.conditions)
