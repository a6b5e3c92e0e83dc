"""HorizontalAutoscaler resource: HPA-v2beta2-shaped spec, status, behavior.

reference: pkg/apis/autoscaling/v1alpha1/horizontalautoscaler.go:33-275 and
horizontalautoscaler_status.go:22-103. The behavior helpers here are the
host-side scalar semantics (defaults via merge, select policy, scaling rules,
stabilization window); they double as the golden oracle for the batched
device decision kernel.

The port's copy of karpenter_tpu/api/horizontalautoscaler.py, changed
only in its imports.
"""

from __future__ import annotations

import math
import time as _time
from dataclasses import dataclass, field
from typing import List, Optional

from karpenter_tpu_torch.api.conditions import (
    ABLE_TO_SCALE,
    ACTIVE,
    SCALING_UNBOUNDED,
    Condition,
    ConditionManager,
)
from karpenter_tpu_torch.api.core import ObjectMeta
from karpenter_tpu_torch.utils.functional import merge_into
from karpenter_tpu_torch.utils.log import invariant_violated, logger

# Metric target types (reference: horizontalautoscaler.go:190-197)
UTILIZATION = "Utilization"
VALUE = "Value"
AVERAGE_VALUE = "AverageValue"

# Select policies (reference: horizontalautoscaler.go:118-127)
MAX_POLICY_SELECT = "Max"
MIN_POLICY_SELECT = "Min"
DISABLED_POLICY_SELECT = "Disabled"

# Scaling policy types (reference: horizontalautoscaler.go:131-138)
COUNT_SCALING_POLICY = "Count"
PERCENT_SCALING_POLICY = "Percent"


@dataclass(slots=True)
class CrossVersionObjectReference:
    kind: str = ""
    name: str = ""
    api_version: str = ""


@dataclass(slots=True)
class MetricTarget:
    type: str = VALUE
    value: Optional[float] = None
    average_value: Optional[float] = None
    average_utilization: Optional[int] = None

    def target_value(self) -> float:
        for v in (self.value, self.average_value, self.average_utilization):
            if v is not None:
                return float(v)
        return 0.0


@dataclass(slots=True)
class PrometheusMetricSource:
    query: str = ""
    target: MetricTarget = field(default_factory=MetricTarget)


@dataclass(slots=True)
class Metric:
    """One-of metric source (reference: horizontalautoscaler.go:158-163)."""

    prometheus: Optional[PrometheusMetricSource] = None

    def get_target(self) -> MetricTarget:
        """reference: horizontalautoscaler.go:204-210"""
        if self.prometheus is not None:
            return self.prometheus.target
        invariant_violated(
            f"Unrecognized metric type while retrieving target for {self}"
        )


@dataclass(slots=True)
class ScalingPolicy:
    type: str = COUNT_SCALING_POLICY
    value: int = 0
    period_seconds: int = 0

    def validate(self) -> None:
        """reference: horizontalautoscaler.go:137-146 — value must be
        greater than zero; periodSeconds greater than zero and at most
        1800 (30 min). The reference documents these bounds but never
        enforces or applies them (autoscaler.go:186-189 TODO)."""
        if self.type not in (COUNT_SCALING_POLICY, PERCENT_SCALING_POLICY):
            raise ValueError(
                f"scaling policy type must be Count or Percent, got "
                f"{self.type!r}"
            )
        if self.value <= 0:
            raise ValueError(
                f"scaling policy value must be greater than zero, got "
                f"{self.value}"
            )
        if not 0 < self.period_seconds <= 1800:
            raise ValueError(
                "scaling policy periodSeconds must be in (0, 1800], got "
                f"{self.period_seconds}"
            )


@dataclass(slots=True)
class ScalingRules:
    stabilization_window_seconds: Optional[int] = None
    select_policy: Optional[str] = None
    policies: Optional[List[ScalingPolicy]] = None

    def within_stabilization_window(
        self, last_scale_time: Optional[float], now: Optional[float] = None
    ) -> bool:
        """reference: horizontalautoscaler.go:267-275"""
        if last_scale_time is None or self.stabilization_window_seconds is None:
            return False
        now = _time.time() if now is None else now
        return (now - last_scale_time) < float(self.stabilization_window_seconds)

    def allowed_change(
        self,
        current_replicas: int,
        last_scale_time: Optional[float],
        now: Optional[float] = None,
    ) -> Optional[int]:
        """Replica-change budget this direction's policies currently permit;
        None means unlimited. The scalar oracle for the device kernel's
        policy clamp (ops/decision.py) — the reference models these
        policies (horizontalautoscaler.go:111-146) but leaves application
        a TODO (autoscaler.go:186-189).

        Semantics with the state the CRD carries (LastScaleTime only): a
        policy budgets `value` replicas (Count) or
        ceil(max(current,1)*value/100) (Percent — floored at one replica's
        worth so a Percent-only policy can still escape zero replicas) per
        periodSeconds window; a scale event within the trailing period is
        conservatively assumed to have spent the budget, so the policy
        contributes 0 until its period elapses. Multiple policies combine
        under this direction's select policy (Max = most permissive, Min =
        most restrictive). No policies or no scale history = unlimited.
        """
        if not self.policies or last_scale_time is None:
            return None
        now = _time.time() if now is None else now
        elapsed = now - last_scale_time
        budgets = []
        for policy in self.policies:
            if elapsed < policy.period_seconds:
                budgets.append(0)
            elif policy.type == PERCENT_SCALING_POLICY:
                budgets.append(
                    int(
                        math.ceil(
                            max(current_replicas, 1) * policy.value / 100.0
                        )
                    )
                )
            else:
                budgets.append(policy.value)
        if self.select_policy == MIN_POLICY_SELECT:
            return min(budgets)
        return max(budgets)


@dataclass(slots=True)
class ForecastSpec:
    """Proactive-scaling behavior (docs/forecasting.md): forecast every
    metric `horizonSeconds` ahead and scale up to max(reactive,
    predicted). Scale-DOWN stays reactive-only by construction — a
    forecast can only raise the recommendation (the blend monotonicity
    the decision kernel pins), so a wrong forecast costs headroom,
    never availability.

    The reference has no predictive surface at all; this spec is the
    declarative face of the forecast subsystem (forecast/), evaluated
    for the whole fleet in one device dispatch per tick.
    """

    # how far ahead to forecast; a node group should set this at or
    # above its node-provisioning latency so capacity lands before the
    # load does
    horizon_seconds: float = 60.0
    # "holt-winters" (level/trend/seasonal) or "linear" (robust trend)
    model: str = "holt-winters"
    # confidence floor: blending auto-disables while the online skill
    # score (EWMA of horizon-ago forecast error; docs/forecasting.md
    # "Skill gating") sits below this
    min_skill: float = 0.25
    # dominant load period for the seasonal component (0 = no
    # seasonality; converted to ring-buffer sample slots at runtime)
    season_seconds: float = 0.0
    # Holt-Winters smoothing factors
    alpha: float = 0.5
    beta: float = 0.1
    gamma: float = 0.3
    # history samples required before the first forecast is trusted
    min_samples: int = 6

    def validate(self) -> None:
        if self.horizon_seconds <= 0:
            raise ValueError(
                f"forecast horizonSeconds must be > 0, got "
                f"{self.horizon_seconds}"
            )
        if self.model not in ("holt-winters", "linear"):
            raise ValueError(
                "forecast model must be holt-winters or linear, got "
                f"{self.model!r}"
            )
        if not 0.0 <= self.min_skill <= 1.0:
            raise ValueError(
                f"forecast minSkill must be in [0, 1], got {self.min_skill}"
            )
        if self.season_seconds < 0:
            raise ValueError(
                f"forecast seasonSeconds must be >= 0, got "
                f"{self.season_seconds}"
            )
        for field_name in ("alpha", "beta", "gamma"):
            v = getattr(self, field_name)
            if not 0.0 < v <= 1.0:
                raise ValueError(
                    f"forecast {field_name} must be in (0, 1], got {v}"
                )
        if self.min_samples < 2:
            raise ValueError(
                f"forecast minSamples must be >= 2, got {self.min_samples}"
            )


@dataclass(slots=True)
class SLOMetricTarget:
    """Per-metric SLO target: one entry per index of spec.metrics.

    The cost kernel already evaluates violation risk per metric and
    takes the WORST CASE across them (ops/cost.py `max` over the metric
    axis); this spec lets each metric declare its own per-replica
    capacity instead of sharing the single spec-wide targetValue — a
    queue-depth metric and a p99-latency proxy rarely mean the same
    thing by "one replica's worth"."""

    # per-replica capacity for the metric at the SAME INDEX in
    # spec.metrics; None falls back to the spec-wide targetValue, then
    # to the metric's own HPA target value
    target_value: Optional[float] = None

    def validate(self) -> None:
        if self.target_value is not None and self.target_value <= 0:
            raise ValueError(
                f"slo metrics targetValue must be > 0, got "
                f"{self.target_value}"
            )


@dataclass(slots=True)
class SLOSpec:
    """Cost- and SLO-aware scaling behavior (docs/cost.md): opt a
    HorizontalAutoscaler into the fleet's multi-objective refinement —
    the batched decide gains a second pass (ops/cost.py, ONE device
    dispatch for the whole fleet) that weighs expected hourly cost
    against SLO-violation risk, using the forecast distribution
    (spec.behavior.forecast) as the risk input when present.

    The reference has no cost surface at all; absent this spec the
    decision pipeline is bit-identical to the cost-blind one
    (wire-compat pinned in tests/test_cost.py).
    """

    # per-replica capacity the SLO deems safe, in metric units (e.g.
    # queue items one replica absorbs within the latency objective);
    # 0/None falls back to each metric's own HPA target value
    target_value: Optional[float] = None
    # $/hour penalty at full violation risk: the exchange rate between
    # the two objectives — 0 keeps decisions cost-visible (gauges) but
    # never moves them
    violation_cost_weight: float = 0.0
    # hard budget: candidates above floor(maxHourlyCost / unitCost)
    # replicas are trimmed (never below minReplicas); 0 = uncapped
    max_hourly_cost: float = 0.0
    # OPTIONAL per-metric targets, positional against spec.metrics:
    # entry j overrides targetValue for metric j (worst-case risk
    # across metrics still feeds the kernel). Shorter lists leave the
    # remaining metrics on the spec-wide fallback chain.
    metrics: Optional[List[SLOMetricTarget]] = None

    def target_for(self, metric_index: int) -> Optional[float]:
        """The per-replica SLO capacity for one metric: its per-metric
        entry when declared, else the spec-wide targetValue, else None
        (the engine then falls back to the metric's own HPA target)."""
        if self.metrics is not None and metric_index < len(self.metrics):
            per_metric = self.metrics[metric_index].target_value
            if per_metric is not None:
                return per_metric
        return self.target_value

    def validate(self) -> None:
        if self.target_value is not None and self.target_value <= 0:
            raise ValueError(
                f"slo targetValue must be > 0, got {self.target_value}"
            )
        if self.violation_cost_weight < 0:
            raise ValueError(
                "slo violationCostWeight must be >= 0, got "
                f"{self.violation_cost_weight}"
            )
        if self.max_hourly_cost < 0:
            raise ValueError(
                f"slo maxHourlyCost must be >= 0, got "
                f"{self.max_hourly_cost}"
            )
        for entry in self.metrics or []:
            entry.validate()


@dataclass(slots=True)
class Behavior:
    scale_up: Optional[ScalingRules] = None
    scale_down: Optional[ScalingRules] = None
    # opt-in predictive scaling (docs/forecasting.md)
    forecast: Optional[ForecastSpec] = None
    # opt-in cost- and SLO-aware refinement (docs/cost.md)
    slo: Optional[SLOSpec] = None

    def validate(self) -> None:
        for rules in (self.scale_up, self.scale_down):
            if rules is None:
                continue
            if rules.stabilization_window_seconds is not None and not (
                0 <= rules.stabilization_window_seconds <= 3600
            ):
                raise ValueError(
                    "stabilizationWindowSeconds must be in [0, 3600], "
                    f"got {rules.stabilization_window_seconds}"
                )
            for policy in rules.policies or []:
                policy.validate()
        for sub in (self.forecast, self.slo):
            if sub is not None:
                sub.validate()

    def scale_up_rules(self) -> ScalingRules:
        """Defaults: no stabilization, Max select (reference:
        horizontalautoscaler.go:249-256)."""
        rules = ScalingRules(
            stabilization_window_seconds=0, select_policy=MAX_POLICY_SELECT
        )
        return merge_into(rules, self.scale_up)

    def scale_down_rules(self) -> ScalingRules:
        """Defaults: 300s stabilization, Max select (reference:
        horizontalautoscaler.go:258-265)."""
        rules = ScalingRules(
            stabilization_window_seconds=300, select_policy=MAX_POLICY_SELECT
        )
        return merge_into(rules, self.scale_down)

    def get_scaling_rules(
        self, replicas: int, recommendations: List[int]
    ) -> ScalingRules:
        """Pick up/down/disabled rules from the recommendation direction
        (reference: horizontalautoscaler.go:240-247)."""
        if any(r > replicas for r in recommendations):
            return self.scale_up_rules()
        if any(r < replicas for r in recommendations):
            return self.scale_down_rules()
        return ScalingRules(select_policy=DISABLED_POLICY_SELECT)

    def apply_select_policy(self, replicas: int, recommendations: List[int]) -> int:
        """reference: horizontalautoscaler.go:226-238"""
        policy = self.get_scaling_rules(replicas, recommendations).select_policy
        if policy == MAX_POLICY_SELECT:
            return max(recommendations)
        if policy == MIN_POLICY_SELECT:
            return min(recommendations)
        if policy != DISABLED_POLICY_SELECT:
            # unknown policy: log loudly but keep current replicas, matching
            # the reference's non-fatal handling (horizontalautoscaler.go:236-237)
            logger().error("unknown select policy: %s", policy)
        return replicas


@dataclass(slots=True)
class MetricValueStatus:
    value: Optional[float] = None
    average_value: Optional[float] = None
    average_utilization: Optional[int] = None


@dataclass(slots=True)
class PrometheusMetricStatus:
    query: str = ""
    current: MetricValueStatus = field(default_factory=MetricValueStatus)


@dataclass(slots=True)
class MetricStatus:
    prometheus: Optional[PrometheusMetricStatus] = None


@dataclass(slots=True)
class HorizontalAutoscalerSpec:
    scale_target_ref: CrossVersionObjectReference = field(
        default_factory=CrossVersionObjectReference
    )
    min_replicas: int = 0
    max_replicas: int = 0
    metrics: List[Metric] = field(default_factory=list)
    behavior: Behavior = field(default_factory=Behavior)


@dataclass(slots=True)
class HorizontalAutoscalerStatus:
    last_scale_time: Optional[float] = None
    current_replicas: Optional[int] = None
    desired_replicas: Optional[int] = None
    current_metrics: List[MetricStatus] = field(default_factory=list)
    conditions: List[Condition] = field(default_factory=list)


# Pluggable validation hooks (same pattern as the queue-validator registry,
# api/metricsproducer.py): upper layers register checks the API layer cannot
# know about — e.g. the autoscaler's algorithm registry validates the
# `autoscaling.karpenter.sh/algorithm` annotation at admission. Keeps the
# api package dependency-free.
_validation_hooks = []


def register_validation_hook(hook) -> None:
    """hook(ha) raises ValueError to reject the object at admission."""
    _validation_hooks.append(hook)


@dataclass(slots=True)
class HorizontalAutoscaler:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: HorizontalAutoscalerSpec = field(default_factory=HorizontalAutoscalerSpec)
    status: HorizontalAutoscalerStatus = field(
        default_factory=HorizontalAutoscalerStatus
    )

    KIND = "HorizontalAutoscaler"

    def status_conditions(self) -> ConditionManager:
        return ConditionManager(
            [ACTIVE, ABLE_TO_SCALE, SCALING_UNBOUNDED], self.status.conditions
        )

    def validate(self) -> None:
        for hook in _validation_hooks:
            hook(self)
        if self.spec.max_replicas < self.spec.min_replicas:
            raise ValueError(
                "maxReplicas cannot be less than minReplicas "
                f"({self.spec.max_replicas} < {self.spec.min_replicas})"
            )
        self.spec.behavior.validate()

    def default(self) -> None:
        """reference: horizontalautoscaler_defaults.go (no-op)."""
