"""ScalableNodeGroup resource: scale-subresource shim over cloud node groups.

reference: pkg/apis/autoscaling/v1alpha1/scalablenodegroup.go:24-66,
scalablenodegroup_status.go:21-63, scalablenodegroup_validation.go:39-56.

The port's copy of karpenter_tpu/api/scalablenodegroup.py, changed only
in its imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from karpenter_tpu_torch.api.conditions import (
    ABLE_TO_SCALE,
    ACTIVE,
    STABILIZED,
    Condition,
    ConditionManager,
)
from karpenter_tpu_torch.api.core import ObjectMeta

# Provider node-group types. AWS types kept for spec parity with the
# reference; the TPU-native deployment uses the tpu pod-slice pool type.
AWS_EC2_AUTO_SCALING_GROUP = "AWSEC2AutoScalingGroup"
AWS_EKS_NODE_GROUP = "AWSEKSNodeGroup"
TPU_POD_SLICE_POOL = "TPUPodSlicePool"
FAKE_NODE_GROUP = "FakeNodeGroup"


@dataclass(slots=True)
class WarmPoolSpec:
    """Pre-provisioned headroom (docs/cost.md "Warm pools"): the group
    keeps `warm` spare nodes on top of its desired replicas — sized each
    reconcile between [minWarm, maxWarm] by the cost subsystem's
    forecast-risk headroom signal (minWarm with no signal) — so a demand
    rise lands on capacity that already exists instead of waiting out
    the provider's provisioning latency (the BLITZSCALE lead-time
    attack; the reduction is measured by `--simulate --cost` against the
    karpenter_reconcile_e2e_seconds story). The warm target actuates
    through the ordinary ScalableNodeGroup controller door — fenced,
    journaled, breaker-guarded — never a side channel."""

    min_warm: int = 0
    max_warm: int = 0

    def validate(self) -> None:
        if self.min_warm < 0:
            raise ValueError(
                f"warmPool minWarm must be >= 0, got {self.min_warm}"
            )
        if self.max_warm < self.min_warm:
            raise ValueError(
                "warmPool maxWarm cannot be less than minWarm "
                f"({self.max_warm} < {self.min_warm})"
            )


@dataclass(slots=True)
class ScalableNodeGroupSpec:
    replicas: Optional[int] = None
    type: str = ""
    id: str = ""
    # capacity tier: True marks the whole group preemptible/spot —
    # its pods are evictable-by-contract to the eviction planner
    # (docs/preemption.md), independent of the per-node capacity-type
    # labels the packing tier is derived from (api/core.capacity_tier_of)
    preemptible: bool = False
    # PDB-style disruption budget: max CONCURRENT preemption evictions
    # charged against this group's nodes in one HOLD window (the
    # engine's hold_s, 120s — charges expire with the hold, not the
    # 30s plan cadence); None = the engine-level --preempt-budget
    # default
    eviction_budget: Optional[int] = None
    # pre-provisioned warm headroom (docs/cost.md "Warm pools"); None =
    # no warm pool, byte-identical to the pre-cost controller behavior
    warm_pool: Optional[WarmPoolSpec] = None


@dataclass(slots=True)
class ScalableNodeGroupStatus:
    replicas: Optional[int] = None
    conditions: List[Condition] = field(default_factory=list)


@dataclass(slots=True)
class ScalableNodeGroup:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ScalableNodeGroupSpec = field(default_factory=ScalableNodeGroupSpec)
    status: ScalableNodeGroupStatus = field(default_factory=ScalableNodeGroupStatus)

    KIND = "ScalableNodeGroup"

    def status_conditions(self) -> ConditionManager:
        return ConditionManager(
            [ACTIVE, ABLE_TO_SCALE, STABILIZED], self.status.conditions
        )

    def validate(self) -> None:
        if self.spec.warm_pool is not None:
            self.spec.warm_pool.validate()
        validator = _validators.get(self.spec.type)
        if validator is None:
            raise ValueError(f"Unexpected type {self.spec.type}")
        validator(self.spec)

    def default(self) -> None:
        pass


# Pluggable per-provider validators
# (reference: scalablenodegroup_validation.go:39-56)
_validators = {}


def register_scalable_node_group_validator(node_group_type: str, validator) -> None:
    _validators[node_group_type] = validator
