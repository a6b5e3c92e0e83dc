"""PoolGroup resource: coordinated scaling across interdependent pools.

The upstream plane, and the cost ladder alone, scale each HorizontalAutoscaler
in isolation. Disaggregated serving workloads — prefill vs decode pools,
router vs worker — are coupled: each pool's useful capacity depends on
its siblings', and per-pool loops oscillate and strand capacity ("Taming
the Chaos", PAPERS.md). A PoolGroup names member HorizontalAutoscalers
and the coupling between them:

- cross-pool ratio bands as EXACT integer ratios (decode:prefill between
  2:1 and 4:1) — integers because the joint kernel enforces them by
  int32 cross-multiplication, bit-identical on device and host
- a shared hourly budget across the whole group
- per-pool bound tightening and capacity-tier preferences (a spot-heavy
  pool can be made cheaper-on-paper via tierPenalty on its siblings)

The joint allocation itself is ops/poolgroup.py (one batched device
dispatch for every group in the fleet); this module is only the
declarative face plus admission validation. The reference has no such
surface at all.

The port's copy of karpenter_tpu/api/poolgroup.py, changed only in its
imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from karpenter_tpu_torch.api.conditions import ACTIVE, Condition, ConditionManager
from karpenter_tpu_torch.api.core import ObjectMeta

# Mirrors of the kernel's static limits (ops/poolgroup.py MAX_POOLS /
# RATIO_SLOTS / RATIO_BOUND — asserted equal at engine import so they
# cannot drift; duplicated because the api package must not import jax).
MAX_POOLS = 4
RATIO_SLOTS = 4
RATIO_BOUND = 1024


@dataclass(slots=True)
class PoolMember:
    """One member pool: a HorizontalAutoscaler in the group's namespace.

    minReplicas/maxReplicas optionally TIGHTEN the member HA's own
    bounds for joint allocation (they can never widen them); tierPenalty
    is a $/hour-per-replica score penalty folded into the joint
    objective — it steers the allocator toward preferred capacity tiers
    without touching the real-dollar budget math."""

    name: str = ""
    # freeform role label ratios may reference instead of the name
    # (e.g. "prefill", "decode") — purely descriptive aliasing
    role: str = ""
    min_replicas: Optional[int] = None
    max_replicas: Optional[int] = None
    tier_penalty: float = 0.0

    def validate(self) -> None:
        if not self.name:
            raise ValueError("pool member name must be set")
        if self.tier_penalty < 0:
            raise ValueError(
                f"pool {self.name!r} tierPenalty must be >= 0, got "
                f"{self.tier_penalty}"
            )
        if self.min_replicas is not None and self.min_replicas < 0:
            raise ValueError(
                f"pool {self.name!r} minReplicas must be >= 0, got "
                f"{self.min_replicas}"
            )
        if (
            self.min_replicas is not None
            and self.max_replicas is not None
            and self.max_replicas < self.min_replicas
        ):
            raise ValueError(
                f"pool {self.name!r} maxReplicas cannot be less than "
                f"minReplicas ({self.max_replicas} < {self.min_replicas})"
            )


@dataclass(slots=True)
class RatioConstraint:
    """numerator:denominator must stay inside the declared band:

        minNumerator/minDenominator <= num/den <= maxNumerator/maxDenominator

    minNumerator=0 disables the lower bound; maxNumerator=0 (with
    maxDenominator=0) disables the upper. Integers are capped at 1024 so
    the kernel's int32 cross products can never overflow."""

    numerator: str = ""  # member pool name or role
    denominator: str = ""
    min_numerator: int = 0
    min_denominator: int = 1
    max_numerator: int = 0
    max_denominator: int = 0

    def validate(self, pool_keys) -> None:
        for side in (self.numerator, self.denominator):
            if side not in pool_keys:
                raise ValueError(
                    f"ratio references unknown pool {side!r} "
                    f"(declared: {sorted(pool_keys)})"
                )
        if self.numerator == self.denominator:
            raise ValueError(
                f"ratio numerator and denominator must differ, both are "
                f"{self.numerator!r}"
            )
        for name in (
            "min_numerator",
            "min_denominator",
            "max_numerator",
            "max_denominator",
        ):
            v = getattr(self, name)
            if not 0 <= v <= RATIO_BOUND:
                raise ValueError(
                    f"ratio {name} must be in [0, {RATIO_BOUND}], got {v}"
                )
        if self.min_numerator > 0 and self.min_denominator < 1:
            raise ValueError(
                "ratio minDenominator must be >= 1 when minNumerator is set"
            )
        upper = self.max_numerator > 0
        if upper and self.max_denominator < 1:
            raise ValueError(
                "ratio maxDenominator must be >= 1 when maxNumerator is set"
            )
        if (
            upper
            and self.min_numerator > 0
            and self.min_numerator * self.max_denominator
            > self.max_numerator * self.min_denominator
        ):
            raise ValueError(
                "ratio band is empty: "
                f"{self.min_numerator}:{self.min_denominator} > "
                f"{self.max_numerator}:{self.max_denominator}"
            )


@dataclass(slots=True)
class PoolGroupSpec:
    pools: List[PoolMember] = field(default_factory=list)
    ratios: List[RatioConstraint] = field(default_factory=list)
    # shared budget across all member pools, $/hour; 0 = uncapped
    max_hourly_cost: float = 0.0


@dataclass(slots=True)
class PoolGroupStatus:
    # joint point satisfied every declared constraint last tick (False
    # while the solver serves the degraded independent ladder, or when
    # even the repair selection cannot reach the band this tick)
    coordinated: Optional[bool] = None
    # summed pool spend at the selected joint point, $/hour
    expected_hourly: Optional[float] = None
    conditions: List[Condition] = field(default_factory=list)


@dataclass(slots=True)
class PoolGroup:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PoolGroupSpec = field(default_factory=PoolGroupSpec)
    status: PoolGroupStatus = field(default_factory=PoolGroupStatus)

    KIND = "PoolGroup"

    def status_conditions(self) -> ConditionManager:
        return ConditionManager([ACTIVE], self.status.conditions)

    def validate(self) -> None:
        pools = self.spec.pools
        if not 2 <= len(pools) <= MAX_POOLS:
            raise ValueError(
                f"a PoolGroup needs 2..{MAX_POOLS} pools, got {len(pools)}"
            )
        names = [p.name for p in pools]
        if len(set(names)) != len(names):
            raise ValueError(f"pool names must be unique, got {names}")
        keys = set(names) | {p.role for p in pools if p.role}
        roles = [p.role for p in pools if p.role]
        if len(set(roles)) != len(roles):
            raise ValueError(f"pool roles must be unique, got {roles}")
        for pool in pools:
            pool.validate()
        if len(self.spec.ratios) > RATIO_SLOTS:
            raise ValueError(
                f"a PoolGroup supports at most {RATIO_SLOTS} ratio "
                f"constraints, got {len(self.spec.ratios)}"
            )
        for ratio in self.spec.ratios:
            ratio.validate(keys)
        if self.spec.max_hourly_cost < 0:
            raise ValueError(
                f"maxHourlyCost must be >= 0, got {self.spec.max_hourly_cost}"
            )

    def default(self) -> None:
        pass

    def member_index(self, key: str) -> int:
        """Position of the pool a ratio side references (name or role)."""
        for i, pool in enumerate(self.spec.pools):
            if pool.name == key or (pool.role and pool.role == key):
                return i
        raise KeyError(key)
