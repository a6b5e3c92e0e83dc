"""Instance-type cost model: per-group hourly cost as columnar data.

The reference (and every layer of this repo before the cost subsystem)
is cost-blind. This module is the pricing half of docs/cost.md: a small
built-in on-demand catalog keyed by the standard
`node.kubernetes.io/instance-type` label, a spot/preemptible tier
multiplier composing with the SAME capacity-tier labels the packing
kernels steer on (api/core.capacity_tier_of, the group_tier column), and
two explicit override annotations for fleets whose pricing the catalog
cannot know:

  cost.karpenter.sh/hourly-cost     exact per-node $/hour (wins)
  cost.karpenter.sh/instance-type   catalog key when the label is absent
                                    (ScalableNodeGroups carry no node
                                    labels)

`group_costs` is the encoder face: one vectorized pass over the
pendingCapacity group profiles produces the fleet's per-group cost
column (f32[G]), which the simulate report prices scale-up signals with;
`unit_cost` is the decide face, pricing a HorizontalAutoscaler's scale
target for the multi-objective kernel (ops/cost.py).

Prices are illustrative defaults, not billing data — the contract is
RELATIVE cost (spot < on-demand, big nodes > small nodes) driving the
multi-objective trade; operators with real prices override per group.

The port's copy of karpenter_tpu/cost/model.py, changed only in its
imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from karpenter_tpu_torch.api.core import capacity_tier_of

HOURLY_COST_ANNOTATION = "cost.karpenter.sh/hourly-cost"
INSTANCE_TYPE_ANNOTATION = "cost.karpenter.sh/instance-type"
INSTANCE_TYPE_LABEL = "node.kubernetes.io/instance-type"

# Representative on-demand $/hour anchors — enough catalog to make the
# relative trade real across the provider families this repo models
# (AWS ASG/EKS, GKE/TPU pools); unlisted types price at default_hourly.
DEFAULT_CATALOG: Dict[str, float] = {
    # general-purpose x86
    "m5.large": 0.096, "m5.xlarge": 0.192, "m5.2xlarge": 0.384,
    "n2-standard-4": 0.194, "n2-standard-8": 0.389,
    "e2-standard-4": 0.134,
    # accelerator hosts (per-host, pod-slice pools scale by topology)
    "ct5lp-hightpu-4t": 4.80,  # v5e-4 host
    "ct5lp-hightpu-8t": 9.60,  # v5e-8 host
    "p3.2xlarge": 3.06,
    "g5.xlarge": 1.006,
}


@dataclass
class CostModel:
    """Pricing policy (module docstring). One per runtime (or per
    tenant — tenancy/registry.py); the simulate replays mutate
    `spot_multiplier` mid-run to model a spot-price step."""

    catalog: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_CATALOG)
    )
    # price for a node whose type the catalog doesn't know — nonzero so
    # cost stays a live objective on label-less test/dev fleets
    default_hourly: float = 1.0
    # spot/preemptible tier price as a fraction of on-demand (the
    # historical ~65% discount); composes with capacity_tier_of
    spot_multiplier: float = 0.35
    # pluggable feed (cost/pricing.py, --pricing-file): consulted
    # BEFORE the built-in catalog, and its spotMultiplier (when the
    # feed carries one) outranks the knob above. None = catalog only.
    pricing: Optional[object] = None

    def on_demand(self, instance_type: Optional[str]) -> float:
        if instance_type:
            if self.pricing is not None:
                price = self.pricing.price(instance_type)
                if price is not None:
                    return float(price)
            price = self.catalog.get(instance_type)
            if price is not None:
                return float(price)
        return float(self.default_hourly)

    def effective_spot_multiplier(self) -> float:
        """The spot tier in force: the pricing feed's override when it
        carries one, else the configured knob."""
        if self.pricing is not None:
            override = self.pricing.spot_multiplier()
            if override is not None:
                return float(override)
        return float(self.spot_multiplier)

    def node_cost(self, labels) -> float:
        """Hourly cost of one node from its label set (the group-profile
        face): catalog price by instance-type label, spot tier applied
        by the same capacity-tier labels the packing kernels read."""
        get = labels.get if isinstance(labels, dict) else dict(labels).get
        price = self.on_demand(get(INSTANCE_TYPE_LABEL))
        if capacity_tier_of(labels) > 0:
            price *= self.effective_spot_multiplier()
        return price

    def group_costs(self, profiles) -> np.ndarray:
        """Columnar per-group hourly node cost, f32[G], aligned with the
        encoder's group axis (profiles are the (allocatable, labels,
        taints) triples every solve path already carries)."""
        return np.asarray(
            [self.node_cost(labels) for _alloc, labels, _t in profiles],
            np.float32,
        )

    def unit_cost(self, resource) -> float:
        """Hourly cost per replica of a scale target (the decide face).
        Annotation override wins; then the catalog via the
        instance-type annotation; spot tier from spec.preemptible OR
        spot-labeled metadata (ScalableNodeGroup carries the tier as
        spec, nodes as labels — both price the same)."""
        if resource is None:
            return float(self.default_hourly)
        meta = getattr(resource, "metadata", None)
        annotations = dict(getattr(meta, "annotations", None) or {})
        override = annotations.get(HOURLY_COST_ANNOTATION)
        if override is not None:
            try:
                return max(0.0, float(override))
            except ValueError:
                pass  # unparseable override: fall through to the catalog
        price = self.on_demand(annotations.get(INSTANCE_TYPE_ANNOTATION))
        spec = getattr(resource, "spec", None)
        preemptible = bool(getattr(spec, "preemptible", False))
        labels = dict(getattr(meta, "labels", None) or {})
        if preemptible or capacity_tier_of(labels) > 0:
            price *= self.effective_spot_multiplier()
        return price
