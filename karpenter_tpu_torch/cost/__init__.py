"""Cost- and SLO-aware scaling subsystem (docs/cost.md).

Three pieces, composed by the runtime:

  * CostModel (cost/model.py) — per-instance-type hourly pricing with
    spot-tier composition and annotation overrides; `group_costs` is
    the columnar encoder face, `unit_cost` the decide face.
  * CostEngine (cost/engine.py) — the per-tick batched multi-objective
    refinement of the fleet decide (ops/cost.py kernel through the
    SolverService.cost seam), never-block, zero-overhead when no HA
    carries spec.behavior.slo.
  * WarmPoolEngine (cost/warmpool.py) — forecast-risk-sized
    pre-provisioned headroom for spec.warmPool groups, actuated through
    the ScalableNodeGroup controller's fenced door.
  * PricingSource (cost/pricing.py) — pluggable pricing feeds: the
    mtime-reloading --pricing-file feed (and per-tenant feeds via the
    tenant registry) consulted before the built-in catalog.

The port's copy of karpenter_tpu/cost/__init__.py, changed only in its
imports.
"""

from karpenter_tpu_torch.cost.engine import CostEngine
from karpenter_tpu_torch.cost.model import (
    DEFAULT_CATALOG,
    HOURLY_COST_ANNOTATION,
    INSTANCE_TYPE_ANNOTATION,
    INSTANCE_TYPE_LABEL,
    CostModel,
)
from karpenter_tpu_torch.cost.pricing import (
    FilePricingSource,
    PricingSource,
    StaticPricingSource,
    pricing_source_for,
)
from karpenter_tpu_torch.cost.warmpool import WarmPoolEngine

__all__ = [
    "CostEngine",
    "CostModel",
    "DEFAULT_CATALOG",
    "FilePricingSource",
    "HOURLY_COST_ANNOTATION",
    "INSTANCE_TYPE_ANNOTATION",
    "INSTANCE_TYPE_LABEL",
    "PricingSource",
    "StaticPricingSource",
    "WarmPoolEngine",
    "pricing_source_for",
]
