"""Multi-tenant control plane (docs/multitenancy.md).

One solver service, thousands of tenant clusters:

  * TenantRegistry (tenancy/registry.py) — namespaces the full
    per-cluster stack (store, forecaster history, cost model/engine
    with per-tenant pricing feeds, warm-pool state, journal/fence
    dirs, gauge label sets) under a tenant id; per-tenant
    karpenter_tenant_* series retire with the tenant.
  * MultiTenantScheduler (tenancy/scheduler.py) — concatenates
    cross-tenant decide/cost/forecast matrices into single device
    programs (bit-identical per-tenant slices) and rides the existing
    coalescing queue for cross-tenant bin-packs.
  * WeightedAdmission (tenancy/fairness.py) — deficit-weighted
    round-robin row budgets so a noisy tenant cannot starve the queue.
  * TenantBreakerBoard (tenancy/isolation.py) — per-tenant breakers:
    a tripped tenant serves from its numpy mirror alone while healthy
    tenants stay on device.

The port's copy of karpenter_tpu/tenancy. On the card no tenant is
served from a numpy mirror: a tripped tenant takes its own device
dispatch (the card rule, tenancy/scheduler.py).
"""

from karpenter_tpu_torch.tenancy.fairness import WeightedAdmission
from karpenter_tpu_torch.tenancy.isolation import TenantBreakerBoard
from karpenter_tpu_torch.tenancy.registry import (
    TenantContext,
    TenantMetrics,
    TenantRegistry,
    TenantSpec,
    load_tenant_config,
)
from karpenter_tpu_torch.tenancy.scheduler import (
    MultiTenantScheduler,
    TenancyStatistics,
    concat_cost_inputs,
    concat_decision_inputs,
    slice_cost_outputs,
    slice_decision_outputs,
)

__all__ = [
    "MultiTenantScheduler",
    "TenancyStatistics",
    "TenantBreakerBoard",
    "TenantContext",
    "TenantMetrics",
    "TenantRegistry",
    "TenantSpec",
    "WeightedAdmission",
    "concat_cost_inputs",
    "concat_decision_inputs",
    "load_tenant_config",
    "slice_cost_outputs",
    "slice_decision_outputs",
]
