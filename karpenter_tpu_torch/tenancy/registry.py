"""TenantRegistry: one control plane, thousands of namespaced clusters.

Every subsystem in this repo was built for ONE cluster per process: one
store, one forecaster history, one cost model, one journal dir, one
gauge label set. The registry is the multiplexing layer that namespaces
that full stack under a tenant id (docs/multitenancy.md):

  * STACK — each tenant gets its own Store, FleetForecaster (history +
    skill EWMAs), CostModel (optionally fed by a per-tenant pricing
    file — cost/pricing.py), CostEngine, and WarmPoolEngine. All of
    them ride the ONE shared SolverService, which is the whole point:
    the expensive resource (device dispatch) is shared, the state is
    not.
  * FENCING — with a journal dir configured, each tenant's crash-safe
    state lives in its own `tenants/<id>/` subdirectory: fence
    generations, journals, and checkpoints are claimed and replayed
    PER TENANT, so one tenant's restart storm (or a stale incarnation
    of it) cannot fence or corrupt another's actuation
    (recovery/fence.py generalized along the tenant axis).
  * METRICS — per-tenant `karpenter_tenant_*` series labeled
    {name=<tenant id>} in the shared registry, RETIRED when the tenant
    is removed (the frozen-series discipline every per-object gauge
    family in this repo follows). The scheduler (tenancy/scheduler.py)
    publishes through the same TenantMetrics face.

Tenant ids are flat strings (cluster names); weights feed the
scheduler's fair-admission policy (tenancy/fairness.py).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

SUBSYSTEM = "tenant"


@dataclass(slots=True)
class TenantSpec:
    """Declarative tenant config (one entry of --tenant-config)."""

    id: str
    # fair-admission weight (tenancy/fairness.py): a tenant's long-run
    # share of the shared dispatch budget is weight / sum(weights)
    weight: float = 1.0
    # PoolGroup coalition id (tenancy/fairness.py): tenants declaring
    # the same id host member pools of one PoolGroup and are admitted
    # into the same batch round, so the joint allocator
    # (ops/poolgroup.py) never sees a partial group; None = ungrouped
    pool_group: Optional[str] = None
    # per-tenant pricing feed (cost/pricing.py): a JSON/YAML catalog
    # file reloaded on mtime change; None = the built-in catalog
    pricing_file: Optional[str] = None
    # per-tenant cost-model knobs (runtime Options analogs)
    cost_default_hourly: float = 1.0
    cost_spot_multiplier: float = 0.35
    # metric-history ring capacity for this tenant's forecaster
    forecast_history: int = 64

    def validate(self) -> None:
        if not self.id or "/" in self.id or self.id in (".", ".."):
            raise ValueError(
                f"tenant id must be a non-empty path-safe string, "
                f"got {self.id!r}"
            )
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.id}: weight must be > 0, got {self.weight}"
            )
        if self.forecast_history < 2:
            raise ValueError(
                f"tenant {self.id}: forecastHistory must be >= 2, got "
                f"{self.forecast_history}"
            )
        if self.pool_group is not None and not self.pool_group:
            raise ValueError(
                f"tenant {self.id}: poolGroup must be a non-empty id "
                f"or omitted"
            )


def load_tenant_config(path: str) -> List[TenantSpec]:
    """Parse --tenant-config: a JSON/YAML file holding either a bare
    list of tenant specs or {"tenants": [...]}. Ids must be unique."""
    from karpenter_tpu_torch.api.serialization import from_dict
    from karpenter_tpu_torch.utils.configfile import load_json_or_yaml

    doc = load_json_or_yaml(path)
    if isinstance(doc, dict):
        doc = doc.get("tenants", doc)
    if not isinstance(doc, list):
        raise ValueError(
            f"--tenant-config {path}: expected a LIST of tenant specs "
            f"(or {{'tenants': [...]}}), got {type(doc).__name__}"
        )
    specs = [from_dict(TenantSpec, entry) for entry in doc]
    seen = set()
    for spec in specs:
        spec.validate()
        if spec.id in seen:
            raise ValueError(
                f"--tenant-config {path}: duplicate tenant id {spec.id!r}"
            )
        seen.add(spec.id)
    return specs


class TenantMetrics:
    """The karpenter_tenant_* surface (module docstring): shared by the
    registry (membership) and the scheduler (traffic), so retirement on
    tenant deletion covers every family from one place."""

    def __init__(self, registry=None):
        self._per_tenant = []
        if registry is None:
            self.active = self.rounds = None
            self.weight = self.degraded = self.backlog = None
            self.decisions = self.dispatches = None
            self.mirror = self.fallback = None
            self.trips = self.deferrals = None
            return
        reg = registry.register
        # fleet-level
        self.active = reg(SUBSYSTEM, "active")
        self.rounds = reg(SUBSYSTEM, "admission_rounds")
        self.dispatches = reg(SUBSYSTEM, "dispatches_total", kind="counter")
        # per-tenant (name=<tenant id>, namespace="-"): retired on
        # tenant deletion via retire()
        self.weight = reg(SUBSYSTEM, "weight")
        self.degraded = reg(SUBSYSTEM, "degraded")
        self.backlog = reg(SUBSYSTEM, "backlog_rows")
        self.decisions = reg(SUBSYSTEM, "decisions_total", kind="counter")
        self.mirror = reg(
            SUBSYSTEM, "mirror_served_total", kind="counter"
        )
        # fallback ≠ mirror: a mirror serve is bit-identical device
        # math on host; a fallback serve is the synthesized never-block
        # floor (hold / cost-blind / invalid forecast) — dashboards
        # must be able to tell real answers from do-nothing ones
        self.fallback = reg(
            SUBSYSTEM, "fallback_served_total", kind="counter"
        )
        self.trips = reg(SUBSYSTEM, "breaker_trips_total", kind="counter")
        self.deferrals = reg(SUBSYSTEM, "deferrals_total", kind="counter")
        self._per_tenant = [
            self.weight, self.degraded, self.backlog, self.decisions,
            self.mirror, self.fallback, self.trips, self.deferrals,
        ]

    @property
    def enabled(self) -> bool:
        return self.active is not None

    def retire(self, tenant: str) -> None:
        """Drop every per-tenant series for a deleted tenant — a frozen
        karpenter_tenant_* value for a cluster that no longer exists
        would mislead dashboards exactly like the karpenter_cost_*
        frozen-series bug did (docs/cost.md)."""
        for vec in self._per_tenant:
            vec.remove(tenant, "-")


@dataclass
class TenantContext:
    """One tenant's namespaced stack (module docstring). Fields are
    built by TenantRegistry; engines share the process SolverService."""

    spec: TenantSpec
    store: object = None
    forecaster: object = None
    cost_model: object = None
    cost_engine: object = None
    warmpool: object = None
    journal_dir: Optional[str] = None
    _recovery: object = field(default=None, repr=False)

    @property
    def id(self) -> str:
        return self.spec.id

    def recovery(self):
        """The tenant's own RecoveryManager, built lazily over its
        namespaced journal dir (None without one): per-tenant fence
        generations and crash-safe journals, independent of every
        other tenant's (module docstring FENCING)."""
        if self._recovery is None and self.journal_dir:
            from karpenter_tpu_torch.recovery import RecoveryManager

            self._recovery = RecoveryManager(self.journal_dir)
        return self._recovery

    def close(self) -> None:
        if self._recovery is not None:
            self._recovery.close()
            self._recovery = None


class TenantRegistry:
    """Tenant membership + per-tenant stack construction (module
    docstring). `service` is the shared SolverService every tenant's
    engines dispatch through; `registry` the shared GaugeRegistry;
    `journal_dir` the root under which per-tenant fencing/journal
    subdirectories are created."""

    def __init__(
        self,
        service=None,
        registry=None,
        journal_dir: Optional[str] = None,
        clock: Optional[Callable[[], float]] = None,
        specs: Optional[List[TenantSpec]] = None,
    ):
        import time as _time

        self.service = service
        self.metrics_registry = registry
        self.journal_dir = journal_dir
        self.clock = clock or _time.time
        self.metrics = TenantMetrics(registry)
        self._tenants: Dict[str, TenantContext] = {}
        self._lock = threading.Lock()
        # deletion listeners (the scheduler registers one so breakers,
        # admission credit, and its own stats forget the tenant too)
        self._on_removed: List[Callable[[str], None]] = []
        for spec in specs or []:
            self.add(spec)

    def on_removed(self, hook: Callable[[str], None]) -> None:
        self._on_removed.append(hook)

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def __contains__(self, tenant: str) -> bool:
        with self._lock:
            return tenant in self._tenants

    def __len__(self) -> int:
        with self._lock:
            return len(self._tenants)

    def weight(self, tenant: str) -> float:
        with self._lock:
            ctx = self._tenants.get(tenant)
        return ctx.spec.weight if ctx is not None else 1.0

    def weights(self) -> Dict[str, float]:
        with self._lock:
            return {t: c.spec.weight for t, c in self._tenants.items()}

    def pool_groups(self) -> Dict[str, str]:
        """Tenant -> PoolGroup coalition id, grouped tenants only: the
        admission policy coalesces these into indivisible rounds
        (tenancy/fairness.py module docstring)."""
        with self._lock:
            return {
                t: c.spec.pool_group
                for t, c in self._tenants.items()
                if c.spec.pool_group
            }

    def journal_dir_for(self, tenant: str) -> Optional[str]:
        """`<journal_dir>/tenants/<id>`, created on first ask — the
        per-tenant fencing namespace (module docstring)."""
        if not self.journal_dir:
            return None
        path = os.path.join(self.journal_dir, "tenants", tenant)
        os.makedirs(path, exist_ok=True)
        return path

    def get(self, tenant: str) -> Optional[TenantContext]:
        with self._lock:
            return self._tenants.get(tenant)

    def get_or_create(self, tenant: str) -> TenantContext:
        ctx = self.get(tenant)
        if ctx is not None:
            return ctx
        return self.add(TenantSpec(id=tenant))

    def add(self, spec: TenantSpec) -> TenantContext:
        """Build and register one tenant's stack. Idempotent on id (the
        existing context wins — live state must not be silently
        rebuilt); publishes the membership gauges."""
        spec.validate()
        with self._lock:
            existing = self._tenants.get(spec.id)
            if existing is not None:
                return existing
        ctx = self._build(spec)
        discarded = None
        with self._lock:
            # re-check under the lock: two concurrent get_or_create
            # calls may both have built — the FIRST registration wins
            # (live state must never be silently replaced) and the
            # loser's freshly built, never-used stack is discarded
            existing = self._tenants.get(spec.id)
            if existing is not None:
                discarded, ctx = ctx, existing
            else:
                self._tenants[spec.id] = ctx
            n = len(self._tenants)
        if discarded is not None:
            discarded.close()
            return ctx
        if self.metrics.enabled:
            self.metrics.active.set("-", "-", float(n))
            self.metrics.weight.set(spec.id, "-", float(spec.weight))
            self.metrics.degraded.set(spec.id, "-", 0.0)
        return ctx

    def remove(self, tenant: str) -> None:
        """Delete a tenant: close its stack, retire every per-tenant
        gauge series, and notify listeners (scheduler breakers and
        admission credit forget it too)."""
        with self._lock:
            ctx = self._tenants.pop(tenant, None)
            n = len(self._tenants)
        if ctx is None:
            return
        ctx.close()
        if self.metrics.enabled:
            self.metrics.active.set("-", "-", float(n))
            self.metrics.retire(tenant)
        for hook in self._on_removed:
            hook(tenant)

    def close(self) -> None:
        for tenant in self.tenants():
            self.remove(tenant)

    # -- stack construction ------------------------------------------------

    def _build(self, spec: TenantSpec) -> TenantContext:
        from karpenter_tpu_torch.cost import CostEngine, CostModel, WarmPoolEngine
        from karpenter_tpu_torch.cost.pricing import pricing_source_for
        from karpenter_tpu_torch.forecast import FleetForecaster
        from karpenter_tpu_torch.store import Store

        store = Store()
        forecast_fn = (
            self.service.forecast if self.service is not None else None
        )
        cost_fn = self.service.cost if self.service is not None else None
        forecaster = FleetForecaster(
            forecast_fn=forecast_fn,
            clock=self.clock,
            capacity=spec.forecast_history,
        )
        cost_model = CostModel(
            default_hourly=spec.cost_default_hourly,
            spot_multiplier=spec.cost_spot_multiplier,
            pricing=pricing_source_for(spec.pricing_file),
        )
        cost_engine = CostEngine(
            store=store,
            cost_fn=cost_fn,
            model=cost_model,
            forecaster=forecaster,
        )
        warmpool = WarmPoolEngine(headroom_source=cost_engine.headroom)
        return TenantContext(
            spec=spec,
            store=store,
            forecaster=forecaster,
            cost_model=cost_model,
            cost_engine=cost_engine,
            warmpool=warmpool,
            journal_dir=self.journal_dir_for(spec.id),
        )
