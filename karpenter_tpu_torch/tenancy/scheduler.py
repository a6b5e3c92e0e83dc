"""MultiTenantScheduler: cross-tenant batching over the one solve seam.

The coalescing queue (solver/service.py) already proved the core move
for one cluster: concurrent same-shape requests concatenate into ONE
device program and the per-request cost of a decision collapses. This
module adds the FLEET axis (docs/multitenancy.md): N tenant clusters'
per-tick matrices — decide, cost, forecast — are concatenated along
their row/series axis into single device programs, dispatched once, and
scattered back per tenant. Every kernel involved is row-independent
(ops/decision.py, ops/cost.py, forecast/models.py compute each row from
that row's operands only), so a tenant's slice of the concatenated
output is BIT-IDENTICAL to what its own independent dispatch would have
produced — the parity contract tests/test_tenancy.py pins on both the
device and numpy paths. Cross-tenant bin-packs need no new machinery at
all: `solve_all` submits every tenant's problem through the existing
coalescing queue, where same-bucket requests already ride one `lax.map`
dispatch.

Around the concatenation sit the two multi-tenant serving policies:

  * FAIRNESS (tenancy/fairness.py) — each concatenated dispatch admits
    tenants under a deficit-weighted round-robin row budget, so a noisy
    tenant's giant matrix becomes its own round instead of starving the
    queue; deferred tenants carry credit and converge to their weight
    share.
  * ISOLATION (tenancy/isolation.py) — per-tenant breakers: a tenant
    whose gather/dispatch keeps failing is tripped OUT of the shared
    batch and served from the family's bit-identical numpy mirror
    (cost_numpy / forecast_numpy / binpack_numpy) while healthy tenants
    stay on device; the decide family — the never-block kernel with no
    host mirror — degrades to an ISOLATED per-tenant dispatch instead.
    `tenancy.gather.<tenant id>` is the per-tenant fault-injection
    point (faults/registry.py; glob `tenancy.gather.*` hits them all).

Decide batches group by their `now` scalar: lockstep callers (the
simulator, the bench, a tick-driven runtime) share one epoch and ride
one program; callers at different epochs form separate groups rather
than perturbing each other's stabilization-window math.

Metrics ride the TenantMetrics face (tenancy/registry.py):
karpenter_tenant_* series per tenant, retired with the tenant.

The port's copy of karpenter_tpu/tenancy/scheduler.py. On the CPU
(a service whose numpy ladder is on) the isolation ladder is the
reference's, rung for rung. On the card the service never answers from
numpy, and neither does the scheduler (the card rule):

  * the mirror rung becomes an ISOLATED device dispatch of the tenant
    alone — its own service.solve / cost / forecast / fused_tick call,
    as the decide family already degrades in the reference — so
    `mirror_served` stays 0;
  * the breakers, probes, weighted deadlines and deferral counters
    behave as in the reference;
  * the never-block floor (decide_hold, cost_blind, forecast_invalid,
    fused_hold) may still answer do-nothing, never a host computation;
    the tenant's error is kept in `errors` (and counted in
    karpenter_tenant_fallback_served_total). A bin-pack has no
    do-nothing answer: a tenant whose isolated solve fails is left out
    of solve_all's results, its error in `errors`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.faults import inject
from karpenter_tpu_torch.ops import decision as D
from karpenter_tpu_torch.tenancy.fairness import WeightedAdmission
from karpenter_tpu_torch.tenancy.isolation import TenantBreakerBoard
from karpenter_tpu_torch.tenancy.registry import TenantRegistry
from karpenter_tpu_torch.utils.log import logger

# per-tenant fault-injection point prefix (module docstring)
GATHER_POINT = "tenancy.gather."

# row bucket for concatenated dispatches: tenant-count jitter moves
# along this ladder instead of recompiling per added tenant (the same
# reason the decide pass buckets its fleet — ops/decision.pad_to)
ROW_BUCKET = 64

# interned "row<i>" labels for ledger records (the tenant simulator's
# rows are synthetic autoscalers): strings are minted once per process,
# so a per-tick ledger batch allocates no new name objects
_ROW_NAMES: list = []


def _row_names(n: int) -> list:
    while len(_ROW_NAMES) < n:
        _ROW_NAMES.append(f"row{len(_ROW_NAMES)}")
    return _ROW_NAMES[:n]


@dataclass
class TenancyStatistics:
    """Plain-int mirror of the scheduler counters (tests and the bench
    read these; the registry carries the per-tenant series)."""

    deadline_escapes: int = 0  # deferred tenants served early (budget out)
    decide_calls: int = 0  # decide_all entries
    decide_rows: int = 0  # tenant rows decided (across all tenants)
    decide_dispatches: int = 0  # shared concatenated decide dispatches
    cost_calls: int = 0
    cost_rows: int = 0
    cost_dispatches: int = 0
    forecast_calls: int = 0
    forecast_series: int = 0
    forecast_dispatches: int = 0
    fused_calls: int = 0  # fused_tick_all entries (--fused-tick)
    fused_rows: int = 0  # tenant rows through the fused megakernel
    fused_dispatches: int = 0  # shared concatenated fused dispatches
    solve_calls: int = 0
    solve_requests: int = 0  # per-tenant bin-packs through the queue
    admission_rounds: int = 0  # rounds across all shared dispatches
    deferrals: int = 0  # tenant admissions pushed past round 1
    isolated_dispatches: int = 0  # per-tenant dispatches outside a batch
    mirror_served: int = 0  # tenant results served from a numpy mirror
    fallback_served: int = 0  # results synthesized by the never-block floor
    probes: int = 0  # isolated recovery attempts for open breakers
    tenant_failures: int = 0  # per-tenant gather/dispatch failures
    breaker_trips: int = 0
    breaker_recoveries: int = 0


class MultiTenantScheduler:
    """One per process (module docstring). `registry` owns tenant
    membership and the per-tenant stacks; `service` (defaulting to the
    registry's) is the shared SolverService every dispatch rides."""

    def __init__(
        self,
        registry: TenantRegistry,
        service=None,
        *,
        max_rows_per_round: int = 4096,
        breaker_threshold: int = 3,
        breaker_reset_s: float = 30.0,
        deadline_s: Optional[float] = None,
        clock=None,
    ):
        import time as _time

        self.registry = registry
        self.service = service if service is not None else registry.service
        if self.service is None:
            raise ValueError(
                "MultiTenantScheduler needs a SolverService (directly or "
                "via the tenant registry)"
            )
        clock = clock or _time.monotonic
        self._clock = clock
        # tenant-weighted solve deadlines (docs/multitenancy.md):
        # fairness bounds ROWS per round, not how long a deferred
        # tenant waits behind earlier rounds — deadline_s bounds that
        # latency. Each tenant's budget scales with its configured
        # weight (budget = deadline_s x weight / mean weight): a
        # heavyweight tenant is entitled to keep its device slot
        # through a long backlog, a lightweight one whose budget runs
        # out mid-schedule stops waiting and serves IMMEDIATELY from
        # the family's bit-identical mirror (or an isolated dispatch
        # for mirror-less families) — the answer is the same answer,
        # only the wait is bounded. None disables the bound (the
        # pre-deadline posture).
        self.deadline_s = deadline_s
        self.admission = WeightedAdmission(budget_rows=max_rows_per_round)
        self.breakers = TenantBreakerBoard(
            threshold=breaker_threshold, reset_s=breaker_reset_s,
            clock=clock,
        )
        self.stats = TenancyStatistics()
        self.metrics = registry.metrics
        registry.on_removed(self._forget)
        # per-family serve log: tenant -> {"rung", "round", "deferred"},
        # reset by decide_all/cost_all — feeds the provenance ledger's
        # tenancy slice (observability/provenance.py)
        self._serving: Dict[str, dict] = {}
        # the in-flight ledger batch spanning decide_all -> cost_all
        # (one tick's records commit once the cost pass has annotated
        # its slice; a decide-only tick commits on the next decide or
        # via flush_provenance). _ledger_owner pins the ledger that
        # STAGED the batch, so a default-ledger swap between ticks
        # (the bench/simulate save-restore pattern) cannot commit a
        # batch into a ledger that never staged it.
        self._ledger_batch = None
        self._ledger_owner = None
        self._ledger_slices: Dict[str, Tuple[int, int]] = {}
        # the error behind each tenant the last *_all call could not
        # serve (floor answers; solve_all's failed isolated dispatches)
        self.errors: Dict[str, BaseException] = {}
        self._last_error: Dict[str, BaseException] = {}

    def _forget(self, tenant: str) -> None:
        self.breakers.forget(tenant)
        self.admission.forget(tenant)
        self.errors.pop(tenant, None)
        self._last_error.pop(tenant, None)

    @property
    def card_rule(self) -> bool:
        """True when the shared service answers nothing from numpy (the
        card, or a host service held to the card's policy)."""
        return not getattr(self.service, "_numpy_ladder", True)

    def _mirror(self, fn):
        """The family's numpy mirror rung, or None under the card rule
        (the degraded tenant then takes an isolated device dispatch)."""
        return None if self.card_rule else fn

    # -- decide ------------------------------------------------------------

    def decide_all(self, batch: Dict[str, D.DecisionInputs]):
        """Concatenate every tenant's fleet DecisionInputs into shared
        dispatches (grouped by `now`, admitted fairly, isolated per
        tenant) and scatter DecisionOutputs back per tenant."""
        self.stats.decide_calls += 1
        self._serving = {}
        self.errors = {}
        self._ledger_begin(batch)
        results: Dict[str, D.DecisionOutputs] = {}
        by_now: Dict[float, Dict[str, D.DecisionInputs]] = {}
        for tenant, inputs in batch.items():
            by_now.setdefault(
                float(np.asarray(inputs.now)), {}
            )[tenant] = inputs
        for group in by_now.values():
            results.update(
                self._run_family(
                    group,
                    family="decide",
                    rows_of=lambda i: int(
                        np.asarray(i.spec_replicas).shape[0]
                    ),
                    concat=concat_decision_inputs,
                    dispatch=self.service.decide,
                    scatter=slice_decision_outputs,
                    isolated=self.service.decide,
                    mirror=None,  # no host mirror: isolate instead
                    fallback=decide_hold,
                )
            )
        self._ledger_after_decide(results)
        return results

    # -- cost --------------------------------------------------------------

    def cost_all(self, batch, backend: Optional[str] = None):
        """Concatenate every tenant's CostInputs into shared
        SolverService.cost dispatches; a degraded tenant serves from the
        bit-identical cost_numpy mirror alone."""
        from karpenter_tpu_torch.ops import cost as CK

        self.stats.cost_calls += 1
        self._serving = {}
        self.errors = {}

        def dispatch(inputs):
            return self.service.cost(inputs, backend=backend)

        results = self._run_family(
            batch,
            family="cost",
            rows_of=lambda i: int(np.asarray(i.base_desired).shape[0]),
            concat=concat_cost_inputs,
            dispatch=dispatch,
            scatter=slice_cost_outputs,
            isolated=dispatch,
            mirror=self._mirror(CK.cost_numpy),
            fallback=cost_blind,
        )
        self._ledger_after_cost(batch, results)
        return results

    # -- forecast ----------------------------------------------------------

    def forecast_all(self, batch, backend: Optional[str] = None):
        """Concatenate every tenant's ForecastInputs along the series
        axis (grouped by history-length bucket) into shared
        SolverService.forecast dispatches; a degraded tenant serves
        from the bit-identical forecast_numpy mirror alone."""
        from karpenter_tpu_torch.forecast import models as FM
        from karpenter_tpu_torch.solver.service import FORECAST_T_FLOOR
        from karpenter_tpu_torch.solver.bucketing import bucket_up

        self.stats.forecast_calls += 1
        self.errors = {}
        results = {}
        by_t: Dict[int, Dict[str, object]] = {}
        for tenant, inputs in batch.items():
            t_bucket = bucket_up(
                int(np.asarray(inputs.values).shape[1]), FORECAST_T_FLOOR
            )
            by_t.setdefault(t_bucket, {})[tenant] = inputs

        def dispatch(inputs):
            return self.service.forecast(inputs, backend=backend)

        for t_bucket, group in by_t.items():
            padded = {
                tenant: FM.pad_forecast_inputs(inputs, t_bucket)
                for tenant, inputs in group.items()
            }
            results.update(
                self._run_family(
                    padded,
                    family="forecast",
                    rows_of=lambda i: int(np.asarray(i.values).shape[0]),
                    concat=concat_forecast_inputs,
                    dispatch=dispatch,
                    scatter=FM.slice_forecast_outputs,
                    isolated=dispatch,
                    mirror=self._mirror(FM.forecast_numpy),
                    fallback=forecast_invalid,
                )
            )
        return results

    # -- fused tick --------------------------------------------------------

    def fused_tick_all(self, batch, backend: Optional[str] = None):
        """Concatenate every tenant's FusedTickInputs into shared
        fused-megakernel dispatches (docs/solver-service.md "Fused
        tick"): one compiled forecast -> decide -> cost program covers
        the whole tenant group, and each tenant's slice of the scattered
        outputs is bit-identical to its own independent fused dispatch
        (the same row/series-independence argument as decide_all /
        forecast_all). Groups by (now epoch, forecast time bucket) so
        concatenation never perturbs stabilization-window math or the
        forecast compile rung; a degraded tenant serves from the
        bit-identical fused_tick_numpy mirror alone."""
        from karpenter_tpu_torch.ops import fusedtick as FT
        from karpenter_tpu_torch.solver.bucketing import bucket_up
        from karpenter_tpu_torch.solver.service import FORECAST_T_FLOOR

        self.stats.fused_calls += 1
        self._serving = {}
        self.errors = {}
        results: Dict[str, object] = {}
        groups: Dict[tuple, Dict[str, object]] = {}
        for tenant, inputs in batch.items():
            t_bucket = 0
            if inputs.forecast is not None:
                t_bucket = bucket_up(
                    int(np.asarray(inputs.forecast.values).shape[1]),
                    FORECAST_T_FLOOR,
                )
            key = (float(np.asarray(inputs.decision.now)), t_bucket)
            groups.setdefault(key, {})[tenant] = inputs

        def dispatch(inputs):
            return self.service.fused_tick(inputs, backend=backend)

        for group in groups.values():
            # per-round tenant spans (series ranges + stage presence),
            # written by concat and read back by scatter — the generic
            # _run_family machinery only threads row offsets, and the
            # fused outputs carry a second (series) axis
            spans: Dict[int, dict] = {}

            def concat(inputs_list, _spans=spans):
                stacked, tenant_spans = concat_fused_inputs(inputs_list)
                _spans.clear()
                _spans.update(tenant_spans)
                return stacked

            def scatter(out, start, stop, _spans=spans):
                return slice_fused_outputs(
                    out, start, stop, _spans.get(start)
                )

            results.update(
                self._run_family(
                    group,
                    family="fused",
                    rows_of=lambda i: int(
                        np.asarray(i.decision.spec_replicas).shape[0]
                    ),
                    concat=concat,
                    dispatch=dispatch,
                    scatter=scatter,
                    isolated=dispatch,
                    mirror=self._mirror(FT.fused_tick_numpy),
                    fallback=fused_hold,
                )
            )
        return results

    # -- solve (bin-pack) --------------------------------------------------

    def solve_all(  # lint: allow-complexity — per-tenant isolation ladder + weighted-deadline classification, one guard each
        self,
        batch,
        buckets: int = 32,
        backend: Optional[str] = None,
        timeout: Optional[float] = None,
    ):
        """Cross-tenant bin-packs through the EXISTING coalescing queue:
        every healthy tenant's problem is submitted before any result is
        awaited, so same-bucket problems concatenate into one batched
        dispatch exactly like concurrent same-cluster callers do (on
        the cuda rung each request is one launch of each kernel). A
        degraded tenant's solve never enters the queue — on the CPU it
        serves from the numpy mirror inline (the same binpack_numpy
        every ladder rung ends at); under the card rule it takes its
        own synchronous service.solve, and a tenant that fails there is
        left out of the results with its error in `errors`."""
        from karpenter_tpu_torch.ops.numpy_binpack import binpack_numpy
        from karpenter_tpu_torch.solver.service import SolverTimeout

        self.stats.solve_calls += 1
        self.errors = {}
        card = self.card_rule
        results: Dict[str, object] = {}

        def serve_alone(tenant, inputs):
            if not card:
                results[tenant] = binpack_numpy(inputs, buckets=buckets)
                self._served_mirror(tenant)
                return
            self.stats.isolated_dispatches += 1
            try:
                results[tenant] = self.service.solve(
                    inputs, buckets=buckets, backend=backend,
                    timeout=timeout,
                )
            except Exception as error:  # noqa: BLE001 — per-tenant isolation
                self._tenant_failed(tenant, error)
                self.errors[tenant] = error

        # (tenant, future, effective timeout, bounded-by-budget?)
        futures: List[Tuple[str, object, Optional[float], bool]] = []
        # tenant-weighted solve deadlines: each tenant's queue wait is
        # bounded by its weighted budget (never loosened past the
        # caller's own timeout) — an expiry serves the tenant alone
        # and counts a deferral, not a breaker failure
        budgets = self._deadline_budgets(
            sorted(batch), self.registry.weights()
        )
        for tenant, inputs in sorted(batch.items()):
            # "probe" needs no special-casing here: the solver
            # service's own ladder answers each queued request on a
            # device failure (numpy on the CPU, the error on the card),
            # so a probing tenant cannot fail other riders' results
            if self._admit_tenant(tenant) == "degraded":
                serve_alone(tenant, inputs)
                continue
            budget = budgets.get(tenant)
            t_eff = (
                timeout
                if budget is None
                else (min(timeout, budget) if timeout else budget)
            )
            # a later expiry is only a DEADLINE escape when the
            # weighted budget was the binding bound — an expiry at the
            # caller's own (smaller) timeout is a device-path problem
            # and must keep charging the breaker
            bounded = budget is not None and (
                not timeout or budget < timeout
            )
            try:
                futures.append((tenant, self.service.submit(
                    inputs, buckets=buckets, backend=backend,
                    timeout=t_eff, tenant=tenant,
                ), t_eff, bounded))
                self.stats.solve_requests += 1
            except Exception as error:  # noqa: BLE001 — per-tenant isolation
                self._tenant_failed(tenant, error)
                serve_alone(tenant, inputs)
        for tenant, future, t_eff, bounded in futures:
            try:
                results[tenant] = future.result(t_eff)
                self._tenant_ok(tenant)
            except Exception as error:  # noqa: BLE001 — per-tenant isolation
                if isinstance(error, SolverTimeout) and bounded:
                    # weighted-deadline expiry: bounded-wait serve, no
                    # breaker charge (backlog, not tenant fault)
                    self.stats.deadline_escapes += 1
                    self.stats.deferrals += 1
                    if self.metrics.enabled:
                        self.metrics.deferrals.inc(tenant, "-")
                else:
                    self._tenant_failed(tenant, error)
                serve_alone(tenant, batch[tenant])
        return results

    # -- decision provenance (observability/provenance.py) -----------------

    def flush_provenance(self) -> None:
        """Commit a pending decide-only batch (a caller that never runs
        a cost pass flushes before reading /debug/decisions or
        exporting; the next decide_all flushes automatically)."""
        if self._ledger_batch is not None:
            self._ledger_owner.commit(self._ledger_batch)
            self._ledger_batch = None
            self._ledger_owner = None
            self._ledger_slices = {}

    def _ledger_begin(self, batch: Dict[str, object]) -> None:
        """Open the tick's ledger batch: one record per tenant row,
        labeled tenant/group=<tenant id> and name=row<i>. Spans
        decide_all -> cost_all (the cost pass annotates its slice and
        commits); a decide-only caller's batch commits on the next tick
        (or flush_provenance) instead of leaking. No-op (one attribute
        read) when the ledger is disabled."""
        from karpenter_tpu_torch.observability import default_ledger
        from karpenter_tpu_torch.observability.provenance import OBSERVED_WIDTH

        # the previous tick never ran a cost pass: its records are
        # complete as decided — commit (into the ledger that staged
        # them) rather than drop
        self.flush_provenance()
        ledger = default_ledger()
        if not ledger.enabled:
            return
        tenants = sorted(batch)
        sizes = [
            int(np.asarray(batch[t].spec_replicas).shape[0])
            for t in tenants
        ]
        total = sum(sizes)
        if not total:
            return
        tenant_col = np.empty(total, object)
        name_col = np.empty(total, object)
        observed = np.zeros((total, OBSERVED_WIDTH), np.float32)
        observed_n = np.zeros(total, np.int16)
        prev = np.zeros(total, np.int32)
        slices: Dict[str, Tuple[int, int]] = {}
        offset = 0
        for tenant, size in zip(tenants, sizes):
            stop = offset + size
            slices[tenant] = (offset, stop)
            tenant_col[offset:stop] = tenant
            name_col[offset:stop] = _row_names(size)
            values = np.asarray(batch[tenant].metric_value, np.float32)
            m = min(values.shape[1], OBSERVED_WIDTH)
            observed[offset:stop, :m] = values[:, :m]
            observed_n[offset:stop] = values.shape[1]
            prev[offset:stop] = np.asarray(
                batch[tenant].spec_replicas, np.int32
            )
            offset = stop
        self._ledger_batch = ledger.begin(
            "tenant",
            total,
            tenant=tenant_col,
            namespace="-",
            name=name_col,
            group=tenant_col.copy(),
            observed=observed,
            observed_n=observed_n,
            prev_replicas=prev,
        )
        self._ledger_owner = ledger if self._ledger_batch else None
        self._ledger_slices = slices
        # the batch outlives this call (cost_all annotates later): own
        # it on the scheduler, not the begin() thread's TLS slot
        ledger.abort(self._ledger_batch)

    def _ledger_after_decide(self, results: Dict[str, object]) -> None:
        batch = self._ledger_batch
        if batch is None:
            return
        for tenant, (start, stop) in self._ledger_slices.items():
            out = results.get(tenant)
            if out is None:
                continue
            desired = np.asarray(out.desired, np.int32)[: stop - start]
            serve = self._serving.get(tenant, {})
            batch.annotate_slice(
                start, stop,
                base_desired=desired,
                final_desired=desired,
                solver_rung=serve.get("rung", "device"),
                solver_backend=serve.get("backend", ""),
                admission_round=np.int16(serve.get("round", 0)),
                deferred=bool(serve.get("deferred", False)),
            )

    def _ledger_after_cost(
        self, inputs: Dict[str, object], results: Dict[str, object]
    ) -> None:
        """The cost pass annotates its slice and COMMITS the tick's
        records. Tenants absent from the decide batch (cost-only
        callers) are skipped; a cost serve from the mirror/floor
        updates the rung — the refine stage is the one that computed
        the final number."""
        batch = self._ledger_batch
        if batch is None:
            return
        for tenant, (start, stop) in self._ledger_slices.items():
            out = results.get(tenant)
            if out is None or tenant not in inputs:
                continue  # decide-only tenant: its record stands as decided
            size = stop - start
            desired = np.asarray(out.desired, np.int32)[:size]
            serve = self._serving.get(tenant, {})
            rung = serve.get("rung")
            columns = dict(
                final_desired=desired,
                slo_opted=np.asarray(
                    inputs[tenant].slo_valid, bool
                )[:size],
                cost_candidate=desired,
                cost_risk=np.asarray(
                    out.violation_risk, np.float32
                )[:size],
                cost_hourly=np.asarray(
                    out.expected_hourly, np.float32
                )[:size],
                budget_clamped=np.asarray(
                    out.cost_limited, bool
                )[:size],
                cost_blind=bool(rung == "floor"),
            )
            if rung:
                columns["solver_rung"] = rung
            batch.annotate_slice(start, stop, **columns)
        # commit into the ledger that STAGED the batch — the process
        # default may have been swapped since decide_all
        owner = self._ledger_owner
        self._ledger_batch = None
        self._ledger_owner = None
        self._ledger_slices = {}
        owner.commit(batch)

    def _record_serve(
        self, tenant: str, rung: str, round_index: int = 0,
        deferred: bool = False, backend: str = "",
    ) -> None:
        self._serving[tenant] = {
            "rung": rung,
            "round": round_index,
            "deferred": deferred,
            "backend": backend,
        }
        if rung != "device":
            # tenant-stamped marker span for every off-the-shared-batch
            # serve (isolated / mirror / floor): /debug/traces?tenant=
            # surfaces exactly which ticks degraded this tenant and how
            # — bounded by degraded tenants, so the healthy 1k-tenant
            # shared round stays span-free
            from karpenter_tpu_torch.observability import default_tracer

            span = default_tracer().begin(
                "tenancy.serve", tenant=tenant, rung=rung,
            )
            if span is not None:
                span.close()

    # -- the shared fan-in/fan-out machinery -------------------------------

    def _admit_tenant(self, tenant: str) -> str:
        """Breaker gate + per-tenant fault point. Verdicts: "shared"
        (ride the concatenated batch), "probe" (breaker open, probe due
        — ONE isolated recovery dispatch, never the shared batch: the
        failure that opened the breaker must not re-break healthy
        tenants' rounds), or "degraded" (mirror/fallback only)."""
        from karpenter_tpu_torch.tenancy import isolation as I

        state = self.breakers.gate(tenant)
        if state == I.OPEN:
            return "degraded"
        try:
            inject(GATHER_POINT + tenant)
        except Exception as error:  # noqa: BLE001 — injected per-tenant fault
            self._tenant_failed(tenant, error)
            return "degraded"
        return "probe" if state == I.PROBE else "shared"

    def _tenant_failed(self, tenant: str, error: BaseException) -> None:
        self.stats.tenant_failures += 1
        self._last_error[tenant] = error
        tripped = self.breakers.record_failure(tenant)
        if tripped:
            self.stats.breaker_trips += 1
            logger().warning(
                "tenant %s breaker OPEN after repeated failures (%s: %s); "
                "serving its rows %s while others stay on the shared "
                "batch",
                tenant, type(error).__name__, error,
                "by its own device dispatch" if self.card_rule
                else "from the mirror",
            )
            # flight-recorder event with the tenant FIELD, so
            # /debug/flightrecorder?tenant=<id> surfaces exactly this
            # tenant's degradations (docs/observability.md); NOT a
            # dump-class kind — one sick tenant in a 1k-tenant fleet is
            # supervised degradation, not a control-plane incident
            from karpenter_tpu_torch.observability import (
                default_flight_recorder,
            )

            default_flight_recorder().record(
                "tenant_breaker_trip",
                tenant=tenant,
                error=f"{type(error).__name__}: {error}"[:200],
            )
        if self.metrics.enabled:
            if tripped:
                self.metrics.trips.inc(tenant, "-")
            self.metrics.degraded.set(
                tenant, "-", 1.0 if self.breakers.is_open(tenant) else 0.0
            )

    def _tenant_ok(self, tenant: str) -> None:
        if self.breakers.record_success(tenant):
            self.stats.breaker_recoveries += 1
            logger().info(
                "tenant %s breaker closed; rejoining the shared batch",
                tenant,
            )
        if self.metrics.enabled:
            self.metrics.degraded.set(tenant, "-", 0.0)

    def _served_mirror(self, tenant: str) -> None:
        self.stats.mirror_served += 1
        if self.metrics.enabled:
            self.metrics.mirror.inc(tenant, "-")

    def _run_family(  # lint: allow-complexity — one family pass: gate + admit + rounds, one guard per policy
        self, batch, *, family, rows_of, concat, dispatch, scatter,
        isolated, mirror, fallback,
    ) -> Dict[str, object]:
        """One family pass: breaker-gate, fair-admit, concatenate,
        dispatch shared rounds, scatter per tenant; degraded tenants
        serve from `mirror` (or `isolated` when the family has no host
        mirror, with `fallback` synthesizing the never-block answer if
        even that fails). A shared-round failure falls back to
        per-tenant isolated dispatches so one poisoned tenant cannot
        take the round's healthy tenants down with it. Every tenant in
        `batch` gets a real outputs object back — never an exception."""
        results: Dict[str, object] = {}
        healthy: Dict[str, object] = {}
        for tenant, inputs in sorted(batch.items()):
            n = rows_of(inputs)
            self._count_rows(family, n)
            if self.metrics.enabled:
                self.metrics.backlog.set(tenant, "-", float(n))
            verdict = self._admit_tenant(tenant)
            if verdict == "shared":
                healthy[tenant] = inputs
            elif verdict == "probe":
                results[tenant] = self._probe_tenant(
                    tenant, inputs, isolated, mirror, fallback
                )
            else:
                results[tenant] = self._serve_degraded(
                    tenant, inputs, mirror, isolated, fallback
                )
        if healthy:
            weights = self.registry.weights()
            demand = {t: rows_of(i) for t, i in healthy.items()}
            # group-aware: tenants hosting one PoolGroup's member pools
            # ride the same round, so the joint allocator never scores
            # a partial group (fairness.py module docstring)
            schedule = self.admission.rounds(
                demand, weights, self.registry.pool_groups()
            )
            self.stats.admission_rounds += len(schedule)
            if self.metrics.enabled:
                self.metrics.rounds.set("-", "-", float(len(schedule)))
            budgets = self._deadline_budgets(list(healthy), weights)
            t0 = self._clock()
            for round_index, admitted in enumerate(schedule):
                if budgets and round_index > 0:
                    # tenant-weighted solve deadlines: a deferred
                    # tenant whose weighted budget the earlier rounds
                    # already consumed stops waiting and serves NOW
                    # from the bit-identical mirror (or an isolated
                    # dispatch) — same answer, bounded wait
                    elapsed = self._clock() - t0
                    expired = {
                        t for t in admitted if elapsed > budgets[t]
                    }
                    for tenant in sorted(expired):
                        results[tenant] = self._serve_deadline_escape(
                            tenant, healthy[tenant], mirror, isolated,
                            fallback,
                        )
                    admitted = [t for t in admitted if t not in expired]
                    if not admitted:
                        continue
                if round_index > 0:
                    self.stats.deferrals += len(admitted)
                    if self.metrics.enabled:
                        for tenant in admitted:
                            self.metrics.deferrals.inc(tenant, "-")
                self._dispatch_round(
                    {t: healthy[t] for t in admitted},
                    results, family=family, concat=concat,
                    dispatch=dispatch, scatter=scatter,
                    isolated=isolated, mirror=mirror, fallback=fallback,
                    rows_of=rows_of, round_index=round_index,
                )
        if family in ("decide", "fused") and self.metrics.enabled:
            # karpenter_tenant_decisions_total counts DECIDE rows only
            # (one per autoscaler per tick — the fused megakernel's
            # rows are decisions too), on every serve path — shared
            # scatter, lone round, mirror, and fallback alike
            for tenant in results:
                self.metrics.decisions.inc(
                    tenant, "-", float(rows_of(batch[tenant]))
                )
        return results

    def _count_rows(self, family: str, n: int) -> None:
        if family == "decide":
            self.stats.decide_rows += n
        elif family == "cost":
            self.stats.cost_rows += n
        elif family == "fused":
            self.stats.fused_rows += n
        else:
            self.stats.forecast_series += n

    def _count_family_dispatch(self, family: str) -> None:
        if family == "decide":
            self.stats.decide_dispatches += 1
        elif family == "cost":
            self.stats.cost_dispatches += 1
        elif family == "fused":
            self.stats.fused_dispatches += 1
        else:
            self.stats.forecast_dispatches += 1

    def _deadline_budgets(
        self, tenants: List[str], weights: Dict[str, float]
    ) -> Dict[str, float]:
        """Per-tenant wall-time budgets under --tenant-deadline:
        deadline_s scaled by weight / mean weight, so the fleet's mean
        tenant gets exactly deadline_s and weights shift budget toward
        the tenants an operator declared heavier. Empty when the bound
        is disabled."""
        from karpenter_tpu_torch.tenancy.fairness import effective_weight

        if self.deadline_s is None or not tenants:
            return {}
        w = {t: effective_weight(weights, t) for t in tenants}
        mean = sum(w.values()) / len(w)
        return {t: self.deadline_s * w[t] / mean for t in tenants}

    def _serve_deadline_escape(
        self, tenant, inputs, mirror, isolated, fallback
    ):
        """A deferred tenant whose weighted deadline budget ran out:
        serve immediately from the family's mirror/isolated rung
        instead of waiting out the remaining rounds. Counted as a
        deferral (karpenter_tenant_deferrals_total — the fairness
        ledger the operator already watches) plus deadline_escapes; the
        breaker is NOT charged — backlog is the plane's condition, not
        the tenant's fault."""
        self.stats.deadline_escapes += 1
        self.stats.deferrals += 1
        if self.metrics.enabled:
            self.metrics.deferrals.inc(tenant, "-")
        out = self._serve_degraded(
            tenant, inputs, mirror, isolated, fallback
        )
        serve = self._serving.get(tenant)
        if serve is not None:
            serve["deferred"] = True
        return out

    def _probe_tenant(self, tenant, inputs, isolated, mirror, fallback):
        """An open breaker's recovery probe: ONE isolated dispatch —
        success closes the breaker (the tenant rejoins the shared batch
        next round), failure keeps it open and this round serves from
        the mirror/fallback like any other degraded round."""
        self.stats.probes += 1
        try:
            self.stats.isolated_dispatches += 1
            out = isolated(inputs)
            self._tenant_ok(tenant)
            self._record_serve(tenant, "isolated")
            return out
        except Exception as error:  # noqa: BLE001 — tenant isolation
            self._tenant_failed(tenant, error)
            return self._mirror_or_fallback(
                tenant, inputs, mirror, fallback
            )

    def _serve_degraded(self, tenant, inputs, mirror, isolated, fallback):
        """A tenant outside the shared batch still gets a REAL answer:
        the family's numpy mirror, or an isolated dispatch for
        mirror-less families — and if even that rung fails, the
        family's `fallback` synthesizes the never-block result (hold
        current replicas / pass through cost-blind / invalid forecast)
        so one sick tenant can never hand its caller an exception."""
        if mirror is None:
            try:
                self.stats.isolated_dispatches += 1
                out = isolated(inputs)
                self._record_serve(tenant, "isolated")
                return out
            except Exception as error:  # noqa: BLE001 — tenant isolation
                self._tenant_failed(tenant, error)
            return self._served_fallback(tenant, fallback, inputs)
        return self._mirror_or_fallback(tenant, inputs, mirror, fallback)

    def _mirror_or_fallback(self, tenant, inputs, mirror, fallback):
        if mirror is not None:
            try:
                out = mirror(inputs)
                self._served_mirror(tenant)
                self._record_serve(tenant, "mirror", backend="numpy")
                return out
            except Exception as error:  # noqa: BLE001 — tenant isolation
                self._tenant_failed(tenant, error)
        return self._served_fallback(tenant, fallback, inputs)

    def _served_fallback(self, tenant, fallback, inputs):
        """Count a synthesized never-block result SEPARATELY from
        mirror serves — a fallback answer is a do-nothing floor, not a
        bit-identical mirror, and conflating them on /metrics would
        mask how degraded a tenant really is."""
        self.stats.fallback_served += 1
        error = self._last_error.get(tenant)
        if error is not None:
            self.errors[tenant] = error
        if self.metrics.enabled:
            self.metrics.fallback.inc(tenant, "-")
        self._record_serve(tenant, "floor")
        return fallback(inputs)

    def _dispatch_round(  # lint: allow-complexity — shared dispatch + per-tenant fallback ladder, one arm per rung
        self, admitted, results, *, family, concat, dispatch, scatter,
        isolated, mirror, fallback, rows_of, round_index: int = 0,
    ) -> None:
        tenants = sorted(admitted)
        if len(tenants) == 1:
            # a lone tenant (oversized, or just a one-tenant fleet)
            # needs no concatenation — its own matrix IS the program
            tenant = tenants[0]
            try:
                self.stats.isolated_dispatches += 1
                results[tenant] = isolated(admitted[tenant])
                self._tenant_ok(tenant)
                self._record_serve(
                    tenant, "isolated", round_index,
                    deferred=round_index > 0,
                )
            except Exception as error:  # noqa: BLE001 — tenant isolation
                self._tenant_failed(tenant, error)
                results[tenant] = self._serve_degraded(
                    tenant, admitted[tenant], mirror, isolated, fallback
                )
            return
        inputs_list = [admitted[t] for t in tenants]
        sizes = [rows_of(i) for i in inputs_list]
        stacked = concat(inputs_list)
        try:
            out = dispatch(stacked)
        except Exception as error:  # noqa: BLE001 — shared-round failure
            logger().warning(
                "shared %d-tenant dispatch failed (%s: %s); retrying "
                "each tenant in isolation",
                len(tenants), type(error).__name__, error,
            )
            for tenant in tenants:
                try:
                    self.stats.isolated_dispatches += 1
                    results[tenant] = isolated(admitted[tenant])
                    self._tenant_ok(tenant)
                except Exception as tenant_error:  # noqa: BLE001
                    self._tenant_failed(tenant, tenant_error)
                    results[tenant] = self._serve_degraded(
                        tenant, admitted[tenant], mirror, isolated,
                        fallback,
                    )
            return
        self._count_family_dispatch(family)
        offset = 0
        for tenant, size in zip(tenants, sizes):
            results[tenant] = scatter(out, offset, offset + size)
            offset += size
            self._tenant_ok(tenant)
            self._record_serve(
                tenant, "device", round_index,
                deferred=round_index > 0,
            )
        if self.metrics.enabled:
            self.metrics.dispatches.inc("-", "-")


# -- last-resort fallbacks (the never-block floor of the tenant ladder) ------
# Synthesized when a tenant's mirror/isolated rung ALSO fails: each
# family's domain-safe "do nothing" answer, so a sick tenant's result is
# always a real outputs object — never an exception for the caller to
# trip over mid-batch.


def decide_hold(inputs: D.DecisionInputs) -> D.DecisionOutputs:
    """Hold current replicas: the decide family's never-block floor
    (the same posture a failed metric query takes — no movement without
    a trustworthy signal)."""
    spec = np.asarray(inputs.spec_replicas, np.int32)
    n = spec.shape[0]
    return D.DecisionOutputs(
        desired=spec.copy(),
        recommendation=spec.copy(),
        limited=spec.copy(),
        able_to_scale=np.zeros(n, bool),
        scaling_unbounded=np.ones(n, bool),
        able_at=np.zeros(n, np.float32),
        rate_limited=np.zeros(n, bool),
        up_ceiling=spec.copy(),
        down_floor=spec.copy(),
    )


def cost_blind(inputs) -> "object":
    """Pass the base decision through unrefined: the cost family's
    documented degradation (docs/cost.md — cost-blind, never moved)."""
    from karpenter_tpu_torch.ops import cost as CK

    base = np.asarray(inputs.base_desired, np.int32)
    n = base.shape[0]
    return CK.CostOutputs(
        desired=base.copy(),
        expected_hourly=(
            base.astype(np.float32)
            * np.asarray(inputs.unit_cost, np.float32)
        ),
        violation_risk=np.zeros(n, np.float32),
        headroom=np.zeros(n, np.int32),
        cost_limited=np.zeros(n, bool),
        slo_raised=np.zeros(n, bool),
    )


def forecast_invalid(inputs) -> "object":
    """All-invalid forecasts (n_valid = 0): consumers gate on
    n_valid >= min_samples, so the tick proceeds purely reactive —
    the forecast subsystem's own never-block contract."""
    from karpenter_tpu_torch.forecast.models import ForecastOutputs

    s = int(np.asarray(inputs.values).shape[0])
    return ForecastOutputs(
        point=np.zeros(s, np.float32),
        sigma2=np.zeros(s, np.float32),
        n_valid=np.zeros(s, np.int32),
    )


def fused_hold(inputs) -> "object":
    """The fused family's never-block floor: hold replicas (decide
    floor), all-invalid forecasts, and a cost-blind pass-through of the
    held number — each stage's own documented degradation, composed."""
    from karpenter_tpu_torch.ops import cost as CK
    from karpenter_tpu_torch.ops import fusedtick as FT

    decision = decide_hold(inputs.decision)
    forecast = None
    if inputs.forecast is not None:
        forecast = forecast_invalid(inputs.forecast)
    cost = None
    if inputs.slo_valid is not None:
        held = decision.desired
        n = held.shape[0]
        cost = CK.CostOutputs(
            desired=held.copy(),
            expected_hourly=(
                held.astype(np.float32)
                * np.asarray(inputs.unit_cost, np.float32)
            ),
            violation_risk=np.zeros(n, np.float32),
            headroom=np.zeros(n, np.int32),
            cost_limited=np.zeros(n, bool),
            slo_raised=np.zeros(n, bool),
        )
    return FT.FusedTickOutputs(
        decision=decision, forecast=forecast, cost=cost
    )


# -- concatenation / scatter helpers (module docstring parity contract) ------


def _pad_cols(arr: np.ndarray, width: int, fill) -> np.ndarray:
    """Pad a [N, M] operand's column axis to `width` with `fill` —
    semantics-preserving because every kernel masks these columns by
    their own *_valid operand."""
    arr = np.asarray(arr)
    if arr.shape[1] == width:
        return arr
    pad = np.full((arr.shape[0], width - arr.shape[1]), fill, arr.dtype)
    return np.concatenate([arr, pad], axis=1)


def concat_decision_inputs(
    inputs_list: List[D.DecisionInputs], row_bucket: int = ROW_BUCKET,
) -> D.DecisionInputs:
    """Stack per-tenant fleet matrices along the row axis, padding the
    metric (M) and policy-slot (K) axes to the group maximum with
    masked-invalid columns and the row axis up the compile bucket with
    inert rows. Every tenant must share the `now` epoch (decide math is
    relative to it); decide_all groups by `now` before calling."""
    nows = {float(np.asarray(i.now)) for i in inputs_list}
    if len(nows) != 1:
        raise ValueError(
            f"cannot concatenate decide batches across differing now "
            f"epochs: {sorted(nows)}"
        )
    m = max(int(np.asarray(i.metric_value).shape[1]) for i in inputs_list)
    m = max(m, 1)
    k = max(int(np.asarray(i.up_ptype).shape[1]) for i in inputs_list)
    k = max(k, 1)
    has_forecast = any(i.forecast_value is not None for i in inputs_list)
    total = sum(
        int(np.asarray(i.spec_replicas).shape[0]) for i in inputs_list
    )
    n_pad = D.pad_to(total, row_bucket) - total

    def rows(name: str, width: Optional[int], fill):
        parts = []
        for i in inputs_list:
            arr = getattr(i, name)
            if arr is None:  # optional forecast operand, absent here
                n = int(np.asarray(i.metric_value).shape[0])
                arr = np.full((n, width), fill)
            arr = np.asarray(arr)
            parts.append(
                _pad_cols(arr, width, fill) if width is not None else arr
            )
        out = np.concatenate(parts, axis=0)
        if n_pad:
            pad_shape = (n_pad,) + out.shape[1:]
            out = np.concatenate(
                [out, np.full(pad_shape, fill, out.dtype)], axis=0
            )
        return out

    return D.DecisionInputs(
        metric_value=rows("metric_value", m, np.float32(0)),
        target_value=rows("target_value", m, np.float32(0)),
        target_type=rows("target_type", m, np.int32(D.TYPE_UNKNOWN)),
        metric_valid=rows("metric_valid", m, False),
        spec_replicas=rows("spec_replicas", None, np.int32(0)),
        status_replicas=rows("status_replicas", None, np.int32(0)),
        min_replicas=rows("min_replicas", None, np.int32(0)),
        max_replicas=rows("max_replicas", None, np.int32(0)),
        up_window=rows("up_window", None, np.int32(0)),
        down_window=rows("down_window", None, np.int32(0)),
        up_policy=rows("up_policy", None, np.int32(D.POLICY_MAX)),
        down_policy=rows("down_policy", None, np.int32(D.POLICY_MAX)),
        last_scale_time=rows("last_scale_time", None, np.float32(0)),
        has_last_scale=rows("has_last_scale", None, False),
        now=inputs_list[0].now,
        up_ptype=rows("up_ptype", k, np.int32(D.POLICY_TYPE_COUNT)),
        up_pvalue=rows("up_pvalue", k, np.int32(0)),
        up_pperiod=rows("up_pperiod", k, np.int32(0)),
        up_pvalid=rows("up_pvalid", k, False),
        down_ptype=rows("down_ptype", k, np.int32(D.POLICY_TYPE_COUNT)),
        down_pvalue=rows("down_pvalue", k, np.int32(0)),
        down_pperiod=rows("down_pperiod", k, np.int32(0)),
        down_pvalid=rows("down_pvalid", k, False),
        forecast_value=(
            rows("forecast_value", m, np.float32(0))
            if has_forecast else None
        ),
        forecast_valid=(
            rows("forecast_valid", m, False) if has_forecast else None
        ),
    )


def slice_decision_outputs(
    out: D.DecisionOutputs, start: int, stop: int
) -> D.DecisionOutputs:
    return D.DecisionOutputs(
        **{
            f.name: np.asarray(getattr(out, f.name))[start:stop]
            for f in dataclasses.fields(D.DecisionOutputs)
        }
    )


def concat_cost_inputs(inputs_list, row_bucket: int = ROW_BUCKET):
    """Stack per-tenant CostInputs along the row axis (metric axis
    padded to the group maximum with demand_valid=False columns, rows
    padded up the bucket with slo_valid=False pass-through rows)."""
    from karpenter_tpu_torch.ops import cost as CK

    m = max(int(np.asarray(i.slo_target).shape[1]) for i in inputs_list)
    m = max(m, 1)
    total = sum(
        int(np.asarray(i.base_desired).shape[0]) for i in inputs_list
    )
    n_pad = D.pad_to(total, row_bucket) - total

    def rows(name: str, width: Optional[int], fill):
        parts = [
            _pad_cols(np.asarray(getattr(i, name)), width, fill)
            if width is not None
            else np.asarray(getattr(i, name))
            for i in inputs_list
        ]
        out = np.concatenate(parts, axis=0)
        if n_pad:
            pad_shape = (n_pad,) + out.shape[1:]
            out = np.concatenate(
                [out, np.full(pad_shape, fill, out.dtype)], axis=0
            )
        return out

    return CK.CostInputs(
        base_desired=rows("base_desired", None, np.int32(0)),
        min_replicas=rows("min_replicas", None, np.int32(0)),
        max_replicas=rows("max_replicas", None, np.int32(0)),
        unit_cost=rows("unit_cost", None, np.float32(0)),
        slo_weight=rows("slo_weight", None, np.float32(0)),
        max_hourly_cost=rows("max_hourly_cost", None, np.float32(0)),
        slo_valid=rows("slo_valid", None, False),
        slo_target=rows("slo_target", m, np.float32(1)),
        demand_mu=rows("demand_mu", m, np.float32(0)),
        demand_sigma=rows("demand_sigma", m, np.float32(0)),
        demand_valid=rows("demand_valid", m, False),
    )


def slice_cost_outputs(out, start: int, stop: int):
    from karpenter_tpu_torch.ops import cost as CK

    return CK.CostOutputs(
        **{
            f.name: np.asarray(getattr(out, f.name))[start:stop]
            for f in dataclasses.fields(CK.CostOutputs)
        }
    )


def concat_forecast_inputs(inputs_list):
    """Stack per-tenant ForecastInputs along the series axis (the time
    axis was already padded to a shared bucket by forecast_all). Reuses
    the forecast model's own concat — the same code path the coalescing
    queue runs for same-cluster concurrent forecasts."""
    from karpenter_tpu_torch.forecast import models as FM
    from karpenter_tpu_torch.solver.service import FORECAST_S_FLOOR
    from karpenter_tpu_torch.solver.bucketing import bucket_up

    total = sum(int(np.asarray(i.values).shape[0]) for i in inputs_list)
    return FM.concat_forecast_inputs(
        inputs_list, bucket_up(total, FORECAST_S_FLOOR)
    )


def concat_fused_inputs(
    inputs_list, row_bucket: int = ROW_BUCKET
) -> Tuple[object, Dict[int, dict]]:
    """Stack per-tenant FusedTickInputs: decision matrices along the
    row axis (concat_decision_inputs), forecast series along the series
    axis with per-tenant ROW-OFFSET fixups on the scatter maps, and the
    masked cost operands along the row axis. Returns (stacked, spans):
    spans[row_offset] = {"series": (s0, s1) | None, "cost": bool} — the
    aux geometry slice_fused_outputs needs to scatter the second
    (series) axis back per tenant.

    Trash-row fixup: each tenant's pad series point at its OWN grid's
    trash row (row >= its N); after concatenation that index is a REAL
    row of the next tenant, so those references are remapped to the
    concatenated grid's trash row (the padded row count)."""
    from karpenter_tpu_torch.forecast import models as FM
    from karpenter_tpu_torch.ops import fusedtick as FT
    from karpenter_tpu_torch.solver.bucketing import bucket_up
    from karpenter_tpu_torch.solver.service import (
        FORECAST_S_FLOOR,
        FORECAST_T_FLOOR,
    )

    sizes = [
        int(np.asarray(i.decision.spec_replicas).shape[0])
        for i in inputs_list
    ]
    total = sum(sizes)
    n_total = D.pad_to(total, row_bucket)
    decision = concat_decision_inputs(
        [i.decision for i in inputs_list], row_bucket
    )
    m = int(np.asarray(decision.metric_value).shape[1])

    spans: Dict[int, dict] = {}
    f_parts: List[object] = []
    row_parts, col_parts, need_parts, blend_parts = [], [], [], []
    t_bucket = max(
        [
            bucket_up(
                int(np.asarray(i.forecast.values).shape[1]),
                FORECAST_T_FLOOR,
            )
            for i in inputs_list
            if i.forecast is not None
        ],
        default=0,
    )
    offset = 0
    s_offset = 0
    for inputs, size in zip(inputs_list, sizes):
        span = {"series": None, "cost": inputs.slo_valid is not None}
        if inputs.forecast is not None:
            s = int(np.asarray(inputs.forecast.values).shape[0])
            span["series"] = (s_offset, s_offset + s)
            s_offset += s
            # same left-aligned T padding the tenant's own isolated
            # dispatch would get at the service door (fused_tick_all
            # groups by t_bucket, so this is bit-preserving)
            f_parts.append(
                FM.pad_forecast_inputs(inputs.forecast, t_bucket)
            )
            rows = np.asarray(inputs.series_row, np.int64)
            row_parts.append(
                np.where(rows >= size, n_total, rows + offset).astype(
                    np.int32
                )
            )
            col_parts.append(np.asarray(inputs.series_col, np.int32))
            need_parts.append(np.asarray(inputs.series_need, np.int32))
            blend_parts.append(np.asarray(inputs.series_blend, bool))
        spans[offset] = span
        offset += size

    kwargs: dict = {}
    if f_parts:
        s_pad = bucket_up(s_offset, FORECAST_S_FLOOR)
        extra = s_pad - s_offset
        kwargs["forecast"] = FM.concat_forecast_inputs(f_parts, s_pad)
        # the concat's own pad series route to the shared trash row
        # with an unreachable sample threshold — inert in every stage
        kwargs["series_row"] = np.concatenate(
            row_parts + [np.full(extra, n_total, np.int32)]
        )
        kwargs["series_col"] = np.concatenate(
            col_parts + [np.zeros(extra, np.int32)]
        )
        kwargs["series_need"] = np.concatenate(
            need_parts
            + [np.full(extra, np.iinfo(np.int32).max, np.int32)]
        )
        kwargs["series_blend"] = np.concatenate(
            blend_parts + [np.zeros(extra, bool)]
        )
    if any(i.slo_valid is not None for i in inputs_list):
        kwargs.update(
            _concat_fused_cost(inputs_list, sizes, n_total, m)
        )
    return FT.FusedTickInputs(decision=decision, **kwargs), spans


def _concat_fused_cost(
    inputs_list, sizes: List[int], n_total: int, m: int
) -> dict:
    """Row-axis concat of the fused cost operand group. Tenants without
    an SLO opt-in contribute all-masked rows (slo_valid=False is the
    kernel's pass-through), identical to the absent-group wire; the
    metric axis pads to the decision grid's width with demand-invalid
    columns and the row axis up the bucket with masked rows."""

    def rows(name: str, width, fill, dtype):
        parts = []
        for inputs, size in zip(inputs_list, sizes):
            arr = getattr(inputs, name)
            if arr is None:
                shape = (size,) if width is None else (size, width)
                arr = np.full(shape, fill, dtype)
            else:
                arr = np.asarray(arr, dtype)
                if width is not None:
                    arr = _pad_cols(arr, width, fill)
            parts.append(arr)
        out = np.concatenate(parts, axis=0)
        n_pad = n_total - out.shape[0]
        if n_pad:
            pad_shape = (n_pad,) + out.shape[1:]
            out = np.concatenate(
                [out, np.full(pad_shape, fill, out.dtype)], axis=0
            )
        return out

    return dict(
        ha_min=rows("ha_min", None, np.int32(0), np.int32),
        ha_max=rows("ha_max", None, np.int32(0), np.int32),
        unit_cost=rows("unit_cost", None, np.float32(0), np.float32),
        slo_weight=rows("slo_weight", None, np.float32(0), np.float32),
        max_hourly_cost=rows(
            "max_hourly_cost", None, np.float32(0), np.float32
        ),
        slo_valid=rows("slo_valid", None, False, bool),
        slo_target=rows("slo_target", m, np.float32(1), np.float32),
        observed=rows("observed", m, np.float32(0), np.float32),
        demand_base_valid=rows(
            "demand_base_valid", m, False, bool
        ),
        prior_point=rows("prior_point", m, np.float32(0), np.float32),
        prior_sigma2=rows(
            "prior_sigma2", m, np.float32(0), np.float32
        ),
        prior_valid=rows("prior_valid", m, False, bool),
    )


def slice_fused_outputs(out, start: int, stop: int, span):
    """One tenant's slice of a shared fused dispatch: decision/cost by
    row range, forecast by the tenant's series range (from the concat's
    span record). Stages the tenant never carried come back None —
    byte-identical to its own independent dispatch."""
    from karpenter_tpu_torch.forecast import models as FM
    from karpenter_tpu_torch.ops import fusedtick as FT

    forecast = None
    cost = None
    if span is not None and out.forecast is not None:
        series = span.get("series")
        if series is not None:
            forecast = FM.slice_forecast_outputs(
                out.forecast, series[0], series[1]
            )
    if span is not None and span.get("cost") and out.cost is not None:
        cost = slice_cost_outputs(out.cost, start, stop)
    return FT.FusedTickOutputs(
        decision=slice_decision_outputs(out.decision, start, stop),
        forecast=forecast,
        cost=cost,
    )
