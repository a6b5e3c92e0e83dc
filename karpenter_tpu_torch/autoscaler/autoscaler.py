"""Host-side autoscaler orchestration around the batched decision kernel.

reference: pkg/autoscaler/autoscaler.go:81-237 — per autoscaler: fetch
metrics, fetch scale target, compute desired replicas, apply transient and
bounded limits, update the scale target, set conditions.

The TPU redesign: instead of one scalar pipeline per object per tick, the
BatchAutoscaler snapshots EVERY HorizontalAutoscaler into structure-of-arrays
(padded to a compile bucket) and evaluates them in ONE device call
(ops/decision.decide_jit). Host code does only I/O: metric reads, scale
reads/writes, condition messages. Per-object failures (bad metric, missing
scale target) exclude that row from the batch without failing the others.

The port's copy of karpenter_tpu/autoscaler/autoscaler.py, changed only
in its imports and as noted. The default decider is the port's decide on
the card with one host fetch at the seam (ops/decision.decide_host);
production hands SolverService.decide.
"""

from __future__ import annotations

import datetime
import math
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from karpenter_tpu_torch.api import conditions as cond
from karpenter_tpu_torch.api.horizontalautoscaler import (
    AVERAGE_VALUE,
    HorizontalAutoscaler,
    MetricStatus,
    MetricValueStatus,
    PERCENT_SCALING_POLICY,
    PrometheusMetricStatus,
    UTILIZATION,
    VALUE,
)
from karpenter_tpu_torch.observability import default_tracer
from karpenter_tpu_torch.ops import decision as D
from karpenter_tpu_torch.store import NotFoundError, Store

_TYPE_CODES = {
    VALUE: D.TYPE_VALUE,
    AVERAGE_VALUE: D.TYPE_AVERAGE_VALUE,
    UTILIZATION: D.TYPE_UTILIZATION,
}
_POLICY_CODES = {
    None: D.POLICY_MAX,
    "Max": D.POLICY_MAX,
    "Min": D.POLICY_MIN,
    "Disabled": D.POLICY_DISABLED,
}


@dataclass
class _Row:
    ha: HorizontalAutoscaler
    scale: object
    values: List[float]
    targets: List[float]
    types: List[int]
    # raw observations + spec target types, kept for status.currentMetrics
    # even when a custom algorithm replaces `values` with recommendations
    observed: List = field(default_factory=list)
    error: Optional[Exception] = None
    # a custom Algorithm replaced `values` with recommendations: the
    # forecaster must not blend predicted RAW metric values into them
    custom: bool = False
    # metric indices whose live query failed and reused the last history
    # sample (age-bounded) — excluded from new history appends
    stale_metrics: set = field(default_factory=set)


class BatchAutoscaler:
    """Evaluates all HorizontalAutoscalers as one device call per tick.

    `decider` is the decision half of the Algorithm seam: any
    (DecisionInputs) -> DecisionOutputs callable — the in-process jitted
    kernel (default) or a sidecar SolverClient.decide, making the control
    plane DEVICE-free under the gRPC process split (jax stays imported —
    ops/decision builds the jitted kernel at import — but no backend is
    initialized and no device math runs here; the bin-pack half is the
    `solver=` seam in producers/pendingcapacity.py).
    """

    def __init__(
        self, metrics_client_factory, store: Store, clock=_time.time,
        decider=None, forecaster=None, cost_engine=None, tenant=None,
        fused_tick_fn=None, pool_engine=None,
    ):
        self.metrics = metrics_client_factory
        self.store = store
        self.clock = clock
        # this control plane's own tenant id (--tenant-id), stamped on
        # provenance-ledger records so a shared /debug/decisions reader
        # can tell fleets apart; "" single-tenant
        self.tenant = tenant or ""
        self.decider = decider if decider is not None else D.decide_host
        # predictive-scaling seam (forecast/, docs/forecasting.md): a
        # FleetForecaster owning metric history, the batched forecast
        # dispatch, and online skill gating. None = reactive-only.
        self.forecaster = forecaster
        # cost/SLO refinement seam (cost/, docs/cost.md): a CostEngine
        # refining the fleet decide in one batched dispatch — desired
        # counts only; conditions keep reporting the behavior-pipeline
        # view. None (or an SLO-free fleet) = cost-blind, bit-identical
        # decisions.
        self.cost_engine = cost_engine
        # fused steady-state tick (--fused-tick, ops/fusedtick.py): the
        # SolverService.fused_tick seam running forecast → decide →
        # cost as ONE device program. None = the chained per-stage
        # wire (bit-identical outputs; tests/test_fusedtick.py pins it).
        self.fused_tick_fn = fused_tick_fn
        # joint pool-group allocation seam (--poolgroups, poolgroups/,
        # docs/poolgroups.md): a PoolGroupEngine resolving PoolGroup
        # membership per tick, EXCLUDING member rows from the cost
        # engine's independent ladders and refining them in one joint
        # dispatch instead. None (or a group-free fleet) = the
        # uncoordinated wire, byte-identical.
        self.pool_engine = pool_engine
        # Times enter the kernel as f32 seconds relative to this epoch so a
        # long-lived process never loses sub-second precision to f32.
        self.epoch = clock()
        # per-engine memo of custom Algorithm instances (see
        # _snapshot_row): stateful algorithms keep their windows here
        self._algorithm_instances: Dict[str, object] = {}

    # -- snapshot ---------------------------------------------------------

    def _snapshot_row(self, ha: HorizontalAutoscaler) -> _Row:
        from karpenter_tpu_torch.autoscaler import algorithms

        row = _Row(ha=ha, scale=None, values=[], targets=[], types=[])
        try:
            ref = ha.spec.scale_target_ref
            # the ref's apiVersion rides along so ARBITRARY scalable kinds
            # (a Deployment, any scale-marker CRD) resolve via discovery,
            # not a hard-coded kind table (reference: autoscaler.go:196-237
            # parseGroupResource + ScalesGetter)
            row.scale = self.store.get_scale(
                ref.kind, ha.metadata.namespace, ref.name,
                api_version=ref.api_version,
            )
            # spec-driven algorithm selection (the seam the reference left
            # as a TODO, algorithm.go:37-39): default rows encode raw
            # metrics for the kernel's native Proportional math; a custom
            # algorithm computes per-metric recommendations on host, which
            # enter the batch as AverageValue/target-1 metrics (the kernel
            # passes them through exactly) so select policy, stabilization,
            # rate-limit policies, and bounds still apply ON DEVICE
            name = algorithms.algorithm_name(ha)
            custom = None
            if name != algorithms.DEFAULT_ALGORITHM:
                # instances are memoized PER ENGINE, not per process:
                # stateful algorithms (trend windows) must survive
                # across reconciles but never leak across runtimes or
                # share clocks with another engine's fake time
                custom = self._algorithm_instances.get(name)
                if custom is None:
                    custom = algorithms.for_spec(ha)
                    self._algorithm_instances[name] = custom
            row.custom = custom is not None
            for j, metric_spec in enumerate(ha.spec.metrics):
                observed = self._observe_metric(ha, j, metric_spec, row)
                target = metric_spec.get_target()
                row.observed.append((metric_spec, target, observed.value))
                if custom is not None:
                    metric = algorithms.Metric(
                        value=observed.value,
                        target_type=target.type,
                        target_value=target.target_value(),
                        name=getattr(observed, "name", ""),
                        # labels distinguish two specs over the same
                        # metric name — stateful algorithms (trend) key
                        # windows on them, or a sawtooth of interleaved
                        # series would fit garbage slopes
                        labels=dict(
                            getattr(observed, "labels", {}) or {}
                        ),
                        # stateful algorithms key history on the OWNING
                        # autoscaler and order it by this clock
                        owner=(
                            ha.metadata.namespace,
                            ha.metadata.name,
                        ),
                        at=self.clock(),
                    )
                    row.values.append(
                        float(
                            custom.get_desired_replicas(
                                metric, row.scale.status_replicas
                            )
                        )
                    )
                    row.targets.append(1.0)
                    row.types.append(D.TYPE_AVERAGE_VALUE)
                else:
                    row.values.append(observed.value)
                    row.targets.append(target.target_value())
                    row.types.append(
                        _TYPE_CODES.get(target.type, D.TYPE_UNKNOWN)
                    )
        except NotFoundError as e:
            # a missing scale target is RETRYABLE: the target may be
            # created any moment, and its creation fires no watch event
            # on the HA — deactivation would strand the autoscaler
            # (engine ladder: docs/resilience.md). Lazy import: the
            # controllers package imports this module.
            from karpenter_tpu_torch.controllers.errors import RetryableError

            row.error = RetryableError(str(e), code="ScaleTargetNotFound")
            row.error.__cause__ = e
        except Exception as e:  # noqa: BLE001 - row-isolated failure
            row.error = e
        return row

    def _observe_metric(self, ha, j: int, metric_spec, row: _Row):
        """One metric read, with the stale-sample bridge: a failed query
        reuses the newest history sample when it is young enough
        (forecaster.stale_max_age_s), so a transient exporter blip
        degrades ONE input instead of dropping the whole row from the
        batch. Older-than-bound history re-raises — an autoscaler must
        not keep scaling on a signal that has been dark for minutes."""
        # lazy import (the controllers package imports this module)
        from karpenter_tpu_torch.metrics.clients import MetricQueryError

        try:
            return self.metrics.for_metric(metric_spec).get_current_value(
                metric_spec
            )
        except MetricQueryError:
            if self.forecaster is None:
                raise
            value = self.forecaster.stale_value(ha, j, self.clock())
            if value is None:
                raise
            row.stale_metrics.add(j)
            from karpenter_tpu_torch.metrics.types import Metric as MetricValue

            return MetricValue(
                name=(
                    metric_spec.prometheus.query
                    if metric_spec.prometheus is not None
                    else ""
                ),
                value=value,
            )

    # -- batch reconcile --------------------------------------------------

    def reconcile_batch(
        self, has: List[HorizontalAutoscaler]
    ) -> Dict[tuple, Optional[Exception]]:
        """Returns {(namespace, name): error or None}; mutates each HA's status."""
        key = lambda ha: (ha.metadata.namespace, ha.metadata.name)
        results: Dict[tuple, Optional[Exception]] = {}
        rows = [self._snapshot_row(ha) for ha in has]
        live = [r for r in rows if r.error is None]
        for row in rows:
            if row.error is not None:
                results[key(row.ha)] = row.error

        if live:
            outputs = self._evaluate_live(live)
            now = self.clock()
            for i, row in enumerate(live):
                self._apply(row, outputs, i, now)
                results[key(row.ha)] = None
        return results

    def _evaluate_live(self, live: List[_Row]) -> D.DecisionOutputs:
        """Forecast -> decide -> cost-refine the live rows, with the
        provenance ledger batch (when enabled) annotated at each stage
        and committed once the final counts are known."""
        ledger_batch = self._begin_ledger(live)
        # PoolGroup membership resolves ONCE per tick (store list +
        # name matching); None = no group participates and every path
        # below is byte-identical to the pre-subsystem wire
        pg_plan = None
        if self.pool_engine is not None:
            pg_plan = self.pool_engine.plan(live)
        if self.fused_tick_fn is not None:
            outputs = self._evaluate_fused(live, ledger_batch, pg_plan)
        else:
            # the forecast pass: ingest this tick's observations into
            # the history store and predict every eligible series in ONE
            # batched dispatch; {} (no spec, warming up, skill-gated, or
            # ANY failure) keeps the tick purely reactive
            forecasts: Dict[tuple, float] = {}
            if self.forecaster is not None:
                forecasts = self.forecaster.forecast_rows(
                    live, self.clock()
                )
            outputs = self._decide(live, forecasts)
            if ledger_batch is not None:
                n = len(live)
                ledger_batch.annotate(
                    base_desired=np.asarray(outputs.desired)[:n],
                    final_desired=np.asarray(outputs.desired)[:n],
                )
            if self.cost_engine is not None:
                # the multi-objective pass (docs/cost.md): ONE batched
                # refine of the whole fleet's desired counts; any
                # failure returns the base outputs (never-block) and
                # an SLO-free fleet returns the SAME object untouched.
                # PoolGroup members skip the independent ladder — the
                # joint pass below owns their counts this tick.
                outputs = self.cost_engine.adjust(
                    live, outputs,
                    exclude=pg_plan.grouped if pg_plan is not None else None,
                )
                if ledger_batch is not None:
                    ledger_batch.annotate(
                        final_desired=np.asarray(
                            outputs.desired
                        )[:len(live)],
                    )
            if pg_plan is not None:
                # the joint allocation (docs/poolgroups.md): every
                # group's K^P candidate ladder in ONE batched dispatch,
                # desired overlaid at the member rows; never-block —
                # failure leaves the uncoordinated counts standing
                outputs = self.pool_engine.refine(live, pg_plan, outputs)
                if ledger_batch is not None:
                    ledger_batch.annotate(
                        final_desired=np.asarray(
                            outputs.desired
                        )[:len(live)],
                    )
        if ledger_batch is not None:
            from karpenter_tpu_torch.observability import default_ledger

            default_ledger().commit(ledger_batch)
        return outputs

    def _evaluate_fused(self, live: List[_Row], ledger_batch, pg_plan=None):  # lint: allow-complexity — four optional stages x plan/commit halves around ONE dispatch; splitting would scatter each stage's paired halves
        """The fused steady-state tick (--fused-tick, ops/fusedtick.py):
        forecast → decide → cost as ONE SolverService.fused_tick call,
        with each engine's host bookkeeping split into plan/commit
        halves around the single dispatch. Every seam keeps its own
        never-block posture — fused_plan/fused_operands return None
        instead of raising (the stage is then simply absent, exactly
        the chained path's degradation), and the service ladder covers
        device-side failures (fused → chained per-stage → numpy) — so
        the fixed point matches the chained wire bit for bit
        (tests/test_fusedtick.py)."""
        from karpenter_tpu_torch.ops import fusedtick as FT

        now = self.clock()
        plan = None
        if self.forecaster is not None:
            plan = self.forecaster.fused_plan(live, now)
        inputs = self._decision_inputs(live, None)
        kw = {}
        if plan is not None:
            _eligible, finputs, row_map, col_map, need, blend = plan
            kw.update(
                forecast=finputs,
                series_row=row_map,
                series_col=col_map,
                series_need=need,
                series_blend=blend,
            )
        cost_plan = None
        if self.cost_engine is not None:
            cost_plan = self.cost_engine.fused_operands(
                live,
                int(inputs.spec_replicas.shape[0]),
                int(inputs.metric_value.shape[1]),
                exclude=pg_plan.grouped if pg_plan is not None else None,
            )
            if cost_plan is not None:
                kw.update(cost_plan[1])
        pg_ops = None
        if pg_plan is not None:
            pg_ops = self.pool_engine.fused_operands(
                live, pg_plan,
                int(inputs.spec_replicas.shape[0]),
                int(inputs.metric_value.shape[1]),
            )
            if pg_ops is not None:
                kw["poolgroup"] = pg_ops
        with default_tracer().span("autoscaler.fused_tick"):
            out = self.fused_tick_fn(
                FT.FusedTickInputs(decision=inputs, **kw)
            )
        if plan is not None and out.forecast is not None:
            self.forecaster.fused_commit(plan[0], out.forecast, live, now)
        outputs = out.decision
        if ledger_batch is not None:
            n = len(live)
            ledger_batch.annotate(
                base_desired=np.asarray(outputs.desired)[:n],
                final_desired=np.asarray(outputs.desired)[:n],
            )
        if cost_plan is not None and out.cost is not None:
            outputs = self.cost_engine.fused_commit(
                live, cost_plan[0], outputs, out.cost
            )
            if ledger_batch is not None:
                ledger_batch.annotate(
                    final_desired=np.asarray(
                        outputs.desired
                    )[:len(live)],
                )
        if pg_ops is not None and out.poolgroup is not None:
            outputs = self.pool_engine.fused_commit(
                live, pg_plan, outputs, out.poolgroup
            )
            if ledger_batch is not None:
                ledger_batch.annotate(
                    final_desired=np.asarray(
                        outputs.desired
                    )[:len(live)],
                )
        return outputs

    def _begin_ledger(self, live: List[_Row]):
        """Open the tick's provenance batch (observability/provenance):
        one record per live HorizontalAutoscaler, annotated in place by
        the forecast pass, the cost refinement, and the solver decide
        as the batch flows through them. None (one attribute read) when
        the ledger is disabled — the default posture."""
        from karpenter_tpu_torch.observability import default_ledger
        from karpenter_tpu_torch.observability.provenance import OBSERVED_WIDTH

        ledger = default_ledger()
        if not ledger.enabled:
            return None
        n = len(live)
        observed = np.zeros((n, OBSERVED_WIDTH), np.float32)
        observed_n = np.zeros(n, np.int16)
        for i, row in enumerate(live):
            m = min(len(row.values), OBSERVED_WIDTH)
            observed[i, :m] = row.values[:m]
            observed_n[i] = len(row.values)
        return ledger.begin(
            "ha",
            n,
            autosolver=True,
            tenant=self.tenant,
            namespace=[r.ha.metadata.namespace for r in live],
            name=[r.ha.metadata.name for r in live],
            group=[r.ha.spec.scale_target_ref.name for r in live],
            observed=observed,
            observed_n=observed_n,
            prev_replicas=np.asarray(
                [r.scale.status_replicas for r in live], np.int32
            ),
        )

    def _decide(
        self, rows: List[_Row], forecasts: Optional[Dict[tuple, float]] = None
    ) -> D.DecisionOutputs:
        inputs = self._decision_inputs(rows, forecasts)
        with default_tracer().span("autoscaler.decide"):
            return self.decider(inputs)

    def _decision_inputs(
        self, rows: List[_Row], forecasts: Optional[Dict[tuple, float]] = None
    ) -> D.DecisionInputs:
        n = D.pad_to(len(rows))
        m = max(1, max(len(r.values) for r in rows))

        def pad2(getter, fill, dtype):
            arr = np.full((n, m), fill, dtype)
            for i, r in enumerate(rows):
                vals = getter(r)
                arr[i, : len(vals)] = vals
            return arr

        valid = np.zeros((n, m), bool)
        for i, r in enumerate(rows):
            valid[i, : len(r.values)] = True

        def col(fn, fill, dtype):
            arr = np.full(n, fill, dtype)
            for i, r in enumerate(rows):
                arr[i] = fn(i, r)
            return arr

        # one (up, down) rules resolution per row, reused by all four columns
        resolved_rules = [
            (
                r.ha.spec.behavior.scale_up_rules(),
                r.ha.spec.behavior.scale_down_rules(),
            )
            for r in rows
        ]

        # Count/Percent policy slots: K padded to a power of two — the row
        # axis is already padded (pad_to above) to keep decide_jit's
        # compiled shape stable, and the K axis must not undo that by
        # retracing when one autoscaler gains a second policy
        widest = max(
            [1]
            + [
                len(rules.policies or [])
                for pair in resolved_rules
                for rules in pair
            ]
        )
        k = 1 << (widest - 1).bit_length() if widest > 1 else 1

        def policy_slots(direction: int):
            ptype = np.zeros((n, k), np.int32)
            pvalue = np.zeros((n, k), np.int32)
            pperiod = np.ones((n, k), np.int32)
            pvalid = np.zeros((n, k), bool)
            for i in range(len(rows)):
                for j, policy in enumerate(
                    resolved_rules[i][direction].policies or []
                ):
                    ptype[i, j] = (
                        D.POLICY_TYPE_PERCENT
                        if policy.type == PERCENT_SCALING_POLICY
                        else D.POLICY_TYPE_COUNT
                    )
                    pvalue[i, j] = policy.value
                    pperiod[i, j] = policy.period_seconds
                    pvalid[i, j] = True
            # plain numpy: the local jitted kernel converts on entry; the
            # remote decider serializes host bytes (no device work here)
            return (ptype, pvalue, pperiod, pvalid)

        up_ptype, up_pvalue, up_pperiod, up_pvalid = policy_slots(0)
        down_ptype, down_pvalue, down_pperiod, down_pvalid = policy_slots(1)

        # proactive blend operands: predicted metric values slot into
        # the same [N, M] layout; absent forecasts leave the fields None
        # so a reactive-only fleet keeps the pre-forecast program
        forecast_value = forecast_valid = None
        if forecasts:
            forecast_value = np.zeros((n, m), np.float32)
            forecast_valid = np.zeros((n, m), bool)
            for (i, j), predicted in forecasts.items():
                forecast_value[i, j] = predicted
                forecast_valid[i, j] = True

        now = np.float32(self.clock() - self.epoch)
        inputs = D.DecisionInputs(
            metric_value=pad2(lambda r: r.values, 0.0, np.float32),
            target_value=pad2(lambda r: r.targets, 0.0, np.float32),
            target_type=pad2(lambda r: r.types, D.TYPE_UNKNOWN, np.int32),
            metric_valid=valid,
            spec_replicas=col(lambda i, r: r.scale.spec_replicas or 0, 0, np.int32),
            status_replicas=col(lambda i, r: r.scale.status_replicas, 0, np.int32),
            min_replicas=col(lambda i, r: r.ha.spec.min_replicas, 0, np.int32),
            max_replicas=col(lambda i, r: r.ha.spec.max_replicas, 0, np.int32),
            up_window=col(
                lambda i, r: resolved_rules[i][0].stabilization_window_seconds,
                0,
                np.int32,
            ),
            down_window=col(
                lambda i, r: resolved_rules[i][1].stabilization_window_seconds,
                0,
                np.int32,
            ),
            up_policy=col(
                lambda i, r: _POLICY_CODES.get(
                    resolved_rules[i][0].select_policy, D.POLICY_MAX
                ),
                D.POLICY_MAX,
                np.int32,
            ),
            down_policy=col(
                lambda i, r: _POLICY_CODES.get(
                    resolved_rules[i][1].select_policy, D.POLICY_MAX
                ),
                D.POLICY_MAX,
                np.int32,
            ),
            last_scale_time=col(
                lambda i, r: (r.ha.status.last_scale_time or 0.0) - self.epoch,
                0.0,
                np.float32,
            ),
            has_last_scale=col(
                lambda i, r: r.ha.status.last_scale_time is not None,
                False,
                bool,
            ),
            now=np.float32(now),
            up_ptype=up_ptype,
            up_pvalue=up_pvalue,
            up_pperiod=up_pperiod,
            up_pvalid=up_pvalid,
            down_ptype=down_ptype,
            down_pvalue=down_pvalue,
            down_pperiod=down_pperiod,
            down_pvalid=down_pvalid,
            forecast_value=forecast_value,
            forecast_valid=forecast_valid,
        )
        return inputs

    def _mark_forecast_condition(self, ha, mgr) -> None:
        """Predictive posture on status (docs/forecasting.md): True
        while forecasts blend into scale-up, False (with the structured
        reason) while degraded to reactive-only — warming up, skill
        below the floor, or the forecast path failing. A spec that
        opted back OUT drops the condition entirely: a frozen last
        value would keep reporting a posture nothing computes."""
        if ha.spec.behavior.forecast is not None and self.forecaster is not None:
            active, reason, message = self.forecaster.verdict(
                ha.metadata.namespace, ha.metadata.name
            )
            if active:
                mgr.mark_true(cond.FORECASTING)
            else:
                mgr.mark_false(cond.FORECASTING, reason, message)
        else:
            ha.status.conditions[:] = [
                c for c in ha.status.conditions
                if c.type != cond.FORECASTING
            ]

    def _apply(self, row: _Row, out: D.DecisionOutputs, i: int, now: float):
        """Write back one row's decision (reference: autoscaler.go:81-113,
        155-194 for the condition semantics)."""
        ha, scale = row.ha, row.scale
        mgr = ha.status_conditions()
        desired = int(out.desired[i])
        recommendation = int(out.recommendation[i])
        able = bool(out.able_to_scale[i])
        unbounded = bool(out.scaling_unbounded[i])
        rate_limited = bool(out.rate_limited[i])

        ha.status.current_replicas = scale.status_replicas

        # last-read state of every configured metric: the reference MODELS
        # status.currentMetrics (horizontalautoscaler_status.go:36-39) but
        # never populates it — here every reconcile records what it saw,
        # slotted by the spec's own target type
        ha.status.current_metrics = [
            _metric_status(metric_spec, target, value)
            for metric_spec, target, value in row.observed
        ]

        if able:
            # a partial policy clamp still scales (just by less than
            # recommended), so AbleToScale stays true; the clamp itself is
            # visible through desired < recommendation in status
            mgr.mark_true(cond.ABLE_TO_SCALE)
        else:
            able_at = self.epoch + float(out.able_at[i])
            stamp = datetime.datetime.fromtimestamp(
                able_at, datetime.timezone.utc
            ).strftime("%Y-%m-%dT%H:%M:%SZ")
            held_by = (
                "scaling policy budget spent"
                if rate_limited
                else "within stabilization window"
            )
            mgr.mark_false(
                cond.ABLE_TO_SCALE,
                "",
                f"{held_by}, able to scale at {stamp}",
            )

        if unbounded:
            mgr.mark_true(cond.SCALING_UNBOUNDED)
        else:
            # the kernel's post-window/policy pre-[min,max] value: exactly
            # what the bounds clamp saw (NOT the raw recommendation, which
            # a partial policy clamp may already have reduced)
            limited = int(out.limited[i])
            mgr.mark_false(
                cond.SCALING_UNBOUNDED,
                "",
                f"recommendation {limited} limited by bounds "
                f"[{ha.spec.min_replicas}, {ha.spec.max_replicas}]",
            )

        self._mark_forecast_condition(ha, mgr)

        if scale.spec_replicas is not None and desired == scale.spec_replicas:
            return
        scale.spec_replicas = desired
        self.store.update_scale(
            ha.spec.scale_target_ref.kind, scale,
            api_version=ha.spec.scale_target_ref.api_version,
        )
        ha.status.desired_replicas = desired
        ha.status.last_scale_time = now


def _metric_status(metric_spec, target, value: float):
    current = MetricValueStatus()
    # a NaN/inf observation is legitimate (e.g. reserved-capacity over an
    # empty node group, the reference's NaN case) — record NO value rather
    # than poisoning the status document (json.dumps emits the non-standard
    # NaN literal, which a real apiserver rejects, killing the whole
    # status patch)
    if not math.isfinite(value):
        pass
    elif target.type == UTILIZATION:
        current.average_utilization = int(round(value * 100))
    elif target.type == AVERAGE_VALUE:
        current.average_value = value
    else:
        current.value = value
    query = (
        metric_spec.prometheus.query
        if metric_spec.prometheus is not None
        else ""
    )
    return MetricStatus(
        prometheus=PrometheusMetricStatus(query=query, current=current)
    )


class AutoscalerFactory:
    """reference: autoscaler.go:38-69 — kept for per-object call sites; the
    controller uses the batch path."""

    def __init__(
        self, metrics_client_factory, store: Store, clock=_time.time,
        decider=None, forecaster=None, cost_engine=None,
    ):
        self.batch = BatchAutoscaler(
            metrics_client_factory, store, clock, decider=decider,
            forecaster=forecaster, cost_engine=cost_engine,
        )

    def reconcile(self, ha: HorizontalAutoscaler) -> None:
        error = self.batch.reconcile_batch([ha])[
            (ha.metadata.namespace, ha.metadata.name)
        ]
        if error is not None:
            raise error
