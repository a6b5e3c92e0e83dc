"""CostEngine: host-side orchestration of the multi-objective refine.

Rides the BatchAutoscaler's per-tick pass (docs/cost.md): after the
reactive/forecast-blended fleet decide lands, `adjust()` builds ONE
CostInputs matrix for every SLO-opted HorizontalAutoscaler — unit cost
from the scale target through the CostModel, per-metric demand
distribution from the FleetForecaster (observed value with sigma 0 when
no forecast), SLO targets from spec.behavior.slo — and submits it as a
single batched dispatch through the `cost_fn` seam (SolverService.cost
in production: backend-health FSM, `cost.score` fault point, numpy
mirror as the requested-CPU backend).

Contracts:

  * NEVER-BLOCK — adjust() never raises. Any failure (a cost-kernel
    fault past the service, a poisoned spec, a missing scale target)
    logs, counts karpenter_cost_blind_total, and returns the base
    outputs untouched: the tick proceeds COST-BLIND, exactly as if the
    subsystem didn't exist. Unlike the forecast path there is no host
    re-score on failure — the refinement is advisory, and the safe
    degradation is the unrefined decision, not host CPU spent
    re-scoring every tick through an outage.
  * ZERO-OVERHEAD OPT-OUT — a fleet with no spec.behavior.slo returns
    the SAME outputs object with no arrays built and no dispatch.
  * WARM-POOL SIGNAL — each pass refreshes its rows' per-HA headroom
    contributions (the kernel's one-sigma demand surplus; headroom()
    maxes them per scale target), which WarmPoolEngine sizes
    spec.warmPool from. A row that drops its SLO spec loses its
    contribution on the next pass, and prune() retires a DELETED HA's
    immediately, so a group's warm pool decays to minWarm instead of
    pinning stale risk forever.
  * BEHAVIOR-BOUNDED — the candidate ladder is clamped to the decide
    kernel's per-tick movement bounds (DecisionOutputs
    up_ceiling/down_floor), so the refinement converges over ticks at
    the rate the operator's scaleUp/scaleDown rules allow instead of
    outrunning them.

Metrics: karpenter_cost_{expected_hourly,violation_risk} gauges per HA
and karpenter_cost_{adjusted,blind}_total counters.

The port's copy of karpenter_tpu/cost/engine.py, changed only in its
imports and as noted. The default cost_fn is the port's cost program on
the card (ops/cost.cost_host).
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.cost.model import CostModel
from karpenter_tpu_torch.ops import cost as CK
from karpenter_tpu_torch.ops import decision as D
from karpenter_tpu_torch.utils.log import logger

SUBSYSTEM = "cost"


class CostEngine:
    """One per runtime (see module docstring).

    `cost_fn` is the device seam: any (CostInputs) -> CostOutputs
    callable — SolverService.cost in production (runtime.py wiring),
    the jitted kernel directly when standalone."""

    def __init__(
        self,
        store=None,
        cost_fn=None,
        model: Optional[CostModel] = None,
        forecaster=None,
        registry=None,
    ):
        self.store = store
        self.cost_fn = cost_fn if cost_fn is not None else CK.cost_host
        self.model = model if model is not None else CostModel()
        self.forecaster = forecaster
        # (ns, ha-name) -> ((ns, scale-target name), one-sigma headroom
        # replicas): per-HA contributions, so a batch pass refreshes its
        # OWN rows' entries, a row that drops its SLO spec loses its
        # entry, and prune() retires a DELETED HA's entry even though no
        # pass will ever see it again (stale-target decay — module
        # docstring)
        self._contrib: Dict[
            Tuple[str, str], Tuple[Tuple[str, str], int]
        ] = {}
        self._g_hourly = self._g_risk = None
        self._c_adjusted = self._c_blind = None
        if registry is not None:
            self._g_hourly = registry.register(SUBSYSTEM, "expected_hourly")
            self._g_risk = registry.register(SUBSYSTEM, "violation_risk")
            self._c_adjusted = registry.register(
                SUBSYSTEM, "adjusted_total", kind="counter"
            )
            self._c_blind = registry.register(
                SUBSYSTEM, "blind_total", kind="counter"
            )

    # -- warm-pool face ----------------------------------------------------

    def headroom(self, namespace: str, name: str) -> int:
        """One-sigma demand replicas beyond the chosen desired, maxed
        over the HAs targeting this group — WarmPoolEngine's risk
        input."""
        key = (namespace, name)
        return max(
            (h for group, h in self._contrib.values() if group == key),
            default=0,
        )

    def prune(self, namespace: str, name: str) -> None:
        """Forget a deleted HorizontalAutoscaler (HA controller
        on_deleted hook): gauges AND its headroom contribution — a
        deleted HA never appears in another pass, so without this its
        group would hold risk-sized warm capacity forever."""
        self._contrib.pop((namespace, name), None)
        if self._g_hourly is not None:
            self._g_hourly.remove(name, namespace)
            self._g_risk.remove(name, namespace)

    def _retire(self, namespace: str, name: str) -> None:
        """A row stopped opting in (dropped spec.behavior.slo): drop its
        headroom contribution AND its gauge series — a frozen
        pre-opt-out karpenter_cost_* value would mislead dashboards
        exactly like stale headroom would mis-size warm pools."""
        if self._contrib.pop((namespace, name), None) is None:
            return
        if self._g_hourly is not None:
            self._g_hourly.remove(name, namespace)
            self._g_risk.remove(name, namespace)

    # -- the per-tick pass -------------------------------------------------

    def adjust(self, rows: List, outputs: D.DecisionOutputs, exclude=None):
        """The BatchAutoscaler's post-decide call: refine the fleet's
        desired counts in one batched dispatch. Returns `outputs`
        unchanged (the SAME object) when no row opts in; never raises
        (module docstring never-block contract). `exclude` drops row
        indices whose counts another refiner owns this tick (PoolGroup
        members — docs/poolgroups.md): they skip the independent ladder
        entirely, and _apply's retire diff drops their cost series the
        moment they join a group."""
        slo_rows = [
            i for i, row in enumerate(rows)
            if getattr(row.ha.spec.behavior, "slo", None) is not None
            and not getattr(row, "custom", False)
            and (exclude is None or i not in exclude)
        ]
        if not slo_rows:
            for row in rows:
                self._retire(*_ha_key(row.ha))
            return outputs
        try:
            inputs = self._build_inputs(rows, slo_rows, outputs)
            out = self.cost_fn(inputs)
            return self._apply(rows, slo_rows, outputs, out)
        except Exception as error:  # noqa: BLE001 — never-block contract
            logger().warning(
                "cost refinement failed (%s: %s); this tick scales "
                "cost-blind", type(error).__name__, error,
            )
            self._annotate_blind(slo_rows)
            for i in slo_rows:
                ns, name = _ha_key(rows[i].ha)
                if self._c_blind is not None:
                    self._c_blind.inc(name, ns)
            return outputs

    def fused_operands(self, rows: List, n: int, m: int, exclude=None):
        """Host half of the fused tick's cost stage (ops/fusedtick.py):
        the _build_inputs surface SPLIT at the demand seam. Spec bounds
        (ha_min/ha_max), pricing, and SLO targets assemble as before,
        but the movement-bound clamp and the _demand() selection move
        IN-DEVICE: the kernel clamps against the decide stage's fresh
        up_ceiling/down_floor and overlays the in-device distribution
        refresh over the PRIOR distribution read here — reproducing the
        chained path's post-refresh read bit for bit. distribution() is
        consulted under exactly _demand()'s gates (per-replica capacity
        declared AND observed finite), so its expiry side effects match
        the chained tick too. Returns (slo_rows, operands dict), or
        None when no row opts in (adjust()'s retire semantics apply) or
        the assembly fails (the cost-blind posture, already stamped).
        `exclude` mirrors adjust()'s: rows a PoolGroup owns this tick
        skip the independent ladder."""
        slo_rows = [
            i for i, row in enumerate(rows)
            if getattr(row.ha.spec.behavior, "slo", None) is not None
            and not getattr(row, "custom", False)
            and (exclude is None or i not in exclude)
        ]
        if not slo_rows:
            for row in rows:
                self._retire(*_ha_key(row.ha))
            return None
        try:
            return slo_rows, self._fused_operand_arrays(rows, slo_rows, n, m)
        except Exception as error:  # noqa: BLE001 — never-block contract
            logger().warning(
                "cost operand assembly failed (%s: %s); this tick "
                "scales cost-blind", type(error).__name__, error,
            )
            self._annotate_blind(slo_rows)
            for i in slo_rows:
                ns, name = _ha_key(rows[i].ha)
                if self._c_blind is not None:
                    self._c_blind.inc(name, ns)
            return None

    def _fused_operand_arrays(
        self, rows: List, slo_rows: List[int], n: int, m: int
    ) -> dict:
        ha_min = np.zeros(n, np.int32)
        ha_max = np.zeros(n, np.int32)
        unit_cost = np.zeros(n, np.float32)
        slo_weight = np.zeros(n, np.float32)
        max_hourly = np.zeros(n, np.float32)
        slo_valid = np.zeros(n, bool)
        slo_target = np.ones((n, m), np.float32)
        observed_arr = np.zeros((n, m), np.float32)
        demand_base_valid = np.zeros((n, m), bool)
        prior_point = np.zeros((n, m), np.float32)
        prior_sigma2 = np.zeros((n, m), np.float32)
        prior_valid = np.zeros((n, m), bool)
        for i in slo_rows:
            row = rows[i]
            slo = row.ha.spec.behavior.slo
            ns, name = _ha_key(row.ha)
            ha_min[i] = row.ha.spec.min_replicas
            ha_max[i] = row.ha.spec.max_replicas
            unit_cost[i] = self._unit_cost(row.ha)
            slo_weight[i] = slo.violation_cost_weight
            max_hourly[i] = slo.max_hourly_cost
            slo_valid[i] = True
            for j, (_spec, target, observed) in enumerate(row.observed):
                per_replica = slo.target_for(j)
                if not per_replica:
                    per_replica = target.target_value()
                if not per_replica or per_replica <= 0:
                    continue  # no capacity notion: metric carries no risk
                slo_target[i, j] = per_replica
                observed_arr[i, j] = observed
                if not math.isfinite(observed):
                    continue  # _demand()'s early return: no dist read
                demand_base_valid[i, j] = True
                if self.forecaster is None:
                    continue
                dist = self.forecaster.distribution(ns, name, j)
                if dist is not None:
                    prior_point[i, j] = dist[0]
                    prior_sigma2[i, j] = dist[1]
                    prior_valid[i, j] = True
        return {
            "ha_min": ha_min,
            "ha_max": ha_max,
            "unit_cost": unit_cost,
            "slo_weight": slo_weight,
            "max_hourly_cost": max_hourly,
            "slo_valid": slo_valid,
            "slo_target": slo_target,
            "observed": observed_arr,
            "demand_base_valid": demand_base_valid,
            "prior_point": prior_point,
            "prior_sigma2": prior_sigma2,
            "prior_valid": prior_valid,
        }

    def fused_commit(
        self, rows: List, slo_rows: List[int],
        outputs: D.DecisionOutputs, out: CK.CostOutputs,
    ) -> D.DecisionOutputs:
        """Bookkeeping for a fused tick's cost stage: exactly adjust()'s
        post-dispatch half — ledger provenance, gauge/contribution
        refresh, the desired overlay — given the CostOutputs the fused
        program returned. Same never-block posture as adjust()."""
        try:
            return self._apply(rows, slo_rows, outputs, out)
        except Exception as error:  # noqa: BLE001 — never-block contract
            logger().warning(
                "cost refinement failed (%s: %s); this tick scales "
                "cost-blind", type(error).__name__, error,
            )
            self._annotate_blind(slo_rows)
            for i in slo_rows:
                ns, name = _ha_key(rows[i].ha)
                if self._c_blind is not None:
                    self._c_blind.inc(name, ns)
            return outputs

    @staticmethod
    def _annotate_blind(slo_rows: List[int]) -> None:
        """Provenance: a cost-blind tick is itself an answer to 'why is
        the count what it is' — stamp the opted-in rows so the ledger
        record names the degradation instead of looking unrefined."""
        from karpenter_tpu_torch.observability import default_ledger

        batch = default_ledger().current()  # None when disabled
        if batch is not None:
            rows = [i for i in slo_rows if i < batch.n]
            if rows:
                batch.annotate_rows(rows, slo_opted=True, cost_blind=True)

    def _unit_cost(self, ha) -> float:
        """Hourly cost per replica of this HA's scale target: the
        target resource (a ScalableNodeGroup's annotations/tier) priced
        through the CostModel; targets the store can't resolve price at
        the model default."""
        target = None
        ref = ha.spec.scale_target_ref
        if self.store is not None and ref.kind and ref.name:
            try:
                target = self.store.try_get(
                    ref.kind, ha.metadata.namespace, ref.name
                )
            except Exception:  # noqa: BLE001 — unknown kinds price default
                target = None
        return self.model.unit_cost(target)

    def _demand(self, row, j: int, observed: float):
        """(mu, sigma, valid) for one metric: the forecast distribution
        when the forecaster has one (demand can only be raised by the
        forecast — max(observed, point), the same monotone-up posture
        the blend takes), else the observed value with sigma 0."""
        if not math.isfinite(observed):
            return 0.0, 0.0, False
        mu, sigma = observed, 0.0
        if self.forecaster is not None:
            ns, name = _ha_key(row.ha)
            dist = self.forecaster.distribution(ns, name, j)
            if dist is not None:
                point, sigma2 = dist
                if math.isfinite(point):
                    mu = max(observed, point)
                if math.isfinite(sigma2) and sigma2 > 0:
                    sigma = math.sqrt(sigma2)
        return mu, sigma, True

    def _build_inputs(
        self, rows: List, slo_rows: List[int], outputs: D.DecisionOutputs
    ) -> CK.CostInputs:
        """One padded CostInputs matrix aligned row for row with the
        decide outputs (same pad_to bucket), slo_valid only on the
        opted-in rows so everything else passes through bit-identically."""
        base = np.asarray(outputs.desired, np.int32)
        n = base.shape[0]  # the decide pass's padded bucket
        m = max(1, max(len(r.values) for r in rows))
        min_replicas = np.zeros(n, np.int32)
        max_replicas = np.zeros(n, np.int32)
        unit_cost = np.zeros(n, np.float32)
        slo_weight = np.zeros(n, np.float32)
        max_hourly = np.zeros(n, np.float32)
        slo_valid = np.zeros(n, bool)
        slo_target = np.ones((n, m), np.float32)
        demand_mu = np.zeros((n, m), np.float32)
        demand_sigma = np.zeros((n, m), np.float32)
        demand_valid = np.zeros((n, m), bool)
        up_ceiling = np.asarray(outputs.up_ceiling, np.int32)
        down_floor = np.asarray(outputs.down_floor, np.int32)
        for i in slo_rows:
            row = rows[i]
            slo = row.ha.spec.behavior.slo
            ha_min = row.ha.spec.min_replicas
            ha_max = row.ha.spec.max_replicas
            # the candidate ladder honors the SAME per-tick movement
            # bounds the decide kernel enforced — stabilization windows
            # and scaleUp/scaleDown rate policies (DecisionOutputs
            # up_ceiling/down_floor) — so an SLO raise or budget trim
            # cannot outrun the operator's declared behavior; [min, max]
            # outranks the rate bound, exactly as in the decide clamp
            # order
            min_replicas[i] = max(ha_min, min(int(down_floor[i]), ha_max))
            max_replicas[i] = min(ha_max, max(int(up_ceiling[i]), ha_min))
            unit_cost[i] = self._unit_cost(row.ha)
            slo_weight[i] = slo.violation_cost_weight
            max_hourly[i] = slo.max_hourly_cost
            slo_valid[i] = True
            for j, (_spec, target, observed) in enumerate(row.observed):
                # per-metric SLO targets (spec.behavior.slo.metrics)
                # outrank the spec-wide targetValue; the kernel's max
                # over the metric axis keeps risk WORST-CASE across
                # however many of them the row declares
                per_replica = slo.target_for(j)
                if not per_replica:
                    per_replica = target.target_value()
                if not per_replica or per_replica <= 0:
                    continue  # no capacity notion: metric carries no risk
                mu, sigma, ok = self._demand(row, j, observed)
                slo_target[i, j] = per_replica
                demand_mu[i, j] = mu
                demand_sigma[i, j] = sigma
                demand_valid[i, j] = ok
        return CK.CostInputs(
            base_desired=base,
            min_replicas=min_replicas,
            max_replicas=max_replicas,
            unit_cost=unit_cost,
            slo_weight=slo_weight,
            max_hourly_cost=max_hourly,
            slo_valid=slo_valid,
            slo_target=slo_target,
            demand_mu=demand_mu,
            demand_sigma=demand_sigma,
            demand_valid=demand_valid,
        )

    def _apply(
        self, rows: List, slo_rows: List[int],
        outputs: D.DecisionOutputs, out: CK.CostOutputs,
    ) -> D.DecisionOutputs:
        desired = np.asarray(out.desired, np.int32)
        hourly = np.asarray(out.expected_hourly, np.float32)
        risk = np.asarray(out.violation_risk, np.float32)
        headroom = np.asarray(out.headroom, np.int32)
        self._annotate_ledger(rows, slo_rows, outputs, out)
        # every row in THIS batch re-establishes (or loses) its
        # contribution and gauges; rows outside the batch keep theirs
        # untouched
        slo_keys = {_ha_key(rows[i].ha) for i in slo_rows}
        for row in rows:
            if _ha_key(row.ha) not in slo_keys:
                self._retire(*_ha_key(row.ha))
        for i in slo_rows:
            ha = rows[i].ha
            ns, name = _ha_key(ha)
            if self._g_hourly is not None:
                self._g_hourly.set(name, ns, float(hourly[i]))
                self._g_risk.set(name, ns, float(risk[i]))
            if self._c_adjusted is not None:
                self._c_adjusted.inc(name, ns)
            ref = ha.spec.scale_target_ref
            self._contrib[(ns, name)] = ((ns, ref.name), int(headroom[i]))
        return replace(outputs, desired=desired)

    def _annotate_ledger(  # lint: allow-complexity — provenance assembly: one guard per clamp direction
        self, rows: List, slo_rows: List[int],
        outputs: D.DecisionOutputs, out: CK.CostOutputs,
    ) -> None:
        """Provenance slice (observability/provenance.py): the cost
        stage stamps the chosen ladder candidate with its risk/cost
        score and WHICH bound clamped it — the hard budget
        (cost_limited) or the decide kernel's per-tick movement bound
        (the candidate landed exactly on an up_ceiling/down_floor that
        is tighter than the spec's own [min, max]) — plus the one-sigma
        warm-pool headroom the candidate implies. One attribute read
        when the ledger is off."""
        from karpenter_tpu_torch.observability import default_ledger

        batch = default_ledger().current()  # None when disabled
        if batch is None:
            return
        idx = [i for i in slo_rows if i < batch.n]
        if not idx:
            return
        desired = np.asarray(out.desired, np.int64)
        base = np.asarray(outputs.desired, np.int64)
        hourly = np.asarray(out.expected_hourly, np.float32)
        risk = np.asarray(out.violation_risk, np.float32)
        up_ceiling = np.asarray(outputs.up_ceiling, np.int64)
        down_floor = np.asarray(outputs.down_floor, np.int64)
        n = batch.n
        movement = np.zeros(len(base), bool)
        score = np.zeros(len(base), np.float32)
        for i in idx:
            slo = rows[i].ha.spec.behavior.slo
            ha_min = rows[i].ha.spec.min_replicas
            ha_max = rows[i].ha.spec.max_replicas
            # the movement bound clamped iff the candidate sits ON the
            # rate-limited ceiling/floor AND that bound is tighter than
            # the spec bound it would otherwise have hit
            movement[i] = bool(
                (
                    desired[i] > base[i]
                    and up_ceiling[i] < ha_max
                    and desired[i] == min(
                        ha_max, max(int(up_ceiling[i]), ha_min)
                    )
                )
                or (
                    desired[i] < base[i]
                    and down_floor[i] > ha_min
                    and desired[i] == max(
                        ha_min, min(int(down_floor[i]), ha_max)
                    )
                )
            )
            # the kernel's objective at the chosen candidate:
            # violationCostWeight x risk + n x unitHourlyCost
            score[i] = (
                float(slo.violation_cost_weight) * float(risk[i])
                + float(hourly[i])
            )
        batch.annotate_rows(
            idx,
            slo_opted=True,
            cost_candidate=desired[:n].astype(np.int32),
            cost_risk=risk[:n],
            cost_hourly=hourly[:n],
            cost_score=score[:n],
            budget_clamped=np.asarray(out.cost_limited, bool)[:n],
            movement_clamped=movement[:n],
            warm_headroom=np.asarray(out.headroom, np.int32)[:n],
        )


def _ha_key(ha) -> Tuple[str, str]:
    return (ha.metadata.namespace, ha.metadata.name)
