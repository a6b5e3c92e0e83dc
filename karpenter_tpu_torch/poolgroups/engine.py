"""PoolGroupEngine: host-side orchestration of the joint allocation.

Rides the BatchAutoscaler's per-tick pass AFTER the cost refinement
(docs/poolgroups.md): plan() resolves every PoolGroup in the store
against the live rows — each member name must resolve to exactly one
live, non-custom HorizontalAutoscaler in the group's namespace, and a
group with ANY unresolvable member sits the tick out whole (a joint
allocation of half a group is worse than none). The resolved member
rows are EXCLUDED from the CostEngine's independent per-pool ladders
(the `exclude` seam) and refined here instead: one PoolGroupInputs
matrix for the whole fleet's groups, submitted as a SINGLE batched
dispatch through the `poolgroup_fn` seam (SolverService.poolgroup in
production: backend-health FSM, `poolgroup.solve` fault point, numpy
mirror as the requested-CPU backend, the enforce=False independent
ladder as the degraded rung). That is the dispatch collapse the
subsystem exists for: G groups x P pools ride ONE program instead of
G x P independent cost rungs.

Contracts (the CostEngine discipline, one rank up):

  * NEVER-BLOCK — refine() never raises. Any failure (a poisoned spec,
    a kernel fault past the service ladder) logs, counts
    karpenter_poolgroup_degraded_total per group, and returns the base
    outputs untouched: the tick proceeds UNCOORDINATED, exactly as if
    the groups didn't exist.
  * ZERO-OVERHEAD OPT-OUT — a fleet with no PoolGroup objects returns
    plan() None after one store list; the autoscaler wire is then
    byte-identical to the pre-subsystem plane (pinned in
    tests/test_poolgroup.py).
  * BEHAVIOR-BOUNDED — the joint ladder is clamped per pool to the
    decide kernel's movement bounds intersected with the member's own
    spec tightening; coordination can never outrun a pool's declared
    scaleUp/scaleDown behavior.
  * WARM-POOL SIGNAL — member pools contribute one-sigma headroom
    exactly like cost rows do; headroom() is an additional source the
    runtime maxes into WarmPoolEngine's.

Metrics: karpenter_poolgroup_{expected_hourly,ratio_ok} gauges per
group and karpenter_poolgroup_{coordinated,degraded}_total counters;
series retire when a group is deleted or stops resolving.

The port's copy of karpenter_tpu/poolgroups/engine.py, changed only in
its imports and as noted. The default poolgroup_fn is the port's joint
program on the card (ops/poolgroup.poolgroup_host).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.api import poolgroup as api_pg
from karpenter_tpu_torch.api.poolgroup import PoolGroup
from karpenter_tpu_torch.cost.model import CostModel
from karpenter_tpu_torch.ops import decision as D
from karpenter_tpu_torch.ops import poolgroup as PGK
from karpenter_tpu_torch.utils.log import logger

SUBSYSTEM = "poolgroup"

# the api package re-declares the kernel's static limits so it never
# imports jax — drift would mean admission admits what the kernel
# cannot represent, so it is a hard import-time error here
assert api_pg.MAX_POOLS == PGK.MAX_POOLS, "api/ops MAX_POOLS drift"
assert api_pg.RATIO_BOUND == PGK.RATIO_BOUND, "api/ops RATIO_BOUND drift"
assert api_pg.RATIO_SLOTS == PGK.RATIO_SLOTS, "api/ops RATIO_SLOTS drift"

# group-axis compile buckets: padded like every other fleet axis so a
# steady fleet never recompiles when one group comes or goes
_GROUP_BUCKET_FLOOR = 4


def pad_group_count(groups: int) -> int:
    bucket = _GROUP_BUCKET_FLOOR
    while bucket < groups:
        bucket *= 2
    return bucket


@dataclass
class PoolGroupPlan:
    """One tick's resolved membership: the groups that participate and
    the fleet-row index of every member pool (position-aligned with
    group.spec.pools)."""

    groups: List[Tuple[PoolGroup, List[int]]]
    # union of member row indices — the CostEngine exclusion set
    grouped: frozenset


class PoolGroupEngine:
    """One per runtime (see module docstring).

    `poolgroup_fn` is the device seam: any (PoolGroupInputs) ->
    PoolGroupOutputs callable — SolverService.poolgroup in production
    (runtime.py wiring), the jitted kernel directly when standalone."""

    def __init__(
        self,
        store=None,
        poolgroup_fn=None,
        model: Optional[CostModel] = None,
        forecaster=None,
        registry=None,
    ):
        self.store = store
        self.poolgroup_fn = (
            poolgroup_fn if poolgroup_fn is not None else PGK.poolgroup_host
        )
        self.model = model if model is not None else CostModel()
        self.forecaster = forecaster
        # (ns, ha-name) -> ((ns, scale-target name), one-sigma headroom
        # replicas) — the CostEngine contribution shape, so the warm
        # pool's max-over-sources works unchanged
        self._contrib: Dict[
            Tuple[str, str], Tuple[Tuple[str, str], int]
        ] = {}
        # (ns, group-name) keys currently holding gauge series — the
        # retirement diff set (group deleted / stopped resolving)
        self._live: set = set()
        self._g_hourly = self._g_ratio = None
        self._c_coordinated = self._c_degraded = None
        if registry is not None:
            self._g_hourly = registry.register(SUBSYSTEM, "expected_hourly")
            self._g_ratio = registry.register(SUBSYSTEM, "ratio_ok")
            self._c_coordinated = registry.register(
                SUBSYSTEM, "coordinated_total", kind="counter"
            )
            self._c_degraded = registry.register(
                SUBSYSTEM, "degraded_total", kind="counter"
            )

    # -- warm-pool face ----------------------------------------------------

    def headroom(self, namespace: str, name: str) -> int:
        """One-sigma demand replicas beyond the chosen desired, maxed
        over the member pools targeting this group — an additional
        WarmPoolEngine source (runtime maxes it with the cost
        engine's)."""
        key = (namespace, name)
        return max(
            (h for group, h in self._contrib.values() if group == key),
            default=0,
        )

    def prune(self, namespace: str, name: str) -> None:
        """Forget a deleted PoolGroup immediately (controller/delete
        hooks): its gauge series AND its members' headroom
        contributions — without this a deleted group would hold
        risk-sized warm capacity until the next refine pass diffs it
        away."""
        self._retire((namespace, name))

    def _retire(self, key: Tuple[str, str]) -> None:
        self._live.discard(key)
        ns, name = key
        if self._g_hourly is not None:
            self._g_hourly.remove(name, ns)
            self._g_ratio.remove(name, ns)

    def _sync_gauges(self, current: set) -> None:
        """Retire series for every group that held gauges last pass but
        does not participate now (deleted, invalid, or unresolvable)."""
        for key in list(self._live - current):
            self._retire(key)

    # -- membership resolution --------------------------------------------

    def plan(self, rows: List) -> Optional[PoolGroupPlan]:
        """Resolve the fleet's PoolGroups against this tick's live rows.
        Returns None when nothing participates (the zero-overhead
        opt-out: gauges of previously-live groups still retire). Never
        raises."""
        if self.store is None:
            return None
        try:
            groups = self.store.list(PoolGroup.KIND)
        except Exception:  # noqa: BLE001 — never-block contract
            groups = []
        if not groups:
            self._sync_gauges(set())
            if self._contrib:
                self._contrib.clear()
            return None
        index: Dict[Tuple[str, str], int] = {}
        for i, row in enumerate(rows):
            if getattr(row, "custom", False):
                continue  # a custom Algorithm owns this row's counts
            index[(row.ha.metadata.namespace, row.ha.metadata.name)] = i
        resolved: List[Tuple[PoolGroup, List[int]]] = []
        claimed: set = set()
        current: set = set()
        for group in groups:
            ns = group.metadata.namespace
            try:
                group.validate()
                idxs = [
                    index[(ns, member.name)]
                    for member in group.spec.pools
                ]
            except Exception as error:  # noqa: BLE001 — skip whole group
                logger().warning(
                    "pool group %s/%s sits this tick out (%s: %s)",
                    ns, group.metadata.name,
                    type(error).__name__, error,
                )
                continue
            if claimed & set(idxs):
                # an HA can belong to ONE group per tick; first listed
                # group wins, later claimants scale uncoordinated
                logger().warning(
                    "pool group %s/%s overlaps an earlier group's "
                    "members; it sits this tick out",
                    ns, group.metadata.name,
                )
                continue
            claimed |= set(idxs)
            resolved.append((group, idxs))
            current.add((ns, group.metadata.name))
        self._sync_gauges(current)
        if not resolved:
            self._contrib.clear()
            return None
        # drop contributions of HAs that left every group (the cost
        # engine's retire posture, keyed by membership instead of spec)
        member_keys = {
            (g.metadata.namespace, g.spec.pools[p].name)
            for g, _ in resolved
            for p in range(len(g.spec.pools))
        }
        for key in list(self._contrib):
            if key not in member_keys:
                self._contrib.pop(key, None)
        return PoolGroupPlan(
            groups=resolved,
            grouped=frozenset(claimed),
        )

    # -- the per-tick pass -------------------------------------------------

    def refine(
        self, rows: List, plan: PoolGroupPlan, outputs: D.DecisionOutputs
    ) -> D.DecisionOutputs:
        """The BatchAutoscaler's post-cost call: ONE batched joint
        dispatch for every group, desired counts overlaid at the member
        rows. Returns `outputs` untouched on any failure (never-block:
        the tick proceeds uncoordinated)."""
        try:
            inputs = self._build_inputs(rows, plan, outputs)
            out = self.poolgroup_fn(inputs)
            return self._apply(rows, plan, outputs, out)
        except Exception as error:  # noqa: BLE001 — never-block contract
            logger().warning(
                "joint pool-group allocation failed (%s: %s); this tick "
                "scales uncoordinated", type(error).__name__, error,
            )
            self._count_degraded(plan)
            return outputs

    def fused_operands(self, rows: List, plan: PoolGroupPlan, n: int, m: int):
        """Host half of the fused tick's poolgroup stage
        (ops/fusedtick.py PoolGroupOperands): spec bounds, pricing, and
        ratio operands assemble as in _build_inputs, but the base
        desired + movement clamps and the demand-distribution overlay
        move IN-DEVICE (gathered from the decide stage's fresh outputs
        at each pool's member_row). Returns the operand dataclass or
        None on failure (the uncoordinated posture, already counted)."""
        try:
            return self._fused_operand_struct(rows, plan, n, m)
        except Exception as error:  # noqa: BLE001 — never-block contract
            logger().warning(
                "pool-group operand assembly failed (%s: %s); this tick "
                "scales uncoordinated", type(error).__name__, error,
            )
            self._count_degraded(plan)
            return None

    def fused_commit(
        self, rows: List, plan: PoolGroupPlan,
        outputs: D.DecisionOutputs, out: PGK.PoolGroupOutputs,
    ) -> D.DecisionOutputs:
        """Bookkeeping for a fused tick's poolgroup stage: exactly
        refine()'s post-dispatch half, given the PoolGroupOutputs the
        fused program returned. Same never-block posture."""
        try:
            return self._apply(rows, plan, outputs, out)
        except Exception as error:  # noqa: BLE001 — never-block contract
            logger().warning(
                "joint pool-group allocation failed (%s: %s); this tick "
                "scales uncoordinated", type(error).__name__, error,
            )
            self._count_degraded(plan)
            return outputs

    def _count_degraded(self, plan: PoolGroupPlan) -> None:
        if self._c_degraded is None:
            return
        for group, _ in plan.groups:
            self._c_degraded.inc(
                group.metadata.name, group.metadata.namespace
            )

    # -- operand assembly --------------------------------------------------

    @staticmethod
    def _member_bounds(ha, member) -> Tuple[int, int]:
        """The member's effective spec bounds: the HA's own [min, max]
        TIGHTENED by the member's optional overrides (they can never
        widen); an empty intersection pins max = min — the HA's floor
        outranks the group's preference."""
        lo = ha.spec.min_replicas
        hi = ha.spec.max_replicas
        if member.min_replicas is not None:
            lo = max(lo, member.min_replicas)
        if member.max_replicas is not None:
            hi = min(hi, member.max_replicas)
        if hi < lo:
            hi = lo
        return lo, hi

    def _unit_cost(self, ha) -> float:
        """Hourly cost per replica of this pool's scale target (the
        CostEngine pricing path: annotations/tier through the
        CostModel; unresolvable targets price the model default)."""
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
        """(mu, sigma, valid) for one metric — the CostEngine's demand
        selection verbatim: forecast distribution when available
        (monotone-up max(observed, point)), else observed with sigma
        0."""
        if not math.isfinite(observed):
            return 0.0, 0.0, False
        mu, sigma = observed, 0.0
        if self.forecaster is not None:
            ns = row.ha.metadata.namespace
            name = row.ha.metadata.name
            dist = self.forecaster.distribution(ns, name, j)
            if dist is not None:
                point, sigma2 = dist
                if math.isfinite(point):
                    mu = max(observed, point)
                if math.isfinite(sigma2) and sigma2 > 0:
                    sigma = math.sqrt(sigma2)
        return mu, sigma, True

    @staticmethod
    def _target_for(row, slo, j: int) -> float:
        """Per-replica capacity for metric j: the SLO's per-metric
        override, else the metric spec's own target value — pools whose
        HA declares no SLO still carry demand (weight 0 keeps risk out
        of their score; headroom and ratios still see real demand)."""
        per_replica = 0.0
        if slo is not None:
            per_replica = slo.target_for(j) or 0.0
        if not per_replica:
            _spec, target, _observed = row.observed[j]
            per_replica = target.target_value() or 0.0
        return per_replica

    def _pool_scalars(self, group, idxs, rows, g, arrays) -> None:
        """Fill one group's per-pool scalar operands (shared between the
        standalone and fused assemblies)."""
        for p, i in enumerate(idxs):
            row = rows[i]
            member = group.spec.pools[p]
            slo = getattr(row.ha.spec.behavior, "slo", None)
            arrays["unit_cost"][g, p] = self._unit_cost(row.ha)
            arrays["tier_penalty"][g, p] = member.tier_penalty
            arrays["pool_valid"][g, p] = True
            if slo is not None:
                arrays["slo_weight"][g, p] = slo.violation_cost_weight
                arrays["max_hourly_cost"][g, p] = slo.max_hourly_cost

    def _ratio_operands(self, group, g, arrays) -> None:
        for r, ratio in enumerate(group.spec.ratios[: PGK.RATIO_SLOTS]):
            arrays["ratio_a"][g, r] = group.member_index(ratio.numerator)
            arrays["ratio_b"][g, r] = group.member_index(ratio.denominator)
            arrays["ratio_min_num"][g, r] = ratio.min_numerator
            arrays["ratio_min_den"][g, r] = ratio.min_denominator
            arrays["ratio_max_num"][g, r] = ratio.max_numerator
            arrays["ratio_max_den"][g, r] = ratio.max_denominator
            arrays["ratio_valid"][g, r] = True

    def _alloc(self, gb: int, pb: int, m: int) -> dict:
        return {
            "unit_cost": np.zeros((gb, pb), np.float32),
            "slo_weight": np.zeros((gb, pb), np.float32),
            "max_hourly_cost": np.zeros((gb, pb), np.float32),
            "tier_penalty": np.zeros((gb, pb), np.float32),
            "pool_valid": np.zeros((gb, pb), bool),
            "slo_target": np.ones((gb, pb, m), np.float32),
            "ratio_a": np.zeros((gb, PGK.RATIO_SLOTS), np.int32),
            "ratio_b": np.zeros((gb, PGK.RATIO_SLOTS), np.int32),
            "ratio_min_num": np.zeros((gb, PGK.RATIO_SLOTS), np.int32),
            "ratio_min_den": np.ones((gb, PGK.RATIO_SLOTS), np.int32),
            "ratio_max_num": np.zeros((gb, PGK.RATIO_SLOTS), np.int32),
            "ratio_max_den": np.zeros((gb, PGK.RATIO_SLOTS), np.int32),
            "ratio_valid": np.zeros((gb, PGK.RATIO_SLOTS), bool),
            "group_budget": np.zeros(gb, np.float32),
            "group_valid": np.zeros(gb, bool),
        }

    def _build_inputs(
        self, rows: List, plan: PoolGroupPlan, outputs: D.DecisionOutputs
    ) -> PGK.PoolGroupInputs:
        """One padded PoolGroupInputs matrix for the whole fleet's
        groups: per-pool operands exactly as the CostEngine would
        assemble them for that pool's row, movement bounds clamped to
        the decide kernel's fresh up_ceiling/down_floor, group
        constraints as exact-integer operands."""
        gb = pad_group_count(len(plan.groups))
        pb = PGK.pad_pool_count(
            max(len(idxs) for _, idxs in plan.groups)
        )
        m = max(
            1,
            max(
                len(rows[i].values)
                for _, idxs in plan.groups
                for i in idxs
            ),
        )
        a = self._alloc(gb, pb, m)
        base = np.zeros((gb, pb), np.int32)
        min_replicas = np.zeros((gb, pb), np.int32)
        max_replicas = np.zeros((gb, pb), np.int32)
        demand_mu = np.zeros((gb, pb, m), np.float32)
        demand_sigma = np.zeros((gb, pb, m), np.float32)
        demand_valid = np.zeros((gb, pb, m), bool)
        desired = np.asarray(outputs.desired, np.int32)
        up_ceiling = np.asarray(outputs.up_ceiling, np.int32)
        down_floor = np.asarray(outputs.down_floor, np.int32)
        for g, (group, idxs) in enumerate(plan.groups):
            self._pool_scalars(group, idxs, rows, g, a)
            self._ratio_operands(group, g, a)
            a["group_budget"][g] = group.spec.max_hourly_cost
            a["group_valid"][g] = True
            for p, i in enumerate(idxs):
                row = rows[i]
                slo = getattr(row.ha.spec.behavior, "slo", None)
                lo, hi = self._member_bounds(row.ha, group.spec.pools[p])
                base[g, p] = desired[i]
                # the cost clamp order one rank up: spec bounds outrank
                # the per-tick rate bound
                min_replicas[g, p] = max(lo, min(int(down_floor[i]), hi))
                max_replicas[g, p] = min(hi, max(int(up_ceiling[i]), lo))
                for j in range(len(row.observed)):
                    per_replica = self._target_for(row, slo, j)
                    if not per_replica or per_replica <= 0:
                        continue  # no capacity notion: no risk, no demand
                    _spec, _target, observed = row.observed[j]
                    mu, sigma, ok = self._demand(row, j, observed)
                    a["slo_target"][g, p, j] = per_replica
                    demand_mu[g, p, j] = mu
                    demand_sigma[g, p, j] = sigma
                    demand_valid[g, p, j] = ok
        return PGK.PoolGroupInputs(
            base_desired=base,
            min_replicas=min_replicas,
            max_replicas=max_replicas,
            unit_cost=a["unit_cost"],
            slo_weight=a["slo_weight"],
            max_hourly_cost=a["max_hourly_cost"],
            tier_penalty=a["tier_penalty"],
            pool_valid=a["pool_valid"],
            slo_target=a["slo_target"],
            demand_mu=demand_mu,
            demand_sigma=demand_sigma,
            demand_valid=demand_valid,
            ratio_a=a["ratio_a"],
            ratio_b=a["ratio_b"],
            ratio_min_num=a["ratio_min_num"],
            ratio_min_den=a["ratio_min_den"],
            ratio_max_num=a["ratio_max_num"],
            ratio_max_den=a["ratio_max_den"],
            ratio_valid=a["ratio_valid"],
            group_budget=a["group_budget"],
            group_valid=a["group_valid"],
        )

    def _fused_operand_struct(
        self, rows: List, plan: PoolGroupPlan, n: int, m: int
    ):
        from karpenter_tpu_torch.ops import fusedtick as FT

        gb = pad_group_count(len(plan.groups))
        pb = PGK.pad_pool_count(
            max(len(idxs) for _, idxs in plan.groups)
        )
        a = self._alloc(gb, pb, m)
        member_row = np.zeros((gb, pb), np.int32)
        pg_min = np.zeros((gb, pb), np.int32)
        pg_max = np.zeros((gb, pb), np.int32)
        observed_arr = np.zeros((gb, pb, m), np.float32)
        demand_base_valid = np.zeros((gb, pb, m), bool)
        prior_point = np.zeros((gb, pb, m), np.float32)
        prior_sigma2 = np.zeros((gb, pb, m), np.float32)
        prior_valid = np.zeros((gb, pb, m), bool)
        for g, (group, idxs) in enumerate(plan.groups):
            self._pool_scalars(group, idxs, rows, g, a)
            self._ratio_operands(group, g, a)
            a["group_budget"][g] = group.spec.max_hourly_cost
            a["group_valid"][g] = True
            for p, i in enumerate(idxs):
                row = rows[i]
                slo = getattr(row.ha.spec.behavior, "slo", None)
                lo, hi = self._member_bounds(row.ha, group.spec.pools[p])
                member_row[g, p] = i
                pg_min[g, p] = lo
                pg_max[g, p] = hi
                for j in range(len(row.observed)):
                    per_replica = self._target_for(row, slo, j)
                    if not per_replica or per_replica <= 0:
                        continue
                    _spec, _target, observed = row.observed[j]
                    a["slo_target"][g, p, j] = per_replica
                    observed_arr[g, p, j] = observed
                    if not math.isfinite(observed):
                        continue  # _demand()'s early return: no dist read
                    demand_base_valid[g, p, j] = True
                    if self.forecaster is None:
                        continue
                    dist = self.forecaster.distribution(
                        row.ha.metadata.namespace,
                        row.ha.metadata.name,
                        j,
                    )
                    if dist is not None:
                        prior_point[g, p, j] = dist[0]
                        prior_sigma2[g, p, j] = dist[1]
                        prior_valid[g, p, j] = True
        return FT.PoolGroupOperands(
            member_row=member_row,
            pg_min=pg_min,
            pg_max=pg_max,
            unit_cost=a["unit_cost"],
            slo_weight=a["slo_weight"],
            max_hourly_cost=a["max_hourly_cost"],
            tier_penalty=a["tier_penalty"],
            pool_valid=a["pool_valid"],
            slo_target=a["slo_target"],
            observed=observed_arr,
            demand_base_valid=demand_base_valid,
            prior_point=prior_point,
            prior_sigma2=prior_sigma2,
            prior_valid=prior_valid,
            ratio_a=a["ratio_a"],
            ratio_b=a["ratio_b"],
            ratio_min_num=a["ratio_min_num"],
            ratio_min_den=a["ratio_min_den"],
            ratio_max_num=a["ratio_max_num"],
            ratio_max_den=a["ratio_max_den"],
            ratio_valid=a["ratio_valid"],
            group_budget=a["group_budget"],
            group_valid=a["group_valid"],
        )

    # -- post-dispatch half ------------------------------------------------

    def _apply(
        self, rows: List, plan: PoolGroupPlan,
        outputs: D.DecisionOutputs, out: PGK.PoolGroupOutputs,
    ) -> D.DecisionOutputs:
        from dataclasses import replace

        desired = np.asarray(outputs.desired, np.int32).copy()
        pg_desired = np.asarray(out.desired, np.int32)
        headroom = np.asarray(out.headroom, np.int32)
        ratio_ok = np.asarray(out.ratio_ok, bool)
        group_hourly = np.asarray(out.group_hourly, np.float32)
        self._annotate_ledger(plan, outputs, out)
        for g, (group, idxs) in enumerate(plan.groups):
            ns = group.metadata.namespace
            name = group.metadata.name
            for p, i in enumerate(idxs):
                desired[i] = pg_desired[g, p]
                ha = rows[i].ha
                ref = ha.spec.scale_target_ref
                self._contrib[(ns, ha.metadata.name)] = (
                    (ns, ref.name), int(headroom[g, p]),
                )
            if self._g_hourly is not None:
                self._g_hourly.set(name, ns, float(group_hourly[g]))
                self._g_ratio.set(name, ns, float(bool(ratio_ok[g])))
            if self._c_coordinated is not None and ratio_ok[g]:
                # counts COORDINATED ticks only: a tick served by the
                # degraded independent rung (or one whose band is out of
                # the ladder's reach) leaves the counter flat, so its
                # rate vs the tick rate IS the coordination SLI
                self._c_coordinated.inc(name, ns)
            self._live.add((ns, name))
            self._patch_status(group, bool(ratio_ok[g]), float(group_hourly[g]))
        return replace(outputs, desired=desired)

    def _patch_status(
        self, group: PoolGroup, coordinated: bool, hourly: float
    ) -> None:
        """status.coordinated / status.expectedHourly: the operator's
        kubectl-visible answer to 'is the band holding'. Best-effort —
        a status write failure must not fail the refine."""
        group.status.coordinated = coordinated
        group.status.expected_hourly = hourly
        if self.store is None:
            return
        try:
            self.store.patch_status(group)
        except Exception:  # noqa: BLE001 — status is advisory
            pass

    def _annotate_ledger(
        self, plan: PoolGroupPlan, outputs: D.DecisionOutputs,
        out: PGK.PoolGroupOutputs,
    ) -> None:
        """Provenance: member rows record that a JOINT allocation chose
        their count — and whether coordination moved them off the
        independent optimum (joint_repair). One attribute read when the
        ledger is off."""
        from karpenter_tpu_torch.observability import default_ledger

        batch = default_ledger().current()  # None when disabled
        if batch is None:
            return
        repair = np.asarray(out.joint_repair, bool)
        for g, (_group, idxs) in enumerate(plan.groups):
            rows_in = [i for i in idxs if i < batch.n]
            if rows_in:
                batch.annotate_rows(
                    rows_in,
                    pool_grouped=True,
                    pool_joint_repair=bool(repair[g]),
                )
