"""FleetForecaster: the host-side orchestration of predictive scaling.

Owns the pieces the BatchAutoscaler composes each tick
(docs/forecasting.md):

  * the MetricHistoryStore (forecast/history.py) — every observed
    metric sample of every HorizontalAutoscaler lands here, surviving
    engine requeues and deactivations, pruned on HA deletion;
  * ONE batched forecast per tick — every forecast-enabled series in
    the fleet rides a single ForecastInputs matrix through the
    `forecast_fn` seam (SolverService.forecast in production: coalesced
    queue, compile cache, numpy fallback, backend-health FSM);
  * online SKILL tracking — each prediction is remembered until its
    horizon elapses, then scored against what actually happened
    (normalized absolute error folded into a per-HA EWMA). Skill below
    the spec's floor auto-disables blending for that HA: a forecast
    that has been wrong lately doesn't get to provision nodes;
  * the never-block contract — forecast_rows() NEVER raises. Any
    failure (device fault past every service degradation rung, a
    poisoned spec) logs, counts karpenter_forecast_disabled_total, and
    returns no forecasts: the tick proceeds purely reactive, exactly as
    if the subsystem didn't exist.

Metrics: karpenter_forecast_{skill,horizon_value} gauges and
karpenter_forecast_{blend,disabled}_total counters, labeled
{name, namespace} per HorizontalAutoscaler.

The port's copy of karpenter_tpu/forecast/engine.py, changed only in its
imports and as noted. The default forecast_fn is the port's forecast on
the card (forecast/models.forecast_host).
"""

from __future__ import annotations

import collections
import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.forecast import models as M
from karpenter_tpu_torch.forecast.history import MetricHistoryStore
from karpenter_tpu_torch.utils.log import logger

SUBSYSTEM = "forecast"

# FORECASTING condition reasons (api/conditions.py carries the type)
REASON_WARMING_UP = "ForecastWarmingUp"
REASON_SKILL_DEGRADED = "ForecastSkillDegraded"
REASON_UNAVAILABLE = "ForecastUnavailable"

_ERR_FLOOR = 1e-6  # normalization floor for the skill error ratio
# query-pool dedupe window: N autoscalers sharing one query read it N
# times per tick — appending each read would shrink the pool's apparent
# sample spacing N-fold and wreck any series seeded from it
_QUERY_DEDUPE_S = 1.0


def _ha_key(ha) -> Tuple[str, str]:
    return (ha.metadata.namespace, ha.metadata.name)


def _series_key(ha, metric_index: int) -> tuple:
    return ("ha", ha.metadata.namespace, ha.metadata.name, metric_index)


def query_key(name: str, labels: Optional[dict]) -> tuple:
    """Key for raw metrics-client observations (the warm pool)."""
    return ("q", name, tuple(sorted((labels or {}).items())))


def _drop_keys(table: Dict, predicate) -> None:
    """Delete every key matching predicate (prune helper)."""
    for key in [k for k in table if predicate(k)]:
        del table[key]


class FleetForecaster:
    """One per runtime; see module docstring.

    `forecast_fn` is the device seam: any (ForecastInputs) ->
    ForecastOutputs callable — SolverService.forecast in production
    (runtime.py wiring), the jitted kernel directly when standalone.
    """

    def __init__(
        self,
        forecast_fn=None,
        registry=None,
        clock=_time.time,
        capacity: int = 64,
        stale_max_age_s: float = 60.0,
        skill_alpha: float = 0.3,
    ):
        self.forecast_fn = (
            forecast_fn if forecast_fn is not None else M.forecast_host
        )
        self.clock = clock
        self.stale_max_age_s = stale_max_age_s
        self.skill_alpha = skill_alpha
        self.history = MetricHistoryStore(capacity=capacity)
        # crash safety (karpenter_tpu/recovery): skill updates journal
        # through this handle so the blend resumes after a restart with
        # its earned skill — neither an optimistic reset (a forecaster
        # that was WRONG pre-crash would immediately provision nodes
        # again) nor a cold start (one that was RIGHT would stop
        # helping). History appends journal via history.journal.
        self.journal = None
        # (ns, name) -> skill EWMA in [0, 1]; optimistic start (1.0) so a
        # fresh forecaster blends until its predictions prove bad
        self._skill: Dict[tuple, float] = {}
        # (ns, name, metric_index) -> (point, sigma2, expires_at) of the
        # newest batched forecast — the demand DISTRIBUTION the cost
        # subsystem reads as its risk input (docs/cost.md); refreshed
        # each _predict pass, pruned with the HA, dropped by
        # distribution() two horizons after its last refresh
        self._dist: Dict[tuple, Tuple[float, float, float]] = {}
        # series key -> pending (target_time, predicted) awaiting scoring
        self._pending: Dict[tuple, collections.deque] = {}
        # (ns, name) -> (active, reason, message) for the FORECASTING
        # condition, refreshed each forecast_rows pass
        self._verdicts: Dict[tuple, Tuple[bool, str, str]] = {}
        # (ns, name) keys currently holding karpenter_forecast_* gauge
        # series — so a row that DROPS spec.behavior.forecast retires
        # its series (the frozen-series discipline karpenter_cost_*
        # established) instead of pinning the last pre-opt-out skill on
        # dashboards forever
        self._gauged: set = set()
        self._g_skill = self._g_value = None
        self._c_blend = self._c_disabled = None
        if registry is not None:
            self._g_skill = registry.register(SUBSYSTEM, "skill")
            self._g_value = registry.register(SUBSYSTEM, "horizon_value")
            self._c_blend = registry.register(
                SUBSYSTEM, "blend_total", kind="counter"
            )
            self._c_disabled = registry.register(
                SUBSYSTEM, "disabled_total", kind="counter"
            )

    # -- observation paths -------------------------------------------------

    def observe_query(self, metric) -> None:
        """Metrics-client observation hook (metrics/clients.py): every
        successful instant query feeds the query-keyed warm pool.
        Reads landing within the dedupe window of the last sample are
        dropped — same-tick reads from autoscalers sharing a query
        carry no new information and would corrupt the pool's sample
        spacing."""
        key = query_key(metric.name, metric.labels)
        now = self.clock()
        last = self.history.last(key)
        if last is not None and now - last[0] < _QUERY_DEDUPE_S:
            return
        self.history.append(key, now, float(metric.value))

    def stale_value(self, ha, metric_index: int, now: float):
        """Age-bounded last sample for a row whose live metric query
        failed (the stale-metric fix): the value the batch can reuse, or
        None when history is empty/too old to stand in."""
        last = self.history.last(_series_key(ha, metric_index))
        if last is None:
            return None
        t, value = last
        if now - t > self.stale_max_age_s:
            return None
        return value

    def skill(self, namespace: str, name: str) -> float:
        return self._skill.get((namespace, name), 1.0)

    def verdict(self, namespace: str, name: str):
        """(active, reason, message) for the FORECASTING condition."""
        return self._verdicts.get(
            (namespace, name), (False, REASON_WARMING_UP, "no forecast yet")
        )

    def distribution(
        self, namespace: str, name: str, metric_index: int
    ) -> Optional[Tuple[float, float]]:
        """(point, sigma2) of the newest forecast for one HA metric —
        the demand distribution the cost subsystem's risk term consumes
        (docs/cost.md); None while the series hasn't forecast yet, and
        None again once a forecast goes two horizons without a refresh
        (the stale entry is dropped, not served)."""
        key = (namespace, name, metric_index)
        entry = self._dist.get(key)
        if entry is None:
            return None
        point, sigma2, expires = entry
        if self.clock() >= expires:
            del self._dist[key]
            return None
        return (point, sigma2)

    def prune(self, namespace: str, name: str) -> None:
        """Forget a deleted HorizontalAutoscaler (HA controller
        on_deleted hook): history, skill, pending scores, gauges."""
        self.history.prune("ha", namespace, name)
        if (
            self._skill.pop((namespace, name), None) is not None
            and self.journal is not None
        ):
            self.journal.delete(("skill", namespace, name))
        self._verdicts.pop((namespace, name), None)
        _drop_keys(
            self._pending, lambda k: k[1] == namespace and k[2] == name
        )
        _drop_keys(
            self._dist, lambda k: k[0] == namespace and k[1] == name
        )
        self._retire_gauges(namespace, name)

    def _retire_gauges(self, namespace: str, name: str) -> None:
        """Drop one HA's karpenter_forecast_* series (deletion AND
        forecast-spec opt-out both land here)."""
        self._gauged.discard((namespace, name))
        if self._g_skill is not None:
            self._g_skill.remove(name, namespace)
            self._g_value.remove(name, namespace)

    # -- crash-safe restore/snapshot (karpenter_tpu/recovery) --------------

    def snapshot_state(self) -> Dict[str, float]:
        """Skill table for the recovery checkpoint."""
        from karpenter_tpu_torch.recovery.journal import key_str

        return {
            key_str(("skill",) + ha_key): value
            for ha_key, value in self._skill.items()
        }

    def restore_state(
        self, skill_entries: dict, history_entries: dict
    ) -> None:
        """Rebuild skill EWMAs and history rings from replayed journal
        tables: the forecast blend resumes where the crashed
        incarnation left it — earned skill, warm series — instead of a
        cold start."""
        from karpenter_tpu_torch.recovery.journal import key_tuple

        for k, value in skill_entries.items():
            key = key_tuple(k)  # ("skill", ns, name)
            self._skill[(key[1], key[2])] = float(value)
        for k, samples in history_entries.items():
            self.history.restore_ring(key_tuple(k), samples)
        if skill_entries or history_entries:
            logger().info(
                "forecast: restored %d skill entr(ies) and %d history "
                "series from the journal",
                len(skill_entries), len(history_entries),
            )

    # -- the per-tick pass -------------------------------------------------

    def forecast_rows(self, rows, now: float) -> Dict[tuple, float]:
        """The BatchAutoscaler's per-tick call: ingest every live row's
        observations, score matured predictions, and forecast every
        eligible series in ONE batched dispatch. Returns
        {(row_index, metric_index): predicted_value}; empty on any
        failure (never raises — module docstring)."""
        try:
            eligible = self._ingest(rows, now)
            if not eligible:
                return {}
            return self._predict(rows, eligible, now)
        except Exception as error:  # noqa: BLE001 — never-block contract
            self._mark_unavailable(rows, error)
            return {}

    def _mark_unavailable(self, rows, error) -> None:
        """The never-block failure posture: log once, stamp every
        forecast-opted row's verdict REASON_UNAVAILABLE — this tick
        scales reactive-only."""
        logger().warning(
            "forecast pass failed (%s: %s); this tick scales "
            "reactive-only", type(error).__name__, error,
        )
        for row in rows:
            if getattr(row.ha.spec.behavior, "forecast", None) is None:
                continue
            ns, name = _ha_key(row.ha)
            self._verdicts[(ns, name)] = (
                False, REASON_UNAVAILABLE, f"forecast failed: {error}"
            )
            if self._c_disabled is not None:
                self._c_disabled.inc(name, ns)

    def fused_plan(self, rows, now: float):
        """Host half 1 of the fused tick's forecast stage
        (ops/fusedtick.py): ingest + operand assembly with NO dispatch
        — the fused program runs the fit in-device and scatters the
        points straight into the decide operands. Returns
        (eligible, ForecastInputs, row/col/need/blend maps) or None
        (nothing eligible, or the forecast_rows failure posture)."""
        try:
            eligible = self._ingest(rows, now)
            if not eligible:
                return None
            inputs = self._build_inputs(eligible, now)
        except Exception as error:  # noqa: BLE001 — never-block contract
            self._mark_unavailable(rows, error)
            return None
        k = len(eligible)
        row_map = np.zeros(k, np.int32)
        col_map = np.zeros(k, np.int32)
        need = np.zeros(k, np.int32)
        blend = np.zeros(k, bool)
        for idx, (i, j, _key, fspec, blend_flag) in enumerate(eligible):
            row_map[idx] = i
            col_map[idx] = j
            # the same sample floor _predict gates on host-side — the
            # kernel compares it against n_valid in-device
            need[idx] = max(int(fspec.min_samples), 2)
            blend[idx] = blend_flag
        return eligible, inputs, row_map, col_map, need, blend

    def fused_commit(self, eligible, out, rows, now: float):
        """Host half 2: the bookkeeping _predict runs after its
        dispatch — distribution refresh, pending scoring queue, skill
        gauges, ledger provenance — given the ForecastOutputs the fused
        program returned. The blend itself already happened in-device;
        the returned dict is the same surface forecast_rows exposes."""
        try:
            return self._commit(rows, eligible, out, now)
        except Exception as error:  # noqa: BLE001 — never-block contract
            self._mark_unavailable(rows, error)
            return {}

    def _ingest(self, rows, now: float) -> List[tuple]:
        """Append observations, mature skill scores, and collect the
        (row_index, metric_index, key, spec) tuples eligible for this
        tick's batched forecast."""
        eligible: List[tuple] = []
        for i, row in enumerate(rows):
            ha = row.ha
            fspec = getattr(ha.spec.behavior, "forecast", None)
            stale = getattr(row, "stale_metrics", set())
            for j, (metric_spec, _target, value) in enumerate(row.observed):
                key = _series_key(ha, j)
                if j not in stale and np.isfinite(value):
                    self._mature(key, _ha_key(ha), now, float(value))
                    self.history.append(key, now, float(value))
            if fspec is None or getattr(row, "custom", False):
                # a row that STOPPED opting in retires its gauge series
                # — skill and pending scores are kept (earned knowledge
                # a re-opt-in resumes from), only the exported series
                # must not freeze at its pre-opt-out value
                key = _ha_key(ha)
                if key in self._gauged:
                    self._retire_gauges(*key)
                continue
            self._seed_from_queries(ha)
            eligible.extend(self._eligible_row(i, row, fspec))
        return eligible

    def _seed_from_queries(self, ha) -> None:
        """Warm-pool seeding: a fresh HA series copies the query-keyed
        history another observer already accumulated."""
        for j, metric_spec in enumerate(ha.spec.metrics):
            key = _series_key(ha, j)
            if self.history.count(key) > 0:
                continue
            if metric_spec.prometheus is None:
                continue
            from karpenter_tpu_torch.metrics.clients import parse_instant_selector

            try:
                name, labels = parse_instant_selector(
                    metric_spec.prometheus.query
                )
            except Exception:  # noqa: BLE001 — unparseable query: no seed
                continue
            self.history.seed(key, query_key(name, labels))

    def _eligible_row(self, i: int, row, fspec) -> List[tuple]:
        """(row_index, metric_index, key, spec, blend) tuples for this
        row's warm series. A skill-gated row still forecasts — in
        SHADOW mode (blend=False): its predictions keep being scored so
        the skill EWMA can actually recover, they just don't raise any
        scale-up decision while below the floor."""
        ns, name = _ha_key(row.ha)
        skill = self.skill(ns, name)
        blend = skill >= fspec.min_skill
        if not blend:
            self._verdicts[(ns, name)] = (
                False,
                REASON_SKILL_DEGRADED,
                f"skill {skill:.3f} below floor {fspec.min_skill:.3f}; "
                "scaling reactive-only until it recovers",
            )
            if self._c_disabled is not None:
                self._c_disabled.inc(name, ns)
        out: List[tuple] = []
        need = max(int(fspec.min_samples), 2)
        short = 0
        for j in range(len(row.observed)):
            key = _series_key(row.ha, j)
            if self.history.count(key) >= need:
                out.append((i, j, key, fspec, blend))
            else:
                short += 1
        if blend:
            # any warm series IS blending: the condition must say so
            # even while a freshly added metric is still warming up
            if out:
                self._verdicts[(ns, name)] = (True, "", "")
            elif short:
                self._verdicts[(ns, name)] = (
                    False,
                    REASON_WARMING_UP,
                    f"{short} metric series below {need} samples",
                )
        return out

    def _mature(self, key, ha_key, now: float, actual: float) -> None:
        """Score every pending prediction for `key` whose horizon has
        elapsed against the freshly observed value. The error is
        normalized by the LARGER of |actual| and the metric's target
        value (the scale replicas are decided at): a queue idling near
        zero overnight with exporter noise must not register as huge
        relative error and strip the skill the morning ramp needs."""
        pending = self._pending.get(key)
        if not pending:
            return
        scored = None
        while pending and pending[0][0] <= now:
            scored = pending.popleft()
        if scored is None:
            return
        _target_t, predicted, scale = scored
        err = abs(predicted - actual) / max(
            abs(actual), scale, _ERR_FLOOR
        )
        sample = max(0.0, 1.0 - err)
        prev = self._skill.get(ha_key, 1.0)
        self._skill[ha_key] = (
            (1.0 - self.skill_alpha) * prev + self.skill_alpha * sample
        )
        if self.journal is not None:
            self.journal.set(("skill",) + ha_key, self._skill[ha_key])

    def _predict(
        self, rows, eligible: List[tuple], now: float
    ) -> Dict[tuple, float]:
        inputs = self._build_inputs(eligible, now)
        out = self.forecast_fn(inputs)
        return self._commit(rows, eligible, out, now)

    def _commit(  # lint: allow-complexity — one guard per per-series concern (gating, distribution, scoring, gauges, provenance)
        self, rows, eligible: List[tuple], out, now: float
    ) -> Dict[tuple, float]:
        from karpenter_tpu_torch.observability import default_ledger

        points = np.asarray(out.point, np.float32)
        sigma2 = np.asarray(out.sigma2, np.float32)
        n_valid = np.asarray(out.n_valid)
        forecasts: Dict[tuple, float] = {}
        # provenance slice (observability/provenance.py): the forecast
        # stage annotates ITS columns of the tick's ledger batch — the
        # predicted value, the skill that gated it, and whether the
        # blend could raise the reactive recommendation (point above
        # observed under an active blend). One record per ROW: the
        # value/skill come from the row's first forecast-eligible
        # metric, the blend flag ORs over ALL its metrics (a blend on
        # metric 1 must not read as 'reactive' just because metric 0
        # carries no forecast). current() is None when the ledger is
        # disabled or no batch is staged.
        ledger_batch = default_ledger().current()
        ledger_rows: Dict[int, list] = {}
        for k, (i, j, key, fspec, blend) in enumerate(eligible):
            if n_valid[k] < max(int(fspec.min_samples), 2):
                continue
            point = float(points[k])
            ns, name = _ha_key(rows[i].ha)
            # the distribution surface (cost subsystem risk input) —
            # refreshed for SHADOW (skill-gated) series too: the risk
            # term gates on its own spec, not on the blend verdict.
            # Expiry-stamped: a series that stops forecasting (broken
            # metric, history reset) must not pin an obsolete spike as
            # the risk input forever — two horizons without a refresh
            # and distribution() forgets it.
            expires = now + 2.0 * max(float(fspec.horizon_seconds), 1.0)
            self._dist[(ns, name, j)] = (point, float(sigma2[k]), expires)
            if blend:
                forecasts[(i, j)] = point
            # remember the prediction for horizon-elapsed scoring —
            # shadow (skill-gated) predictions too, or the skill EWMA
            # could never recover; the deque is bounded so a stalled
            # metric can't grow it. The metric's target value rides
            # along as the error-normalization scale (_mature).
            target = rows[i].observed[j][1]
            try:
                scale = abs(float(target.target_value()))
            except Exception:  # noqa: BLE001 — unscaled metric shapes
                scale = 0.0
            pending = self._pending.setdefault(
                key, collections.deque(maxlen=self.history.capacity)
            )
            pending.append(
                (now + float(fspec.horizon_seconds), point, scale)
            )
            observed = rows[i].observed[j][2]
            if ledger_batch is not None and i < ledger_batch.n:
                entry = ledger_rows.setdefault(
                    i, [point, self.skill(ns, name), blend, False]
                )
                entry[2] = entry[2] or blend
                entry[3] = entry[3] or bool(
                    blend and np.isfinite(observed) and point > observed
                )
            if self._g_skill is not None:
                self._gauged.add((ns, name))
                self._g_skill.set(name, ns, self.skill(ns, name))
                if j == 0:
                    self._g_value.set(name, ns, point)
                if blend and np.isfinite(observed) and point > observed:
                    self._c_blend.inc(name, ns)
        if ledger_rows:
            self._annotate_forecast_rows(ledger_batch, ledger_rows)
        return forecasts

    @staticmethod
    def _annotate_forecast_rows(
        ledger_batch, ledger_rows: Dict[int, list]
    ) -> None:
        """The batch's forecast provenance in one scatter: per row, the
        first eligible metric's predicted value + skill, whether ANY
        metric blends (active), and whether any blend could RAISE the
        reactive recommendation (the same point-above-observed
        condition the blend counter uses)."""
        idx = list(ledger_rows)
        n = ledger_batch.n
        value = np.full(n, np.nan, np.float32)
        skill = np.full(n, np.nan, np.float32)
        active = np.zeros(n, bool)
        blend = np.zeros(n, bool)
        for i, (v, s, a, b) in ledger_rows.items():
            value[i], skill[i], active[i], blend[i] = v, s, a, b
        ledger_batch.annotate_rows(
            idx,
            forecast_value=value,
            forecast_skill=skill,
            forecast_active=active,
            forecast_blend=blend,
        )

    def _build_inputs(
        self, eligible: List[tuple], now: float
    ) -> M.ForecastInputs:
        keys = [key for (_i, _j, key, _f, _b) in eligible]
        values, valid, times, step_s = self.history.matrix(keys, now)
        K = len(eligible)
        horizon = np.zeros(K, np.float32)
        half_life = np.ones(K, np.float32)
        model = np.zeros(K, np.int32)
        season = np.zeros(K, np.int32)
        alpha = np.zeros(K, np.float32)
        beta = np.zeros(K, np.float32)
        gamma = np.zeros(K, np.float32)
        for k, (_i, _j, _key, fspec, _b) in enumerate(eligible):
            horizon[k] = fspec.horizon_seconds
            half_life[k] = max(float(fspec.horizon_seconds), 1.0)
            model[k] = M.MODEL_CODES.get(fspec.model, M.MODEL_LINEAR)
            if fspec.season_seconds > 0 and step_s[k] > 0:
                season[k] = int(round(fspec.season_seconds / step_s[k]))
            alpha[k] = fspec.alpha
            beta[k] = fspec.beta
            gamma[k] = fspec.gamma
        # recency decay for the linear fit, computed HOST-side (a
        # transcendental inside the kernel would break numpy parity —
        # forecast/models.py): a sample one horizon old weighs half as
        # much as the newest, so a regime change overtakes stale history
        # within a few horizons
        weights = np.power(
            np.float32(0.5), (-times) / half_life[:, None]
        ).astype(np.float32)
        return M.ForecastInputs(
            values=values, valid=valid, times=times, weights=weights,
            horizon=horizon, step_s=step_s, model=model, season=season,
            alpha=alpha, beta=beta, gamma=gamma,
        )
