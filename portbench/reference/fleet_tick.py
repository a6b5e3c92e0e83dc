"""The HorizontalAutoscaler fleet's fused tick in plain numpy: the
reference that `correct` holds `SolverService.fused_tick` against, its
lower-precision control, and the tick's operations and bytes for the
roofline.

One tick of the whole fleet, stage after stage, on host arrays:

1. forecast, per series: a weighted least-squares line over the masked
   history, reweighted once (Huber-style, w^2 = min(1, k^2 s^2 / r^2))
   and refitted, its residual variance (sigma2) and its value `horizon`
   seconds on; and an additive Holt-Winters recurrence (season < 2: plain
   Holt), projected round(horizon / step) samples on. A series' model
   code picks its point; a series with no valid sample forecasts 0;
2. the forecast -> decide seam: a series whose fit saw at least `need`
   samples writes its point, sigma2 and a valid bit into its (row, col)
   cell of the fleet's [N, M] grids (the distribution), and also into
   the blend grid where its skill verdict holds;
3. decide (the HPA rule): per metric ceil(status * value / target) by
   target type, for the observed values and, blended by max, the
   forecast ones; the select policy over valid metrics; the
   stabilization windows; the Count/Percent rate policies; the
   [min, max] clamp; the movement bounds up_ceiling / down_floor;
4. the decide -> cost seam: the fresh distribution over the host-read
   prior, demand = max(observed, prior point), sigma = sqrt(prior
   sigma2); the spec bounds clamped by the movement bounds;
5. the cost ladder: 8 candidates from the decision up, capped by the
   budget, each scored slo_weight * risk + candidate * unit cost, where
   risk is the largest one-sigma shortfall fraction over the metrics;
   the first least score wins;
6. the pool groups: each pool's ladder as in 5 (with a tier penalty on
   the rate), the K^P joint candidates of each group, integer ratio
   bands and the group budget as violations; the pools' independent
   choices where they violate nothing, else the fewest violations at
   the least joint score.

Order of operations. Float results are held bit for bit, so every step
follows the order of the reference package's numpy mirror
(karpenter_tpu/ops/fusedtick.py::fused_tick_numpy and the stage mirrors
it joins), whose bits the port's program equals on the card: every
multiply-accumulate of the forecast's sums, the shortfall and the scores
rounds once, as a fused multiply-add (computed in float64 and rounded to
float32: the product of two float32 numbers is exact in float64), every
sum over the history is sequential in time, and the joint score and
spend add pool by pool. Departures from the mirror: none in the
arithmetic. The reference is written in numpy, the mirror's own library
(the benchmark's references import neither the program nor torch; with
no matrix product there is no TF32 to turn off); it takes the
benchmark's dict operands unpadded (the service pads the series at its
door, which moves no live output) and runs only the all-stages tick the
configuration sends (a missing stage is refused, not skipped).

The answer: every output leaf of FusedTickOutputs as nested dicts,
int32 and bool leaves as they are, each float32 leaf as its int32 bit
pattern (`bits`, every NaN as 0x7FC00000, on both sides), so the
judge's exact integer comparison holds every bit.

`control`: the same tick with the histories and observed values
(forecast values, metric values, the cost and pool-group observed
demand) rounded to bfloat16 first, the step below the configuration's
float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.reference.binpack import to_bf16

F32 = np.float32
_ZERO, _ONE = F32(0.0), F32(1.0)
_NAN_BITS = np.int32(0x7FC00000)

# forecast
MODEL_HOLT_WINTERS = 1
_HUBER_K = F32(1.5)
_MIN_STEP_S = F32(1e-3)
# decide
TYPE_VALUE, TYPE_AVERAGE_VALUE, TYPE_UTILIZATION = 0, 1, 2
POLICY_MAX, POLICY_MIN, POLICY_DISABLED = 0, 1, 2
POLICY_TYPE_PERCENT = 1
_GUARD = F32(1e-5)
_F32_LOW = F32(np.finfo(np.float32).min)
_F32_HIGH = F32(np.finfo(np.float32).max)
_I32_SAFE_MIN, _I32_SAFE_MAX = F32(-(2.0 ** 31)), F32(2.0 ** 31 - 128)
# cost and pool groups
CANDIDATES = 8
_EPS = F32(1e-6)

STAGES = ("decision", "forecast", "cost", "poolgroup")


def bits(x: np.ndarray) -> np.ndarray:
    """A float32 array as its int32 bit pattern, every NaN as one."""
    x = np.ascontiguousarray(x, np.float32)
    return np.where(np.isnan(x), _NAN_BITS, x.view(np.int32))


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _f32(x) -> np.ndarray:
    return np.asarray(x, F32)


def _i32(x) -> np.ndarray:
    return np.asarray(x, np.int32)


def _to_i32(x) -> np.ndarray:
    return np.clip(x, _I32_SAFE_MIN, _I32_SAFE_MAX).astype(np.int32)


# -- 1. forecast -------------------------------------------------------------


def _line(values, valid, times, weights):
    """Weighted least squares of value on time, summed sequentially:
    (slope, intercept at t = 0)."""
    s, t = values.shape
    sw, st, sv, stt, stv = (np.zeros(s, F32) for _ in range(5))
    for j in range(t):
        x, tt = values[:, j], times[:, j]
        w = np.where(valid[:, j], weights[:, j], _ZERO).astype(F32)
        wt = w * tt
        sw = sw + w
        st = _fma(w, tt, st)
        sv = _fma(w, x, sv)
        stt = _fma(wt, tt, stt)
        stv = _fma(wt, x, stv)
    den = _fma(sw, stt, -(st * st))
    num = _fma(sw, stv, -(st * sv))
    ok = den > 0
    slope = np.where(ok, num / np.where(ok, den, _ONE), _ZERO).astype(F32)
    sw_safe = np.where(sw > 0, sw, _ONE).astype(F32)
    return slope, _fma(-slope, st / sw_safe, sv / sw_safe)


def _residuals(values, valid, times, weights, slope, intercept):
    """Weighted (sum of squared residuals, sum of weights), sequential."""
    s, t = values.shape
    sse, sw = np.zeros(s, F32), np.zeros(s, F32)
    for j in range(t):
        w = np.where(valid[:, j], weights[:, j], _ZERO).astype(F32)
        r = values[:, j] - _fma(slope, times[:, j], intercept)
        sse = _fma(w * r, r, sse)
        sw = sw + w
    return sse, sw


def _holt_winters(fc, values, valid):
    """The masked recurrence: final (level, trend, seasons, count)."""
    s, t = values.shape
    season = _i32(fc["season"])
    period = np.clip(season, 1, t)
    seasonal = season >= 2
    alpha, beta, gamma = _f32(fc["alpha"]), _f32(fc["beta"]), _f32(fc["gamma"])
    level, trend = np.zeros(s, F32), np.zeros(s, F32)
    seas = np.zeros((s, t), F32)
    count = np.zeros(s, np.int32)
    seen = np.zeros(s, bool)
    rows = np.arange(s)
    for j in range(t):
        x, v = values[:, j], valid[:, j]
        slot = np.mod(count, period)
        s_old = np.where(seasonal, seas[rows, slot], _ZERO)
        first = v & ~seen
        q = level + trend
        new_level = _fma(alpha, (x - s_old) - q, q)
        new_trend = _fma(beta, (new_level - level) - trend, trend)
        new_season = _fma(gamma, (x - new_level) - s_old, s_old)
        level = np.where(first, x, np.where(v, new_level, level)).astype(F32)
        trend = np.where(first, _ZERO, np.where(v, new_trend, trend)
                         ).astype(F32)
        write = v & seasonal
        seas[rows[write], slot[write]] = new_season[write]
        count = np.where(v, count + 1, count).astype(np.int32)
        seen |= v
    return level, trend, seas, count


def forecast(fc: dict) -> Dict[str, np.ndarray]:
    values, valid = _f32(fc["values"]), np.asarray(fc["valid"], bool)
    times, base = _f32(fc["times"]), _f32(fc["weights"])
    horizon = _f32(fc["horizon"])

    slope0, icept0 = _line(values, valid, times, base)
    sse0, sw0 = _residuals(values, valid, times, base, slope0, icept0)
    scale2 = sse0 / np.where(sw0 > 0, sw0, _ONE).astype(F32)
    r = values - _fma(slope0[:, None], times,
                      np.broadcast_to(icept0[:, None], values.shape))
    r2 = r * r
    k2s = (_HUBER_K * _HUBER_K) * scale2
    robust = base * np.where(r2 > k2s[:, None],
                             k2s[:, None] / np.where(r2 > 0, r2, _ONE),
                             _ONE).astype(F32)
    slope, icept = _line(values, valid, times, robust)
    sse, swr = _residuals(values, valid, times, robust, slope, icept)
    sigma2 = (sse / np.where(swr > 0, swr, _ONE)).astype(F32)
    point_line = _fma(slope, horizon, icept)

    level, trend, seas, count = _holt_winters(fc, values, valid)
    steps = (horizon / np.maximum(_f32(fc["step_s"]), _MIN_STEP_S)).astype(F32)
    season = _i32(fc["season"])
    target = np.mod(np.maximum(count - 1, 0) + np.round(steps).astype(np.int32),
                    np.clip(season, 1, values.shape[1]))
    seas_at = np.where(season >= 2, seas[np.arange(values.shape[0]), target],
                       _ZERO)
    point_hw = _fma(trend, steps, level) + seas_at

    point = np.where(_i32(fc["model"]) == MODEL_HOLT_WINTERS, point_hw,
                     point_line).astype(F32)
    point = np.where(count > 0, point, _ZERO).astype(F32)
    return {"point": point, "sigma2": sigma2, "n_valid": count}


# -- 2. the forecast -> decide seam --------------------------------------------


def scatter(ops: dict, fout: dict, n: int, m: int):
    """(blend value, blend valid, (dist point, dist sigma2, dist valid)),
    each [N, M]: a gated series writes its cell, every other cell is 0
    and False."""
    rows = np.asarray(ops["series_row"], np.int64)
    cols = np.asarray(ops["series_col"], np.int64)
    dist_gate = (fout["n_valid"] >= _i32(ops["series_need"])) & (rows < n)
    blend_gate = np.asarray(ops["series_blend"], bool) & dist_gate

    def grid(gate, values, dtype):
        out = np.zeros((n, m), dtype)
        out[rows[gate], cols[gate]] = values[gate]
        return out

    true = np.ones(rows.shape, bool)
    return (grid(blend_gate, fout["point"], F32),
            grid(blend_gate, true, bool),
            (grid(dist_gate, fout["point"], F32),
             grid(dist_gate, fout["sigma2"], F32),
             grid(dist_gate, true, bool)))


# -- 3. decide -------------------------------------------------------------------


def _ceil_guarded(x) -> np.ndarray:
    return np.ceil((x - _GUARD).astype(F32)).astype(F32)


def _recommendations(dec: dict, values) -> np.ndarray:
    """Per-metric desired replicas, f32[N, M]."""
    values, target = _f32(values), _f32(dec["target_value"])
    kind = _i32(dec["target_type"])
    ratio = np.where(target != 0,
                     (values / np.where(target != 0, target, _ONE)
                      .astype(F32)).astype(F32),
                     _ZERO).astype(F32)
    status = _i32(dec["status_replicas"])[:, None].astype(F32)
    proportional = (status * ratio).astype(F32)
    return np.select(
        [kind == TYPE_VALUE, kind == TYPE_AVERAGE_VALUE,
         kind == TYPE_UTILIZATION],
        [np.maximum(_ONE, _ceil_guarded(proportional)),
         _ceil_guarded(ratio),
         np.maximum(_ONE, _ceil_guarded((proportional * F32(100.0))
                                        .astype(F32)))],
        np.broadcast_to(status, ratio.shape),
    ).astype(F32)


def decide(dec: dict, forecast_value, forecast_valid) -> Dict[str, np.ndarray]:
    valid = np.asarray(dec["metric_valid"], bool)
    rec = _recommendations(dec, dec["metric_value"])
    if forecast_value is not None:
        blend = np.asarray(forecast_valid, bool) & valid
        rec = np.where(blend, np.maximum(
            rec, _recommendations(dec, forecast_value)), rec).astype(F32)
    spec = _i32(dec["spec_replicas"]).astype(F32)

    # the select policy, by direction
    any_valid = np.any(valid, axis=1)
    any_up = np.any(valid & (rec > spec[:, None]), axis=1)
    any_down = np.any(valid & (rec < spec[:, None]), axis=1)
    policy = np.where(any_up, _i32(dec["up_policy"]), np.where(
        any_down, _i32(dec["down_policy"]), POLICY_DISABLED)).astype(np.int32)
    rec_max = np.max(np.where(valid, rec, _F32_LOW), axis=1).astype(F32)
    rec_min = np.min(np.where(valid, rec, _F32_HIGH), axis=1).astype(F32)
    selected = np.select([policy == POLICY_MAX, policy == POLICY_MIN],
                         [rec_max, rec_min], spec).astype(F32)
    selected = np.where(any_valid, selected, spec).astype(F32)

    # the stabilization windows
    up, down = selected > spec, selected < spec
    window = np.where(up, _i32(dec["up_window"]), np.where(
        down, _i32(dec["down_window"]), 0)).astype(F32)
    last = _f32(dec["last_scale_time"])
    has_last = np.asarray(dec["has_last_scale"], bool)
    elapsed = (F32(dec["now"]) - last).astype(F32)
    within = (up | down) & has_last & (elapsed < window)
    window_end = (last + window).astype(F32)
    limited = np.where(within, spec, selected).astype(F32)

    def allowed(direction):
        """(allowed move, seconds until the binding budget frees)."""
        ptype = _i32(dec[f"{direction}_ptype"])
        value = _i32(dec[f"{direction}_pvalue"]).astype(F32)
        period = _i32(dec[f"{direction}_pperiod"]).astype(F32)
        pvalid = np.asarray(dec[f"{direction}_pvalid"], bool)
        select = _i32(dec[f"{direction}_policy"])
        scale = np.maximum(spec[:, None], _ONE).astype(F32)
        budget = np.where(
            ptype == POLICY_TYPE_PERCENT,
            _ceil_guarded(((scale * value).astype(F32) / F32(100.0))
                          .astype(F32)),
            value).astype(F32)
        spent = has_last[:, None] & (elapsed[:, None] < period)
        per_policy = np.where(spent, _ZERO, budget).astype(F32)
        most = np.max(np.where(pvalid, per_policy, _F32_LOW), axis=1)
        least = np.min(np.where(pvalid, per_policy, _F32_HIGH), axis=1)
        move = np.where(select == POLICY_MIN, least, most).astype(F32)
        unlimited = ~np.any(pvalid, axis=1) | ~has_last
        soonest = np.min(np.where(pvalid, period, _F32_HIGH), axis=1)
        latest = np.max(np.where(pvalid, period, _F32_LOW), axis=1)
        frees = np.where(select == POLICY_MIN, latest, soonest).astype(F32)
        return np.where(unlimited, _F32_HIGH, move).astype(F32), frees

    allowed_up, up_frees = allowed("up")
    allowed_down, down_frees = allowed("down")
    clamped = np.clip(limited, (spec - allowed_down).astype(F32),
                      (spec + allowed_up).astype(F32)).astype(F32)
    rate_limited = clamped != limited
    held = rate_limited & (clamped == spec)
    rate_end = (last + np.where(limited > spec, up_frees, down_frees)
                ).astype(F32)
    limited = clamped

    bounded = np.clip(limited, _i32(dec["min_replicas"]).astype(F32),
                      _i32(dec["max_replicas"]).astype(F32)).astype(F32)
    up_hold = has_last & (elapsed < _i32(dec["up_window"]).astype(F32))
    down_hold = has_last & (elapsed < _i32(dec["down_window"]).astype(F32))
    return {
        "desired": _to_i32(bounded),
        "recommendation": _to_i32(selected),
        "limited": _to_i32(limited),
        "able_to_scale": ~within & ~held,
        "scaling_unbounded": bounded == limited,
        "able_at": np.where(held, rate_end, window_end).astype(F32),
        "rate_limited": rate_limited,
        "up_ceiling": _to_i32(np.where(
            up_hold, spec, (spec + allowed_up).astype(F32)).astype(F32)),
        "down_floor": _to_i32(np.where(
            down_hold, spec, (spec - allowed_down).astype(F32)).astype(F32)),
    }


# -- 4. the demand seam, shared by cost and pool groups ------------------------


def demand(observed, prior_point, prior_sigma2, have, valid):
    """(mu, sigma): max(observed, a known finite prior point), and the
    square root of a known positive finite prior sigma2; 0 off `valid`."""
    observed = _f32(observed)
    with np.errstate(invalid="ignore"):
        mu = np.where(have & np.isfinite(prior_point),
                      np.maximum(observed, prior_point), observed)
        sigma = np.where(have & np.isfinite(prior_sigma2) & (prior_sigma2 > 0),
                         np.sqrt(prior_sigma2), _ZERO)
    valid = np.asarray(valid, bool)
    return (np.where(valid, mu, _ZERO).astype(F32),
            np.where(valid, sigma, _ZERO).astype(F32))


def _overlay(prior_point, prior_sigma2, prior_valid, fresh):
    """The fresh distribution (point, sigma2, ok) over the host-read prior."""
    point, sigma2, ok = fresh
    return (np.where(ok, point, prior_point), np.where(ok, sigma2, prior_sigma2),
            ok | np.asarray(prior_valid, bool))


def _bounds(valid, spec_min, spec_max, floor, ceiling):
    """The spec bounds clamped by the movement bounds (spec outranks)."""
    spec_min, spec_max = _i32(spec_min), _i32(spec_max)
    return (np.where(valid, np.maximum(spec_min, np.minimum(floor, spec_max)),
                     0).astype(np.int32),
            np.where(valid, np.minimum(spec_max, np.maximum(ceiling, spec_min)),
                     0).astype(np.int32))


# -- 5. the candidate ladder, any leading shape --------------------------------


def ladder(base, low, high, unit, rate, weight, budget, valid, slo_target,
           mu, sigma, dvalid):
    """Each row's 8 candidates, their risk and score, the first least
    score's index, and what the outputs need (trailing axes [..., K] and
    [..., K, M])."""
    base = _i32(base).astype(F32)
    low, high = _i32(low).astype(F32), _i32(high).astype(F32)
    cap_on = valid & (unit > 0) & (budget > 0)
    cap = np.floor(budget / np.where(unit > 0, unit, _ONE).astype(F32)
                   ).astype(F32)
    hi = np.where(cap_on, np.minimum(high, np.maximum(cap, low)), high
                  ).astype(F32)
    cand = np.clip(base[..., None] + np.arange(CANDIDATES, dtype=F32),
                   low[..., None], hi[..., None]).astype(F32)
    demand_hi = (mu + sigma).astype(F32)
    denom = np.maximum(demand_hi, _EPS)[..., None, :].astype(F32)
    short = _fma(-cand[..., :, None], slo_target[..., None, :],
                 demand_hi[..., None, :])
    short = np.clip((short / denom).astype(F32), _ZERO, _ONE)
    short = np.where(dvalid[..., None, :], short, _ZERO).astype(F32)
    risk = np.max(short, axis=-1)
    score = _fma(weight[..., None], risk,
                 (cand * rate[..., None]).astype(F32))
    needed = np.ceil((demand_hi / np.maximum(slo_target, _EPS)).astype(F32)
                     ).astype(F32)
    needed = np.max(np.where(dvalid, needed, _ZERO).astype(F32), axis=-1)
    return {"base": base, "hi": hi, "cap_on": cap_on, "cand": cand,
            "risk": risk, "score": score, "needed": needed,
            "k_star": np.argmin(score, axis=-1)}


def _finish(lad, chosen, chosen_risk, valid, unit) -> Dict[str, np.ndarray]:
    base = lad["base"]
    desired = np.where(valid, chosen, base).astype(F32)
    headroom = np.maximum(lad["needed"] - chosen, _ZERO)
    return {
        "desired": _to_i32(desired),
        "expected_hourly": (desired * unit).astype(F32),
        "violation_risk": np.where(valid, chosen_risk, _ZERO).astype(F32),
        "headroom": _to_i32(np.where(valid, headroom, _ZERO)),
        "cost_limited": lad["cap_on"] & (base > lad["hi"]),
        "slo_raised": valid & (chosen > base),
    }


def cost(ops: dict, dout: dict, fresh) -> Dict[str, np.ndarray]:
    valid = np.asarray(ops["slo_valid"], bool)
    point, sigma2, have = _f32(ops["prior_point"]), _f32(ops["prior_sigma2"]), \
        np.asarray(ops["prior_valid"], bool)
    if fresh is not None:
        point, sigma2, have = _overlay(point, sigma2, have, fresh)
    mu, sigma = demand(ops["observed"], point, sigma2, have,
                       ops["demand_base_valid"])
    low, high = _bounds(valid, ops["ha_min"], ops["ha_max"],
                        dout["down_floor"], dout["up_ceiling"])
    unit = _f32(ops["unit_cost"])
    lad = ladder(dout["desired"], low, high, unit, unit,
                 _f32(ops["slo_weight"]), _f32(ops["max_hourly_cost"]), valid,
                 _f32(ops["slo_target"]), mu, sigma,
                 np.asarray(ops["demand_base_valid"], bool))
    rows = np.arange(valid.shape[0])
    return _finish(lad, lad["cand"][rows, lad["k_star"]],
                   lad["risk"][rows, lad["k_star"]], valid, unit)


# -- 6. pool groups ----------------------------------------------------------------


def _violations(pg: dict, counts, spend) -> np.ndarray:
    """i32[G, C]: ratio bands broken (integer cross products) plus one
    for a group budget overspent, per joint candidate."""
    g, p, _ = counts.shape
    rows = np.arange(g)
    viol = np.zeros(spend.shape, np.int32)
    for r in range(np.asarray(pg["ratio_a"]).shape[1]):
        n_a = counts[rows, np.clip(_i32(pg["ratio_a"])[:, r], 0, p - 1)]
        n_b = counts[rows, np.clip(_i32(pg["ratio_b"])[:, r], 0, p - 1)]
        low = n_a * _i32(pg["ratio_min_den"])[:, r, None] < \
            n_b * _i32(pg["ratio_min_num"])[:, r, None]
        high = n_a * _i32(pg["ratio_max_den"])[:, r, None] > \
            n_b * _i32(pg["ratio_max_num"])[:, r, None]
        live = np.asarray(pg["ratio_valid"], bool)[:, r, None]
        viol = viol + np.where(live & low, np.int32(1), np.int32(0))
        viol = viol + np.where(live & high, np.int32(1), np.int32(0))
    budget = _f32(pg["group_budget"])[:, None]
    return viol + np.where((budget > 0) & (spend > budget), np.int32(1),
                           np.int32(0))


def poolgroup(pg: dict, final_desired, dout: dict, fresh
              ) -> Dict[str, np.ndarray]:
    final_desired = _i32(final_desired)
    n = final_desired.shape[0]
    member = np.clip(_i32(pg["member_row"]), 0, n - 1)
    valid = np.asarray(pg["pool_valid"], bool)
    base = np.where(valid, final_desired[member], 0).astype(np.int32)
    low, high = _bounds(valid, pg["pg_min"], pg["pg_max"],
                        _i32(dout["down_floor"])[member],
                        _i32(dout["up_ceiling"])[member])
    point, sigma2, have = _f32(pg["prior_point"]), _f32(pg["prior_sigma2"]), \
        np.asarray(pg["prior_valid"], bool)
    if fresh is not None:
        point, sigma2, have = _overlay(
            point, sigma2, have, tuple(grid[member] for grid in fresh))
    dvalid = np.asarray(pg["demand_base_valid"], bool)
    mu, sigma = demand(pg["observed"], point, sigma2, have, dvalid)
    unit = _f32(pg["unit_cost"])
    lad = ladder(base, low, high, unit,
                 (unit + _f32(pg["tier_penalty"])).astype(F32),
                 _f32(pg["slo_weight"]), _f32(pg["max_hourly_cost"]), valid,
                 _f32(pg["slo_target"]), mu, sigma, dvalid)

    g, p = base.shape
    c = CANDIDATES ** p
    # joint candidate c takes ladder index (c // K**pool) % K in each pool
    digits = ((np.arange(c)[None, :] // (CANDIDATES ** np.arange(p)[:, None]))
              % CANDIDATES).astype(np.int32)
    index = np.broadcast_to(digits[None], (g, p, c))
    cand_j = np.take_along_axis(lad["cand"], index, axis=2)
    score_j = np.take_along_axis(lad["score"], index, axis=2)
    risk_j = np.take_along_axis(lad["risk"], index, axis=2)
    total = score_j[:, 0, :]
    spend = (cand_j[:, 0, :] * unit[:, 0, None]).astype(F32)
    for pool in range(1, p):
        total = (score_j[:, pool, :] + total).astype(F32)
        spend = _fma(cand_j[:, pool, :], unit[:, pool, None], spend)
    viol = _violations(pg, cand_j.astype(np.int32), spend)

    k_star = lad["k_star"].astype(np.int32)
    independent = k_star[:, 0].copy()
    for pool in range(1, p):
        independent = (independent + k_star[:, pool]
                       * np.int32(CANDIDATES ** pool)).astype(np.int32)
    rows = np.arange(g)
    fewest = np.min(viol, axis=1)
    repair = np.argmin(np.where(viol == fewest[:, None], total, F32(np.inf))
                       .astype(F32), axis=1).astype(np.int32)
    selected = np.where(viol[rows, independent] == 0, independent, repair
                        ).astype(np.int32)
    pools = np.arange(p)[None, :]
    out = _finish(lad, cand_j[rows[:, None], pools, selected[:, None]],
                  risk_j[rows[:, None], pools, selected[:, None]], valid, unit)
    group_valid = np.asarray(pg["group_valid"], bool)
    out.update(
        ratio_ok=group_valid & (viol[rows, selected] == 0),
        group_hourly=np.where(group_valid, spend[rows, selected], _ZERO
                              ).astype(F32),
        joint_repair=group_valid & (selected != independent),
    )
    return out


# -- the tick ------------------------------------------------------------------


def fleet_tick(ops: dict) -> Dict[str, Dict[str, np.ndarray]]:
    """Every output leaf of the tick, stage by stage, floats as float32."""
    missing = [k for k in ("forecast", "slo_valid", "poolgroup")
               if ops.get(k) is None]
    if missing:
        raise ValueError(f"the reference runs the all-stages tick; "
                         f"missing {missing}")
    dec = ops["decision"]
    n, m = np.asarray(dec["metric_value"]).shape
    fout = forecast(ops["forecast"])
    blend_value, blend_valid, fresh = scatter(ops, fout, n, m)
    dout = decide(dec, blend_value, blend_valid)
    cout = cost(ops, dout, fresh)
    pout = poolgroup(ops["poolgroup"], cout["desired"], dout, fresh)
    return {"decision": dout, "forecast": fout, "cost": cout,
            "poolgroup": pout}


def _with_bits(tree: dict) -> dict:
    return {stage: {name: bits(x) if np.asarray(x).dtype == F32 else x
                    for name, x in leaves.items()}
            for stage, leaves in tree.items()}


def _rounded(ops: dict) -> dict:
    """The operands with histories and observed values in bfloat16."""
    out = dict(ops)
    out["decision"] = dict(ops["decision"], metric_value=to_bf16(
        ops["decision"]["metric_value"]))
    out["forecast"] = dict(ops["forecast"], values=to_bf16(
        ops["forecast"]["values"]))
    out["observed"] = to_bf16(ops["observed"])
    out["poolgroup"] = dict(ops["poolgroup"], observed=to_bf16(
        ops["poolgroup"]["observed"]))
    return out


# -- what the harness and the control call (the configuration's
# "reference" names this module) --


def answer(config: dict, ops: dict) -> dict:
    """The reference's answer to one tick's operands, floats as bits."""
    return _with_bits(fleet_tick(ops))


def control(config: dict, ops: dict) -> dict:
    """The control: the tick on bfloat16 histories and observed values."""
    return _with_bits(fleet_tick(_rounded(ops)))


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return 0 if tree is None else int(np.asarray(tree).nbytes)


def tick_ops(ops: dict) -> int:
    """Elementwise operations of one tick by the steps above: a fused
    multiply-add counts 2; a compare, select, min, max or gather 1.

    forecast, per series and sample: 2 line fits x 11 (weight select,
    w*t, 4 FMAs, an add), 2 residual passes x 8, the reweight 9, the
    Holt-Winters step 27 (slot, gather, 3 lerps of 4, selects, the
    season write, the count); per series 30 more (fit finals, the
    projection);
    decide, per metric cell: 2 x 15 (the recommendation by type) + 8 (the
    blend and select); per autoscaler 40, per policy slot and direction 12;
    the ladder, per candidate: 3 (offset, clip) + 7 per metric (shortfall
    FMA, divide, clip, mask, max) + 3 (rate, score FMA) and 1 for the
    argmin; per metric cell 6 (demand, seam, needed);
    pool groups, per joint candidate: 3 gathers and 3 adds per pool, 8 per
    ratio slot, 3 for the budget, 3 for the selection."""
    fc = ops["forecast"]
    s, t = np.asarray(fc["values"]).shape
    dec = ops["decision"]
    n, m = np.asarray(dec["metric_value"]).shape
    k = np.asarray(dec["up_ptype"]).shape[1]
    pg = ops["poolgroup"]
    g, p = np.asarray(pg["member_row"]).shape
    slots = np.asarray(pg["ratio_a"]).shape[1]
    per_rung = 3 + 7 * m + 3 + 1
    forecast_ops = s * t * (2 * 11 + 2 * 8 + 9 + 27) + s * 30
    decide_ops = n * m * (2 * 15 + 8) + n * 40 + n * 2 * k * 12
    cost_ops = n * CANDIDATES * per_rung + n * m * 6
    joint = CANDIDATES ** p
    pool_ops = (g * p * CANDIDATES * per_rung + g * p * m * 6
                + g * joint * (6 * p + 8 * slots + 3 + 3))
    return int(forecast_ops + decide_ops + cost_ops + pool_ops)


def work(config: dict, ops: dict, want: dict) -> dict:
    """{"fused_tick": (operations, bytes)} of one tick: every operand byte
    read once and every output byte written once (the unpadded operands
    the client sends), and `tick_ops`."""
    return {"fused_tick": (tick_ops(ops), _nbytes(ops) + _nbytes(want))}

