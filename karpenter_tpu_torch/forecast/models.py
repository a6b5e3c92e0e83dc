"""Batched forecasting models: every series in one tensor program
(counterpart of karpenter_tpu/forecast/models.py).

Given the fleet's metric histories as one [S, T] matrix, forecast each
series `horizon` seconds ahead with one of two models, chosen per series:

  MODEL_LINEAR       an OLS fit over (time, value), re-weighted once by
                     Huber-style weights on its residuals, projected past
                     the newest sample;
  MODEL_HOLT_WINTERS additive Holt-Winters with a seasonal buffer of
                     `season` slots (season < 2 is plain Holt).

The outputs equal the reference's numpy mirror (`forecast_numpy`) bit for
bit, which fixes the op order:

- each multiply-add the reference writes in single-mul form is one
  rounding: `fma` below computes it in f64 (the product of two f32 is
  exact there) and rounds once to f32, as the mirror's f64 round trip
  does. Never torch.lerp, addcmul or addcdiv: their kernels round in
  their own ways;
- every sum over time is a sequential loop over T of elementwise ops,
  never torch.sum or torch.cumsum, whose orders differ.

Loop-invariant work (the masked weights, the exact f64 products) is taken
out of the T loops as whole [T, S] ops; elementwise, that changes no bit.
The loops run time-major ([T, S], one contiguous row per step).

Histories are right-aligned: the newest sample sits at column T-1 and
shorter series are left-padded with valid=False.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from karpenter_tpu_torch.utils.operands import BOOL, F32, I32, Operands

MODEL_LINEAR = 0
MODEL_HOLT_WINTERS = 1

# Huber-style reweighting threshold, in units of the OLS residual RMS
_HUBER_K2 = 1.5 * 1.5
# floor of the per-step horizon conversion (degenerate spacing)
_MIN_STEP_S = float(np.float32(1e-3))


@dataclass
class ForecastInputs(Operands):
    """Structure-of-tensors snapshot of every forecastable series."""

    values: torch.Tensor  # f32[S, T] observed values, right-aligned
    valid: torch.Tensor  # bool[S, T] sample-present mask
    times: torch.Tensor  # f32[S, T] seconds relative to now (<= 0)
    weights: torch.Tensor  # f32[S, T] base regression weights
    horizon: torch.Tensor  # f32[S] forecast horizon seconds
    step_s: torch.Tensor  # f32[S] mean sample spacing seconds
    model: torch.Tensor  # i32[S] MODEL_* code
    season: torch.Tensor  # i32[S] Holt-Winters season length in samples
    alpha: torch.Tensor  # f32[S] level smoothing
    beta: torch.Tensor  # f32[S] trend smoothing
    gamma: torch.Tensor  # f32[S] seasonal smoothing

    KINDS = {
        "values": F32, "valid": BOOL, "times": F32, "weights": F32,
        "horizon": F32, "step_s": F32, "model": I32, "season": I32,
        "alpha": F32, "beta": F32, "gamma": F32,
    }


@dataclass
class ForecastOutputs(Operands):
    point: torch.Tensor  # f32[S] forecast `horizon` seconds ahead
    sigma2: torch.Tensor  # f32[S] robust residual variance
    n_valid: torch.Tensor  # i32[S] samples the fit saw

    KINDS = {"point": F32, "sigma2": F32, "n_valid": I32}


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32(a*b + c) with one rounding: the f32 product is exact in f64."""
    return (a.double() * b.double() + c).float()


def _hw_scan(inputs: ForecastInputs):
    """Masked Holt-Winters recurrence over T; returns the final (level,
    trend, seasonal buffer [S, T], valid-step count)."""
    S, T = inputs.values.shape
    dev = inputs.values.device
    m = inputs.season.clamp(1, T)
    seasonal_on = inputs.season >= 2
    slots = torch.arange(T, dtype=I32, device=dev)[None, :]
    alpha = inputs.alpha.double()
    beta = inputs.beta.double()
    gamma = inputs.gamma.double()
    values = inputs.values.T.contiguous()
    valid = inputs.valid.T.contiguous()

    level = torch.zeros(S, dtype=F32, device=dev)
    trend = torch.zeros(S, dtype=F32, device=dev)
    seas = torch.zeros((S, T), dtype=F32, device=dev)
    cnt = torch.zeros(S, dtype=I32, device=dev)
    seen = torch.zeros(S, dtype=BOOL, device=dev)
    for t in range(T):
        x, v = values[t], valid[t]
        idx = torch.remainder(cnt, m)
        s_old = torch.where(
            seasonal_on, seas.gather(1, idx.long()[:, None])[:, 0], 0.0
        )
        init = v & ~seen
        # the lerp forms c + a*(x - c), one rounding each
        q = level + trend
        nl = (alpha * ((x - s_old) - q).double() + q).float()
        nt = (beta * ((nl - level) - trend).double() + trend).float()
        ns = (gamma * ((x - nl) - s_old).double() + s_old).float()
        level = torch.where(init, x, torch.where(v, nl, level))
        trend = torch.where(init, 0.0, torch.where(v, nt, trend))
        write = (slots == idx[:, None]) & (v & seasonal_on)[:, None]
        seas = torch.where(write, ns[:, None], seas)
        cnt = torch.where(v, cnt + 1, cnt)
        seen = seen | v
    return level, trend, seas, cnt


def _linear_fit(values, valid, times, weights):
    """Weighted least squares of value on time, the sums accumulated
    sequentially over T (inputs time-major, [T, S]); returns (slope,
    intercept at t = 0). Fewer than 2 points or zero time spread collapse
    to slope 0 through the `den` guard."""
    w = torch.where(valid, weights, 0.0)
    wt = w * times
    w64, t64, x64, wt64 = w.double(), times.double(), values.double(), wt.double()
    p_t, p_v, p_tt, p_tv = w64 * t64, w64 * x64, wt64 * t64, wt64 * x64
    z = torch.zeros(values.shape[1], dtype=F32, device=values.device)
    sw, st, sv, stt, stv = z, z, z, z, z
    for t in range(values.shape[0]):
        sw = sw + w[t]
        st = (p_t[t] + st).float()
        sv = (p_v[t] + sv).float()
        stt = (p_tt[t] + stt).float()
        stv = (p_tv[t] + stv).float()
    den = fma(sw, stt, -(st * st))
    num = fma(sw, stv, -(st * sv))
    ok = den > 0
    slope = torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)
    sw_safe = torch.where(sw > 0, sw, 1.0)
    intercept = fma(-slope, st / sw_safe, sv / sw_safe)
    return slope, intercept


def _residual_stats(values, valid, times, weights, slope, intercept):
    """Weighted (sum of squared residuals, sum of weights), sequential
    over T (inputs time-major, [T, S])."""
    w = torch.where(valid, weights, 0.0)
    r = values - fma(slope[None, :], times, intercept[None, :])
    wr = w * r
    p_rr = wr.double() * r.double()
    z = torch.zeros(values.shape[1], dtype=F32, device=values.device)
    sse, sw = z, z
    for t in range(values.shape[0]):
        sse = (p_rr[t] + sse).float()
        sw = sw + w[t]
    return sse, sw


def forecast(inputs: ForecastInputs) -> ForecastOutputs:
    """The batched forecast program (module docstring)."""
    values = inputs.values.T.contiguous()
    valid = inputs.valid.T.contiguous()
    times = inputs.times.T.contiguous()
    base = inputs.weights.T.contiguous()

    # --- robust linear: WLS -> residual scale -> one Huber reweight ---
    slope0, icept0 = _linear_fit(values, valid, times, base)
    sse0, sw0 = _residual_stats(values, valid, times, base, slope0, icept0)
    scale2 = sse0 / torch.where(sw0 > 0, sw0, 1.0)
    # w = min(1, k*scale/|r|), applied squared (no sqrt)
    r = values - fma(slope0[None, :], times, icept0[None, :])
    r2 = r * r
    k2s = (_HUBER_K2 * scale2)[None, :]
    w_rob = base * torch.where(
        r2 > k2s, k2s / torch.where(r2 > 0, r2, 1.0), 1.0
    )
    slope, icept = _linear_fit(values, valid, times, w_rob)
    sse, swr = _residual_stats(values, valid, times, w_rob, slope, icept)
    sigma2_lin = sse / torch.where(swr > 0, swr, 1.0)
    point_lin = fma(slope, inputs.horizon, icept)

    # --- Holt-Winters ---
    level, trend, seas, cnt = _hw_scan(inputs)
    h_steps = inputs.horizon / torch.clamp_min(inputs.step_s, _MIN_STEP_S)
    point_hw = fma(trend, h_steps, level)
    m = inputs.season.clamp(1, inputs.values.shape[1])
    # phase of the target: the newest sample sat at (cnt-1) mod m, the
    # target round(h_steps) later (round is half to even, as jnp.round)
    h_i = torch.round(h_steps).to(I32)
    idx_f = torch.remainder(torch.clamp_min(cnt - 1, 0) + h_i, m)
    seas_at = torch.where(
        inputs.season >= 2, seas.gather(1, idx_f.long()[:, None])[:, 0], 0.0
    )
    point_hw = point_hw + seas_at

    point = torch.where(inputs.model == MODEL_HOLT_WINTERS, point_hw, point_lin)
    # both models report the robust linear residual variance; a series
    # with no samples forecasts 0
    point = torch.where(cnt > 0, point, 0.0)
    return ForecastOutputs(point=point, sigma2=sigma2_lin, n_valid=cnt)


# -- shape plumbing -----------------------------------------------------------
# Extra T slots are left-padded valid=False and extra S rows are fully
# invalid, so padded outputs equal unpadded ones bit for bit.


def pad_forecast_inputs(inputs: ForecastInputs, t_pad: int) -> ForecastInputs:
    """Left-pad the time axis to `t_pad` slots (the newest sample stays at
    T-1). Returns `inputs` unchanged when already there."""
    t = inputs.values.shape[1]
    if t == t_pad:
        return inputs
    if t > t_pad:
        raise ValueError(f"history length {t} exceeds bucket {t_pad}")

    def left(a):
        return torch.nn.functional.pad(a, (t_pad - t, 0))

    return dataclasses.replace(
        inputs,
        values=left(inputs.values),
        valid=left(inputs.valid),
        times=left(inputs.times),
        weights=left(inputs.weights),
    )


def concat_forecast_inputs(
    padded: List[ForecastInputs], s_pad: int
) -> ForecastInputs:
    """Stack same-T inputs along the series axis and bottom-pad with
    all-invalid (all-zero) rows to `s_pad`."""
    total = sum(p.values.shape[0] for p in padded)
    extra = s_pad - total

    def cat(name: str):
        out = torch.cat([getattr(p, name) for p in padded], dim=0)
        if extra > 0:
            out = torch.cat([out, out.new_zeros((extra,) + out.shape[1:])])
        return out

    return ForecastInputs(
        **{f.name: cat(f.name) for f in dataclasses.fields(ForecastInputs)}
    )


def slice_forecast_outputs(out: ForecastOutputs, start: int, stop: int):
    """One request's rows out of a stacked dispatch's outputs."""
    return ForecastOutputs(
        point=out.point[start:stop],
        sigma2=out.sigma2[start:stop],
        n_valid=out.n_valid[start:stop],
    )
