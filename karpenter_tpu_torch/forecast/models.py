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

`forecast` launches one hand-written CUDA kernel for CUDA tensors
(csrc/forecast.cu, the same arithmetic in the same order, one thread per
series), counts it in LAUNCHES and raises on any failure; for CPU tensors,
and only for them, it runs the PyTorch program above, `forecast_reference`,
which is also what the kernel is held against on the card.

Histories are right-aligned: the newest sample sits at column T-1 and
shorter series are left-padded with valid=False.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.utils.operands import (
    BOOL,
    F32,
    I32,
    Operands,
    host_seam,
    on_device,
)

MODEL_LINEAR = 0
MODEL_HOLT_WINTERS = 1

MODEL_CODES = {
    "linear": MODEL_LINEAR,
    "holt-winters": MODEL_HOLT_WINTERS,
}

_ONE = np.float32(1.0)
_ZERO = np.float32(0.0)

# Huber-style reweighting threshold, in units of the OLS residual RMS
_HUBER_K = np.float32(1.5)
_HUBER_K2 = 1.5 * 1.5
# floor of the per-step horizon conversion (degenerate spacing)
_MIN_STEP_S = float(np.float32(1e-3))

# kernel launches of `forecast` (one a call with series, none for CPU
# tensors). Inside a CUDA graph it counts the eager warm-ups and the
# capture, not the replays.
LAUNCHES = {"forecast": 0}

# csrc/forecast.cu's constants: the series (threads) a block at most and
# the dynamic shared memory a block takes at most (48 KB: no launch needs
# a function attribute)
MAX_SERIES = 32
SHARED_BUDGET = 49152
# the plan halves a block's series until its seasonal buffer leaves room
# for a chunk of this many steps
_MIN_CHUNK = 32


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


def forecast_reference(inputs: ForecastInputs) -> ForecastOutputs:
    """The batched forecast as a PyTorch program (module docstring): the
    plain version of csrc/forecast.cu, on any device."""
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


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def forecast_plan(T: int):
    """(series a block, steps a chunk, dynamic shared bytes, whether the
    seasonal buffer is in shared memory) of csrc/forecast.cu's launch at
    history length T, from T alone. A block takes MAX_SERIES series, or
    half as many until its seasonal buffer (4 T bytes a series) and a
    chunk of min(T, 32) steps (13 (series + 1) bytes a step) fit
    SHARED_BUDGET; past one series the buffer moves to device memory. The
    chunk is then as long as the rest of the budget allows, the whole
    history where it fits."""
    if T < 1:
        raise ValueError(f"forecast: history length {T} < 1")
    series = MAX_SERIES
    while True:
        season_bytes = 4 * T * series
        step_bytes = 13 * (series + 1)
        if season_bytes + step_bytes * min(T, _MIN_CHUNK) <= SHARED_BUDGET:
            shared_season = True
            break
        if series == 1:
            season_bytes, shared_season = 0, False
            break
        series //= 2
    chunk = min(T, (SHARED_BUDGET - season_bytes) // step_bytes)
    return series, chunk, season_bytes + step_bytes * chunk, shared_season


# the [S, T] operands; the others are [S]
_HISTORY_FIELDS = ("values", "valid", "times", "weights")


def forecast(inputs: ForecastInputs) -> ForecastOutputs:
    """The batched forecast (module docstring): one launch of
    csrc/forecast.cu for CUDA tensors, forecast_reference for CPU tensors.
    Host operands are placed as utils/operands.on_device says."""
    inputs = on_device(inputs)
    dev = inputs.values.device
    if dev.type == "cpu":
        return forecast_reference(inputs)
    if dev.type != "cuda":
        raise ValueError(f"forecast: unsupported device {dev}")
    if inputs.values.dim() != 2:
        raise ValueError("forecast: values must be [S, T]")
    S, T = inputs.values.shape
    ops = []
    for f in dataclasses.fields(ForecastInputs):
        t = getattr(inputs, f.name).contiguous()
        want = (S, T) if f.name in _HISTORY_FIELDS else (S,)
        dtype = ForecastInputs.KINDS[f.name]
        if t.dtype != dtype or tuple(t.shape) != want or t.device != dev:
            raise ValueError(
                f"forecast: {f.name} wants {dtype} {want} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        ops.append(t)
    point = torch.empty(S, dtype=torch.float32, device=dev)
    sigma2 = torch.empty(S, dtype=torch.float32, device=dev)
    n_valid = torch.empty(S, dtype=torch.int32, device=dev)
    out = ForecastOutputs(point=point, sigma2=sigma2, n_valid=n_valid)
    if S == 0:
        return out
    series, chunk, shared_bytes, shared_season = forecast_plan(T)
    scratch = None if shared_season else torch.empty(
        -(-S // series) * T * series, dtype=torch.float32, device=dev
    )
    lib = kernels.library("forecast")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.forecast_launch(
            *(t.data_ptr() for t in ops),
            S, T, series, chunk, shared_bytes,
            point.data_ptr(), sigma2.data_ptr(), n_valid.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream,
        )
    kernels.check("forecast", err, "forecast launch")
    LAUNCHES["forecast"] += 1
    return out


# forecast() on the card for host operands, one fetch at the seam: the
# FleetForecaster's default forecast_fn (the reference's is forecast_jit)
forecast_host = host_seam(forecast, ForecastInputs)


# -- shape plumbing -----------------------------------------------------------
# Extra T slots are left-padded valid=False and extra S rows are fully
# invalid, so padded outputs equal unpadded ones bit for bit. Each helper
# takes tensors (any device) or host numpy arrays and answers in kind:
# the solve service pads host operands at its door.


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def pad_forecast_inputs(inputs: ForecastInputs, t_pad: int) -> ForecastInputs:
    """Left-pad the time axis to `t_pad` slots (the newest sample stays at
    T-1). Returns `inputs` unchanged when already there."""
    t = inputs.values.shape[1]
    if t == t_pad:
        return inputs
    if t > t_pad:
        raise ValueError(f"history length {t} exceeds bucket {t_pad}")

    def left(a):
        if _is_tensor(a):
            return torch.nn.functional.pad(a, (t_pad - t, 0))
        a = np.asarray(a)
        out = np.zeros((a.shape[0], t_pad), a.dtype)
        out[:, t_pad - t:] = a
        return out

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
        parts = [getattr(p, name) for p in padded]
        if _is_tensor(parts[0]):
            out = torch.cat(parts, dim=0)
            if extra > 0:
                out = torch.cat([out, out.new_zeros((extra,) + out.shape[1:])])
            return out
        out = np.concatenate([np.asarray(a) for a in parts], axis=0)
        if extra > 0:
            out = np.concatenate(
                [out, np.zeros((extra,) + out.shape[1:], out.dtype)], axis=0
            )
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


# -- numpy mirror -------------------------------------------------------------
# The reference's forecast_numpy, copied: the numpy rung of the service's
# forecast family and the parity oracle. It takes ForecastInputs of numpy
# arrays and answers ForecastOutputs of numpy arrays. `_fma` is its
# f64-rounded multiply-add (`fma` above is the tensor program's); the
# f32 constants are numpy scalars.


def _fma(a, b, c):
    return (
        np.asarray(a, np.float64) * np.asarray(b, np.float64)
        + np.asarray(c, np.float64)
    ).astype(np.float32)


def _np_hw_scan(inputs: ForecastInputs):
    values = np.asarray(inputs.values, np.float32)
    valid = np.asarray(inputs.valid, bool)
    S, T = values.shape
    m = np.clip(np.asarray(inputs.season, np.int32), 1, T)
    seasonal_on = np.asarray(inputs.season, np.int32) >= 2
    alpha = np.asarray(inputs.alpha, np.float32)
    beta = np.asarray(inputs.beta, np.float32)
    gamma = np.asarray(inputs.gamma, np.float32)

    level = np.zeros(S, np.float32)
    trend = np.zeros(S, np.float32)
    seas = np.zeros((S, T), np.float32)
    cnt = np.zeros(S, np.int32)
    seen = np.zeros(S, bool)
    rows = np.arange(S)
    for t in range(T):
        x, v = values[:, t], valid[:, t]
        idx = np.mod(cnt, m)
        s_old = np.where(seasonal_on, seas[rows, idx], _ZERO)
        init = v & ~seen
        q = level + trend
        nl = _fma(alpha, (x - s_old) - q, q)
        nt = _fma(beta, (nl - level) - trend, trend)
        ns = _fma(gamma, (x - nl) - s_old, s_old)
        level = np.where(init, x, np.where(v, nl, level)).astype(np.float32)
        trend = np.where(init, _ZERO, np.where(v, nt, trend)).astype(
            np.float32
        )
        write = v & seasonal_on
        seas[rows[write], idx[write]] = ns[write]
        cnt = np.where(v, cnt + 1, cnt).astype(np.int32)
        seen |= v
    return level, trend, seas, cnt


def _np_linear_fit(values, valid, times, weights):
    S, T = values.shape
    z = np.zeros(S, np.float32)
    sw, st, sv, stt, stv = z.copy(), z.copy(), z.copy(), z.copy(), z.copy()
    for t in range(T):
        x, v, tt, w0 = values[:, t], valid[:, t], times[:, t], weights[:, t]
        w = np.where(v, w0, _ZERO).astype(np.float32)
        wt = w * tt
        sw = sw + w
        st = _fma(w, tt, st)
        sv = _fma(w, x, sv)
        stt = _fma(wt, tt, stt)
        stv = _fma(wt, x, stv)
    den = _fma(sw, stt, -(st * st))
    num = _fma(sw, stv, -(st * sv))
    ok = den > 0
    slope = np.where(ok, num / np.where(ok, den, _ONE), _ZERO).astype(
        np.float32
    )
    sw_safe = np.where(sw > 0, sw, _ONE).astype(np.float32)
    mean_t = st / sw_safe
    mean_v = sv / sw_safe
    intercept = _fma(-slope, mean_t, mean_v)
    return slope, intercept, sw


def _np_residual_stats(values, valid, times, weights, slope, intercept):
    S, T = values.shape
    sse, sw = np.zeros(S, np.float32), np.zeros(S, np.float32)
    for t in range(T):
        x, v, tt, w0 = values[:, t], valid[:, t], times[:, t], weights[:, t]
        w = np.where(v, w0, _ZERO).astype(np.float32)
        r = x - _fma(slope, tt, intercept)
        wr = w * r
        sse = _fma(wr, r, sse)
        sw = sw + w
    return sse, sw


def forecast_numpy(inputs: ForecastInputs) -> ForecastOutputs:
    """Host mirror of forecast() — the numpy degradation path. Produces
    bit-identical f32 outputs (module docstring parity contract)."""
    values = np.asarray(inputs.values, np.float32)
    valid = np.asarray(inputs.valid, bool)
    times = np.asarray(inputs.times, np.float32)
    horizon = np.asarray(inputs.horizon, np.float32)
    base = np.asarray(inputs.weights, np.float32)

    slope0, icept0, _ = _np_linear_fit(values, valid, times, base)
    sse0, sw0 = _np_residual_stats(
        values, valid, times, base, slope0, icept0
    )
    sw0_safe = np.where(sw0 > 0, sw0, _ONE).astype(np.float32)
    scale2 = sse0 / sw0_safe
    r = values - _fma(
        slope0[:, None], times, np.broadcast_to(icept0[:, None], values.shape)
    )
    r2 = r * r
    k2s = (_HUBER_K * _HUBER_K) * scale2
    w_rob = base * np.where(
        r2 > k2s[:, None],
        k2s[:, None] / np.where(r2 > 0, r2, _ONE),
        _ONE,
    ).astype(np.float32)
    slope, icept, _ = _np_linear_fit(values, valid, times, w_rob)
    sse, swr = _np_residual_stats(values, valid, times, w_rob, slope, icept)
    sigma2_lin = (sse / np.where(swr > 0, swr, _ONE)).astype(np.float32)
    point_lin = _fma(slope, horizon, icept)

    level, trend, seas, cnt = _np_hw_scan(inputs)
    step_s = np.maximum(
        np.asarray(inputs.step_s, np.float32), np.float32(_MIN_STEP_S)
    )
    h_steps = (horizon / step_s).astype(np.float32)
    point_hw = _fma(trend, h_steps, level)
    m = np.clip(np.asarray(inputs.season, np.int32), 1, values.shape[1])
    seasonal_on = np.asarray(inputs.season, np.int32) >= 2
    h_i = np.round(h_steps).astype(np.int32)
    idx_f = np.mod(np.maximum(cnt - 1, 0) + h_i, m)
    rows = np.arange(values.shape[0])
    seas_at = np.where(seasonal_on, seas[rows, idx_f], _ZERO)
    point_hw = point_hw + seas_at

    is_hw = np.asarray(inputs.model, np.int32) == MODEL_HOLT_WINTERS
    point = np.where(is_hw, point_hw, point_lin).astype(np.float32)
    sigma2 = sigma2_lin
    point = np.where(cnt > 0, point, _ZERO).astype(np.float32)
    return ForecastOutputs(
        point=point, sigma2=sigma2, n_valid=cnt.astype(np.int32)
    )
