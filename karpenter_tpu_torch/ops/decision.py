"""Batched HorizontalAutoscaler decision (counterpart of
karpenter_tpu/ops/decision.py).

One tensor program over all N autoscalers x M metrics:

    recommendation -> select policy (Max/Min/Disabled by direction)
                   -> stabilization window -> Count/Percent rate policies
                   -> [min, max] clamp + condition flags
                   -> per-direction movement bounds (up_ceiling/down_floor)

Every step is elementwise f32 or an order-free reduction over M or K, and
each op is the reference's op in the reference's order, so the outputs
equal the reference's numpy mirror (`decide_numpy`) bit for bit on the
CPU and on the card. Three rules keep them equal:

- a division by a constant divides by a tensor: on the card, torch turns
  a division by a Python scalar into a multiply by its reciprocal;
- `jnp.select` is nested `torch.where` in the same order, and `jnp.clip`
  is maximum then minimum, which gives the upper bound when lo > hi;
- f32 -> i32 saturates at [-2**31, 2**31 - 128] before the cast: 2**31 - 1
  is not an f32, and a plain cast of anything past it wraps.

`now` is a 0-d f32 tensor on the device, so a captured CUDA graph reads
it from its buffer instead of baking a Python float into the graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from karpenter_tpu_torch.utils.operands import (
    BOOL,
    F32,
    I32,
    Operands,
    host_seam,
    on_device,
)

# target types (order matters: encoded into int arrays)
TYPE_VALUE = 0
TYPE_AVERAGE_VALUE = 1
TYPE_UTILIZATION = 2
TYPE_UNKNOWN = 3

# select policies
POLICY_MAX = 0
POLICY_MIN = 1
POLICY_DISABLED = 2

# scaling-policy types
POLICY_TYPE_COUNT = 0
POLICY_TYPE_PERCENT = 1

_CEIL_GUARD = 1e-5

# f32 saturation bounds for the final int32 cast: 2**31-128 = 2^7*(2^24-1)
# is the largest f32 below the int32 ceiling (2**31-1 rounds up to 2**31,
# which a cast wraps to INT32_MIN)
_I32_SAFE_MAX = float(2**31 - 128)
_I32_SAFE_MIN = float(-(2**31))

_F32_NEG = float(np.finfo(np.float32).min)
_F32_POS = float(np.finfo(np.float32).max)


@dataclass
class DecisionInputs(Operands):
    """Structure-of-tensors snapshot of every HorizontalAutoscaler (fields
    as in the reference's DecisionInputs)."""

    metric_value: torch.Tensor  # f32[N, M]
    target_value: torch.Tensor  # f32[N, M]
    target_type: torch.Tensor  # i32[N, M]
    metric_valid: torch.Tensor  # bool[N, M]
    spec_replicas: torch.Tensor  # i32[N]
    status_replicas: torch.Tensor  # i32[N]
    min_replicas: torch.Tensor  # i32[N]
    max_replicas: torch.Tensor  # i32[N]
    up_window: torch.Tensor  # i32[N] stabilization seconds
    down_window: torch.Tensor  # i32[N]
    up_policy: torch.Tensor  # i32[N] POLICY_*
    down_policy: torch.Tensor  # i32[N]
    last_scale_time: torch.Tensor  # f32[N] seconds since epoch0
    has_last_scale: torch.Tensor  # bool[N]
    now: torch.Tensor  # f32 0-d, seconds since epoch0
    up_ptype: torch.Tensor  # i32[N, K] POLICY_TYPE_*
    up_pvalue: torch.Tensor  # i32[N, K]
    up_pperiod: torch.Tensor  # i32[N, K] periodSeconds
    up_pvalid: torch.Tensor  # bool[N, K]
    down_ptype: torch.Tensor  # i32[N, K]
    down_pvalue: torch.Tensor  # i32[N, K]
    down_pperiod: torch.Tensor  # i32[N, K]
    down_pvalid: torch.Tensor  # bool[N, K]
    # the proactive blend: predicted metric values (None: reactive only)
    forecast_value: Optional[torch.Tensor] = None  # f32[N, M]
    forecast_valid: Optional[torch.Tensor] = None  # bool[N, M]

    KINDS = {
        "metric_value": F32, "target_value": F32, "target_type": I32,
        "metric_valid": BOOL, "spec_replicas": I32, "status_replicas": I32,
        "min_replicas": I32, "max_replicas": I32, "up_window": I32,
        "down_window": I32, "up_policy": I32, "down_policy": I32,
        "last_scale_time": F32, "has_last_scale": BOOL, "now": F32,
        "up_ptype": I32, "up_pvalue": I32, "up_pperiod": I32,
        "up_pvalid": BOOL, "down_ptype": I32, "down_pvalue": I32,
        "down_pperiod": I32, "down_pvalid": BOOL,
        "forecast_value": F32, "forecast_valid": BOOL,
    }


@dataclass
class DecisionOutputs(Operands):
    desired: torch.Tensor  # i32[N] final bounded decision
    recommendation: torch.Tensor  # i32[N] post-select, pre-limit
    limited: torch.Tensor  # i32[N] post-window/policy, pre-[min, max]
    able_to_scale: torch.Tensor  # bool[N] False iff held by window or policy
    scaling_unbounded: torch.Tensor  # bool[N] False iff clamped by [min, max]
    able_at: torch.Tensor  # f32[N] hold end time
    rate_limited: torch.Tensor  # bool[N] a scaling policy clamped
    up_ceiling: torch.Tensor  # i32[N] furthest up move this tick
    down_floor: torch.Tensor  # i32[N] furthest down move this tick

    KINDS = {
        "desired": I32, "recommendation": I32, "limited": I32,
        "able_to_scale": BOOL, "scaling_unbounded": BOOL, "able_at": F32,
        "rate_limited": BOOL, "up_ceiling": I32, "down_floor": I32,
    }


def clip(x, lo, hi):
    """jnp.clip: maximum then minimum (hi wins when lo > hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Saturating f32 -> i32 cast (module docstring)."""
    return torch.clamp(x, _I32_SAFE_MIN, _I32_SAFE_MAX).to(I32)


def _ceil_guarded(x: torch.Tensor) -> torch.Tensor:
    return torch.ceil(x - _CEIL_GUARD)


def _recommendations(
    inputs: DecisionInputs, values: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per-metric desired replicas, f32[N, M]. `values` overrides the
    observed metric values (the forecast blend)."""
    if values is None:
        values = inputs.metric_value
    target = inputs.target_value
    one = torch.ones_like(target)
    # zero target: the ratio collapses to 0, no division by zero
    nonzero = target != 0
    ratio = torch.where(nonzero, values / torch.where(nonzero, target, one), 0.0)
    status = inputs.status_replicas[:, None].to(F32)
    proportional = status * ratio

    by_value = torch.maximum(one, _ceil_guarded(proportional))
    by_average = _ceil_guarded(ratio)
    by_utilization = torch.maximum(one, _ceil_guarded(proportional * 100.0))
    kind = inputs.target_type
    return torch.where(
        kind == TYPE_VALUE,
        by_value,
        torch.where(
            kind == TYPE_AVERAGE_VALUE,
            by_average,
            # an unknown target type keeps the current replicas
            torch.where(kind == TYPE_UTILIZATION, by_utilization, status),
        ),
    )


def _allowed(inputs, spec, elapsed, ptype, pvalue, pperiod, pvalid, select):
    """(allowed step, when the binding budget frees) for one direction's
    Count/Percent policies: a Percent budget is ceil(max(spec, 1) *
    value / 100); a policy whose period has not elapsed since the last
    scale contributes 0; Max select takes the most permissive policy, Min
    the most restrictive; no policy or no scale history is unlimited."""
    base = torch.clamp_min(spec[:, None], 1.0)
    value = pvalue.to(F32)
    hundred = torch.full_like(value, 100.0)
    budget = torch.where(
        ptype == POLICY_TYPE_PERCENT,
        _ceil_guarded(base * value / hundred),
        value,
    )
    period = pperiod.to(F32)
    spent = inputs.has_last_scale[:, None] & (elapsed[:, None] < period)
    per_policy = torch.where(spent, 0.0, budget)
    a_max = torch.where(pvalid, per_policy, _F32_NEG).amax(dim=1)
    a_min = torch.where(pvalid, per_policy, _F32_POS).amin(dim=1)
    allowed = torch.where(select == POLICY_MIN, a_min, a_max)
    unlimited = ~pvalid.any(dim=1) | ~inputs.has_last_scale
    # soonest the binding budget frees: Max select frees when ANY period
    # elapses (min), Min select when ALL do (max)
    p_min = torch.where(pvalid, period, _F32_POS).amin(dim=1)
    p_max = torch.where(pvalid, period, _F32_NEG).amax(dim=1)
    frees = torch.where(select == POLICY_MIN, p_max, p_min)
    return torch.where(unlimited, _F32_POS, allowed), frees


def decide(inputs: DecisionInputs) -> DecisionOutputs:
    """The full decision pipeline, on whatever device the inputs live on
    (host operands: see utils/operands.on_device)."""
    inputs = on_device(inputs)
    rec = _recommendations(inputs)  # f32[N, M]
    if inputs.forecast_value is not None:
        # the proactive blend can only raise a recommendation
        rec_forecast = _recommendations(inputs, inputs.forecast_value)
        blend = inputs.forecast_valid & inputs.metric_valid
        rec = torch.where(blend, torch.maximum(rec, rec_forecast), rec)
    valid = inputs.metric_valid
    spec = inputs.spec_replicas.to(F32)  # [N]

    # --- select policy ---------------------------------------------------
    any_valid = valid.any(dim=1)
    any_up = (valid & (rec > spec[:, None])).any(dim=1)
    any_down = (valid & (rec < spec[:, None])).any(dim=1)
    policy = torch.where(
        any_up,
        inputs.up_policy,
        torch.where(any_down, inputs.down_policy, POLICY_DISABLED),
    )
    rec_max = torch.where(valid, rec, _F32_NEG).amax(dim=1)
    rec_min = torch.where(valid, rec, _F32_POS).amin(dim=1)
    selected = torch.where(
        policy == POLICY_MAX,
        rec_max,
        torch.where(policy == POLICY_MIN, rec_min, spec),
    )
    selected = torch.where(any_valid, selected, spec)

    # --- stabilization window --------------------------------------------
    going_up = selected > spec
    going_down = selected < spec
    window = torch.where(
        going_up,
        inputs.up_window,
        torch.where(going_down, inputs.down_window, 0),
    ).to(F32)
    last = inputs.last_scale_time
    elapsed = inputs.now - last
    within = (going_up | going_down) & inputs.has_last_scale & (elapsed < window)
    window_end = last + window
    limited = torch.where(within, spec, selected)

    # --- scaling policies: per-direction allowed-delta clamp --------------
    allowed_up, up_frees = _allowed(
        inputs, spec, elapsed, inputs.up_ptype, inputs.up_pvalue,
        inputs.up_pperiod, inputs.up_pvalid, inputs.up_policy,
    )
    allowed_down, down_frees = _allowed(
        inputs, spec, elapsed, inputs.down_ptype, inputs.down_pvalue,
        inputs.down_pperiod, inputs.down_pvalid, inputs.down_policy,
    )
    rate_clamped = clip(limited, spec - allowed_down, spec + allowed_up)
    rate_limited = rate_clamped != limited
    # budget exhausted with a move wanted: a transient hold like the window
    fully_held = rate_limited & (rate_clamped == spec)
    rate_end = last + torch.where(limited > spec, up_frees, down_frees)
    limited = rate_clamped

    # within => limited == spec => the rate clamp is a no-op: the two
    # holds exclude each other
    able_to_scale = ~within & ~fully_held
    able_at = torch.where(fully_held, rate_end, window_end)

    # --- bounded limits: [min, max] clamp ----------------------------------
    bounded = clip(
        limited, inputs.min_replicas.to(F32), inputs.max_replicas.to(F32)
    )
    scaling_unbounded = bounded == limited

    # --- movement bounds (the cost stage's candidate ladder respects them) -
    has_last = inputs.has_last_scale
    up_hold = has_last & (elapsed < inputs.up_window.to(F32))
    down_hold = has_last & (elapsed < inputs.down_window.to(F32))
    up_ceiling = torch.where(up_hold, spec, spec + allowed_up)
    down_floor = torch.where(down_hold, spec, spec - allowed_down)

    return DecisionOutputs(
        desired=to_i32(bounded),
        recommendation=to_i32(selected),
        limited=to_i32(limited),
        able_to_scale=able_to_scale,
        scaling_unbounded=scaling_unbounded,
        able_at=able_at,
        rate_limited=rate_limited,
        up_ceiling=to_i32(up_ceiling),
        down_floor=to_i32(down_floor),
    )


# decide() on the card for host operands, one fetch at the seam: the
# BatchAutoscaler's default decider (the reference's is decide_jit)
decide_host = host_seam(decide, DecisionInputs)


# -- numpy mirror -------------------------------------------------------------
# The reference's decide_numpy, copied: the parity oracle for the fused
# tick and the decide stage of its numpy floor (ops/fusedtick.py). It
# takes DecisionInputs whose fields are numpy arrays (or anything
# np.asarray takes) and answers DecisionOutputs of numpy arrays, bit for
# bit equal to decide() above. The f32 constants are the mirror's own
# (numpy scalars), apart from the tensor program's Python floats.

_F32_ONE = np.float32(1.0)
_F32_ZERO = np.float32(0.0)
_F32_GUARD = np.float32(_CEIL_GUARD)
_NP_NEG = np.float32(np.finfo(np.float32).min)
_NP_POS = np.float32(np.finfo(np.float32).max)


def _ceil_guarded_np(x: np.ndarray) -> np.ndarray:
    return np.ceil((x - _F32_GUARD).astype(np.float32)).astype(np.float32)


def _recommendations_numpy(
    inputs: DecisionInputs, values: Optional[np.ndarray] = None
) -> np.ndarray:
    """Host mirror of _recommendations() — bit-identical f32."""
    if values is None:
        values = inputs.metric_value
    values = np.asarray(values, np.float32)
    target = np.asarray(inputs.target_value, np.float32)
    target_type = np.asarray(inputs.target_type, np.int32)
    safe_target = np.where(target != 0, target, _F32_ONE).astype(np.float32)
    ratio = np.where(
        target != 0, (values / safe_target).astype(np.float32), _F32_ZERO
    ).astype(np.float32)
    status = (
        np.asarray(inputs.status_replicas, np.int32)[:, None]
        .astype(np.float32)
    )
    proportional = (status * ratio).astype(np.float32)

    by_value = np.maximum(_F32_ONE, _ceil_guarded_np(proportional))
    by_average = _ceil_guarded_np(ratio)
    by_utilization = np.maximum(
        _F32_ONE,
        _ceil_guarded_np((proportional * np.float32(100.0)).astype(np.float32)),
    )
    fallback = np.broadcast_to(status, ratio.shape)

    return np.select(
        [
            target_type == TYPE_VALUE,
            target_type == TYPE_AVERAGE_VALUE,
            target_type == TYPE_UTILIZATION,
        ],
        [by_value, by_average, by_utilization],
        fallback,
    ).astype(np.float32)


def decide_numpy(inputs: DecisionInputs) -> DecisionOutputs:  # lint: allow-complexity — line-for-line kernel mirror, linear
    """Host mirror of decide() — bit-identical f32/i32 outputs (the
    fused-tick parity contract; see the mirror banner above)."""
    rec = _recommendations_numpy(inputs)
    if inputs.forecast_value is not None:
        rec_forecast = _recommendations_numpy(inputs, inputs.forecast_value)
        blend = (
            np.asarray(inputs.forecast_valid, bool)
            & np.asarray(inputs.metric_valid, bool)
        )
        rec = np.where(
            blend, np.maximum(rec, rec_forecast), rec
        ).astype(np.float32)
    valid = np.asarray(inputs.metric_valid, bool)
    spec = np.asarray(inputs.spec_replicas, np.int32).astype(np.float32)

    any_valid = np.any(valid, axis=1)
    any_up = np.any(valid & (rec > spec[:, None]), axis=1)
    any_down = np.any(valid & (rec < spec[:, None]), axis=1)
    policy = np.where(
        any_up,
        np.asarray(inputs.up_policy, np.int32),
        np.where(
            any_down, np.asarray(inputs.down_policy, np.int32),
            POLICY_DISABLED,
        ),
    ).astype(np.int32)
    rec_max = np.max(np.where(valid, rec, _NP_NEG), axis=1).astype(np.float32)
    rec_min = np.min(np.where(valid, rec, _NP_POS), axis=1).astype(np.float32)
    selected = np.select(
        [policy == POLICY_MAX, policy == POLICY_MIN],
        [rec_max, rec_min],
        spec,
    ).astype(np.float32)
    selected = np.where(any_valid, selected, spec).astype(np.float32)

    going_up = selected > spec
    going_down = selected < spec
    window = np.where(
        going_up,
        np.asarray(inputs.up_window, np.int32),
        np.where(going_down, np.asarray(inputs.down_window, np.int32), 0),
    ).astype(np.float32)
    last = np.asarray(inputs.last_scale_time, np.float32)
    has_last = np.asarray(inputs.has_last_scale, bool)
    elapsed = (np.float32(inputs.now) - last).astype(np.float32)
    moving = going_up | going_down
    within = moving & has_last & (elapsed < window)
    window_end = (last + window).astype(np.float32)
    limited = np.where(within, spec, selected).astype(np.float32)

    def _allowed(ptype, pvalue, pperiod, pvalid, select):
        ptype = np.asarray(ptype, np.int32)
        pvalue_f = np.asarray(pvalue, np.int32).astype(np.float32)
        pperiod_f = np.asarray(pperiod, np.int32).astype(np.float32)
        pvalid = np.asarray(pvalid, bool)
        select = np.asarray(select, np.int32)
        base = np.maximum(spec[:, None], _F32_ONE).astype(np.float32)
        budget = np.where(
            ptype == POLICY_TYPE_PERCENT,
            _ceil_guarded_np(
                (
                    (base * pvalue_f).astype(np.float32)
                    / np.float32(100.0)
                ).astype(np.float32)
            ),
            pvalue_f,
        ).astype(np.float32)
        spent = has_last[:, None] & (elapsed[:, None] < pperiod_f)
        per_policy = np.where(spent, _F32_ZERO, budget).astype(np.float32)
        a_max = np.max(np.where(pvalid, per_policy, _NP_NEG), axis=1)
        a_min = np.min(np.where(pvalid, per_policy, _NP_POS), axis=1)
        allowed = np.where(
            select == POLICY_MIN, a_min, a_max
        ).astype(np.float32)
        unlimited = ~np.any(pvalid, axis=1) | ~has_last
        p_min = np.min(np.where(pvalid, pperiod_f, _NP_POS), axis=1)
        p_max = np.max(np.where(pvalid, pperiod_f, _NP_NEG), axis=1)
        frees = np.where(
            select == POLICY_MIN, p_max, p_min
        ).astype(np.float32)
        return (
            np.where(unlimited, _NP_POS, allowed).astype(np.float32),
            frees,
        )

    allowed_up, up_frees = _allowed(
        inputs.up_ptype,
        inputs.up_pvalue,
        inputs.up_pperiod,
        inputs.up_pvalid,
        inputs.up_policy,
    )
    allowed_down, down_frees = _allowed(
        inputs.down_ptype,
        inputs.down_pvalue,
        inputs.down_pperiod,
        inputs.down_pvalid,
        inputs.down_policy,
    )
    rate_clamped = np.clip(
        limited,
        (spec - allowed_down).astype(np.float32),
        (spec + allowed_up).astype(np.float32),
    ).astype(np.float32)
    rate_limited = rate_clamped != limited
    fully_held = rate_limited & (rate_clamped == spec)
    rate_end = (
        last + np.where(limited > spec, up_frees, down_frees)
    ).astype(np.float32)
    limited = rate_clamped

    able_to_scale = ~within & ~fully_held
    able_at = np.where(fully_held, rate_end, window_end).astype(np.float32)

    bounded = np.clip(
        limited,
        np.asarray(inputs.min_replicas, np.int32).astype(np.float32),
        np.asarray(inputs.max_replicas, np.int32).astype(np.float32),
    ).astype(np.float32)
    scaling_unbounded = bounded == limited

    up_hold = has_last & (
        elapsed < np.asarray(inputs.up_window, np.int32).astype(np.float32)
    )
    down_hold = has_last & (
        elapsed < np.asarray(inputs.down_window, np.int32).astype(np.float32)
    )
    up_ceiling = np.where(
        up_hold, spec, (spec + allowed_up).astype(np.float32)
    ).astype(np.float32)
    down_floor = np.where(
        down_hold, spec, (spec - allowed_down).astype(np.float32)
    ).astype(np.float32)

    def to_i32(x):
        return np.clip(
            x, np.float32(_I32_SAFE_MIN), np.float32(_I32_SAFE_MAX)
        ).astype(np.int32)

    return DecisionOutputs(
        desired=to_i32(bounded),
        recommendation=to_i32(selected),
        limited=to_i32(limited),
        able_to_scale=able_to_scale,
        scaling_unbounded=scaling_unbounded,
        able_at=able_at,
        rate_limited=rate_limited,
        up_ceiling=to_i32(up_ceiling),
        down_floor=to_i32(down_floor),
    )


def pad_to(n: int, bucket: int = 64) -> int:
    """Round a fleet size up to a compile bucket (a floor of one bucket)."""
    if n <= 0:
        return bucket
    return ((n + bucket - 1) // bucket) * bucket
