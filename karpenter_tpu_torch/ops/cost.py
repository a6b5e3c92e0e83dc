"""Batched cost x SLO-risk refinement of fleet decisions (counterpart of
karpenter_tpu/ops/cost.py).

Per autoscaler, CANDIDATES replica counts around the base decision
(clipped to [min, max] and to the affordable ceiling of the hourly
budget) are scored

    score(n) = violationCostWeight * risk(n) + n * unitHourlyCost

where risk(n) is the normalized one-sigma demand shortfall that n
replicas' SLO capacity cannot absorb, maxed over the metrics; the first
minimum wins (torch.argmin keeps the first index on ties, so weight 0
keeps candidate 0, the base decision). A row without an SLO passes
through unchanged.

The outputs equal the reference's numpy mirror (`cost_numpy`) bit for
bit: its two multiply-adds, the score and the shortfall
`demand_hi - cand * slo_target`, are each rounded once (`fma`, in f64);
every other op is elementwise IEEE f32 or an order-free max over M.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from karpenter_tpu_torch.forecast.models import fma
from karpenter_tpu_torch.ops.decision import clip, to_i32
from karpenter_tpu_torch.utils.operands import BOOL, F32, I32, Operands

# candidate ladder width: each row scores base .. base + CANDIDATES - 1
CANDIDATES = 8

_EPS = float(np.float32(1e-6))


@dataclass
class CostInputs(Operands):
    """Structure-of-tensors cost/SLO view of the fleet (rows past the live
    fleet carry slo_valid=False and pass through)."""

    base_desired: torch.Tensor  # i32[N] the decide() output being refined
    min_replicas: torch.Tensor  # i32[N]
    max_replicas: torch.Tensor  # i32[N]
    unit_cost: torch.Tensor  # f32[N] hourly cost per replica (0 = unknown)
    slo_weight: torch.Tensor  # f32[N] violationCostWeight ($/h at risk 1.0)
    max_hourly_cost: torch.Tensor  # f32[N] hard budget (0 = uncapped)
    slo_valid: torch.Tensor  # bool[N] row carries an SLO
    slo_target: torch.Tensor  # f32[N, M] per-replica SLO capacity
    demand_mu: torch.Tensor  # f32[N, M] demand point
    demand_sigma: torch.Tensor  # f32[N, M] forecast spread (0 = none)
    demand_valid: torch.Tensor  # bool[N, M]

    KINDS = {
        "base_desired": I32, "min_replicas": I32, "max_replicas": I32,
        "unit_cost": F32, "slo_weight": F32, "max_hourly_cost": F32,
        "slo_valid": BOOL, "slo_target": F32, "demand_mu": F32,
        "demand_sigma": F32, "demand_valid": BOOL,
    }


@dataclass
class CostOutputs(Operands):
    desired: torch.Tensor  # i32[N] the choice (== base when !slo_valid)
    expected_hourly: torch.Tensor  # f32[N] desired * unit_cost
    violation_risk: torch.Tensor  # f32[N] risk at the chosen count
    headroom: torch.Tensor  # i32[N] one-sigma demand replicas beyond desired
    cost_limited: torch.Tensor  # bool[N] budget capped below the base
    slo_raised: torch.Tensor  # bool[N] risk bought replicas above base

    KINDS = {
        "desired": I32, "expected_hourly": F32, "violation_risk": F32,
        "headroom": I32, "cost_limited": BOOL, "slo_raised": BOOL,
    }


def ladder(base, min_f, max_f, unit_cost, max_hourly_cost, valid):
    """(candidates [..., K], budget on, upper bound): base + 0..K-1 clipped
    to [min, hi], hi the affordable ceiling floor(budget / unit) where a
    budget applies, never below min, and max otherwise."""
    offsets = torch.arange(CANDIDATES, dtype=F32, device=base.device)
    cap_on = valid & (unit_cost > 0) & (max_hourly_cost > 0)
    safe_unit = torch.where(unit_cost > 0, unit_cost, 1.0)
    cap = torch.floor(max_hourly_cost / safe_unit)
    hi = torch.where(cap_on, torch.minimum(max_f, torch.maximum(cap, min_f)), max_f)
    cand = clip(base[..., None] + offsets, min_f[..., None], hi[..., None])
    return cand, cap_on, hi


def risk_of(cand, demand_hi, slo_target, demand_valid):
    """f32[..., K]: the normalized one-sigma shortfall of each candidate's
    capacity, in [0, 1], maxed over the valid metrics."""
    denom = torch.clamp_min(demand_hi, _EPS)[..., None, :]
    # demand_hi - cand * slo_target, one rounding
    shortfall = fma(-cand[..., None], slo_target[..., None, :], demand_hi[..., None, :])
    short = torch.clamp(shortfall / denom, 0.0, 1.0)
    short = torch.where(demand_valid[..., None, :], short, 0.0)
    return short.amax(dim=-1)


def headroom_need(demand_hi, slo_target, demand_valid):
    """f32[...]: replicas the one-sigma demand needs, maxed over metrics."""
    needed = torch.ceil(demand_hi / torch.clamp_min(slo_target, _EPS))
    return torch.where(demand_valid, needed, 0.0).amax(dim=-1)


def cost_decide(inputs: CostInputs) -> CostOutputs:
    """The batched refinement program (module docstring)."""
    base = inputs.base_desired.to(F32)
    cand, cap_on, hi = ladder(
        base, inputs.min_replicas.to(F32), inputs.max_replicas.to(F32),
        inputs.unit_cost, inputs.max_hourly_cost, inputs.slo_valid,
    )  # [N, K]
    demand_hi = inputs.demand_mu + inputs.demand_sigma  # [N, M]
    risk = risk_of(cand, demand_hi, inputs.slo_target, inputs.demand_valid)
    hourly = cand * inputs.unit_cost[:, None]
    score = fma(inputs.slo_weight[:, None], risk, hourly)

    k_star = torch.argmin(score, dim=1, keepdim=True)  # first index on ties
    chosen = cand.gather(1, k_star)[:, 0]
    chosen_risk = risk.gather(1, k_star)[:, 0]
    need = headroom_need(demand_hi, inputs.slo_target, inputs.demand_valid)
    headroom = torch.clamp_min(need - chosen, 0.0)

    valid = inputs.slo_valid
    desired = torch.where(valid, chosen, base)
    return CostOutputs(
        desired=to_i32(desired),
        expected_hourly=desired * inputs.unit_cost,
        violation_risk=torch.where(valid, chosen_risk, 0.0),
        headroom=to_i32(torch.where(valid, headroom, 0.0)),
        cost_limited=cap_on & (base > hi),
        slo_raised=valid & (chosen > base),
    )
