"""Joint candidate-ladder allocation for pool groups (counterpart of
karpenter_tpu/ops/poolgroup.py).

For every group of P pools, each pool scores its K = CANDIDATES ladder
exactly as the cost stage does (ops/cost.py), and the K^P joint
candidates (mixed-radix digits over the pools' ladders) are checked
against the group's constraints: cross-pool ratio bands, by integer
cross-multiplication, and a shared hourly budget. Selection has two
levels: each pool's independent first-index argmin is the answer when
that joint point violates nothing; otherwise the repair picks the fewest
violations, then the cheapest joint score, then the first index.

The outputs equal the reference's numpy mirror (`poolgroup_numpy`) bit
for bit: the per-pool score and the spend accumulation are each rounded
once (`fma`, in f64); the joint score and the spend are accumulated pool
by pool in the reference's unrolled order; violations are exact int32;
both argmins keep the first index on ties.

The digit matrix is built on the device (`joint_digits(..., device)`),
so the program copies nothing from the host and can be captured in a
CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from karpenter_tpu_torch.forecast.models import fma
from karpenter_tpu_torch.ops.cost import (
    CANDIDATES,
    headroom_need,
    ladder,
    risk_of,
)
from karpenter_tpu_torch.ops.decision import to_i32
from karpenter_tpu_torch.utils.operands import BOOL, F32, I32, Operands

# pool-count ceiling per group and the static pool-axis buckets (K^P
# joint candidates: 4 pools x K = 8 is 4,096)
MAX_POOLS = 4
POOL_BUCKETS = (2, 4)

# ratio-constraint slots per group
RATIO_SLOTS = 4

# ratio numerators/denominators are bounded so the int32 cross products
# n * den cannot overflow
RATIO_BOUND = 1024


def pad_pool_count(pools: int) -> int:
    """The static pool-axis bucket for a fleet whose widest group has
    `pools` members."""
    for bucket in POOL_BUCKETS:
        if pools <= bucket:
            return bucket
    raise ValueError(f"pool groups support at most {MAX_POOLS} pools")


def joint_digits(pools: int, device=None) -> torch.Tensor:
    """i64[P, K^P] mixed-radix digits: [p, c] is pool p's ladder index in
    joint candidate c. Built by device ops, no host copy."""
    c = torch.arange(CANDIDATES**pools, dtype=torch.int64, device=device)
    radix = CANDIDATES ** torch.arange(pools, dtype=torch.int64, device=device)
    return (c[None, :] // radix[:, None]) % CANDIDATES


@dataclass
class PoolGroupInputs(Operands):
    """Structure-of-tensors joint view of every pool group: G groups x P
    pools x M metrics (fields as in the reference's PoolGroupInputs;
    min/max arrive already clamped to each pool's movement bounds)."""

    base_desired: torch.Tensor  # i32[G, P]
    min_replicas: torch.Tensor  # i32[G, P]
    max_replicas: torch.Tensor  # i32[G, P]
    unit_cost: torch.Tensor  # f32[G, P]
    slo_weight: torch.Tensor  # f32[G, P]
    max_hourly_cost: torch.Tensor  # f32[G, P] per-pool budget (0 = uncapped)
    tier_penalty: torch.Tensor  # f32[G, P] score-only $/h penalty
    pool_valid: torch.Tensor  # bool[G, P]
    slo_target: torch.Tensor  # f32[G, P, M]
    demand_mu: torch.Tensor  # f32[G, P, M]
    demand_sigma: torch.Tensor  # f32[G, P, M]
    demand_valid: torch.Tensor  # bool[G, P, M]
    ratio_a: torch.Tensor  # i32[G, R] numerator pool index
    ratio_b: torch.Tensor  # i32[G, R] denominator pool index
    ratio_min_num: torch.Tensor  # i32[G, R] a/b >= min_num/min_den
    ratio_min_den: torch.Tensor  # i32[G, R]
    ratio_max_num: torch.Tensor  # i32[G, R] a/b <= max_num/max_den
    ratio_max_den: torch.Tensor  # i32[G, R] (0/0 = no upper bound)
    ratio_valid: torch.Tensor  # bool[G, R]
    group_budget: torch.Tensor  # f32[G] shared budget (0 = uncapped)
    group_valid: torch.Tensor  # bool[G]

    KINDS = {
        "base_desired": I32, "min_replicas": I32, "max_replicas": I32,
        "unit_cost": F32, "slo_weight": F32, "max_hourly_cost": F32,
        "tier_penalty": F32, "pool_valid": BOOL, "slo_target": F32,
        "demand_mu": F32, "demand_sigma": F32, "demand_valid": BOOL,
        "ratio_a": I32, "ratio_b": I32, "ratio_min_num": I32,
        "ratio_min_den": I32, "ratio_max_num": I32, "ratio_max_den": I32,
        "ratio_valid": BOOL, "group_budget": F32, "group_valid": BOOL,
    }


@dataclass
class PoolGroupOutputs(Operands):
    desired: torch.Tensor  # i32[G, P] joint choice (== base when invalid)
    expected_hourly: torch.Tensor  # f32[G, P]
    violation_risk: torch.Tensor  # f32[G, P]
    headroom: torch.Tensor  # i32[G, P]
    cost_limited: torch.Tensor  # bool[G, P]
    slo_raised: torch.Tensor  # bool[G, P]
    ratio_ok: torch.Tensor  # bool[G] the selection violates nothing
    group_hourly: torch.Tensor  # f32[G] summed spend at the selection
    joint_repair: torch.Tensor  # bool[G] moved off the independent point

    KINDS = {
        "desired": I32, "expected_hourly": F32, "violation_risk": F32,
        "headroom": I32, "cost_limited": BOOL, "slo_raised": BOOL,
        "ratio_ok": BOOL, "group_hourly": F32, "joint_repair": BOOL,
    }


def _pool_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[g, idx[g], :] for x [G, P, C] and idx [G]."""
    g, _, c = x.shape
    return x.gather(1, idx.long()[:, None, None].expand(g, 1, c))[:, 0, :]


def _violations(inputs: PoolGroupInputs, n_j, spend) -> torch.Tensor:
    """Exact i32[G, C] constraint-violation count per joint candidate.
    a/b >= lo is a*lo_den >= b*lo_num, so min_num = 0 disables the lower
    bound and max_num = max_den = 0 the upper; invalid slots count 0."""
    g, p, c = n_j.shape
    viol = torch.zeros((g, c), dtype=I32, device=n_j.device)
    for r in range(RATIO_SLOTS):
        n_a = _pool_rows(n_j, inputs.ratio_a[:, r].clamp(0, p - 1))
        n_b = _pool_rows(n_j, inputs.ratio_b[:, r].clamp(0, p - 1))
        low = n_a * inputs.ratio_min_den[:, r, None] < (
            n_b * inputs.ratio_min_num[:, r, None]
        )
        high = n_a * inputs.ratio_max_den[:, r, None] > (
            n_b * inputs.ratio_max_num[:, r, None]
        )
        live = inputs.ratio_valid[:, r, None]
        viol = viol + (live & low).to(I32)
        viol = viol + (live & high).to(I32)
    budget = inputs.group_budget[:, None]
    over = (budget > 0) & (spend > budget)
    return viol + over.to(I32)


def poolgroup_decide(
    inputs: PoolGroupInputs, enforce: bool = True
) -> PoolGroupOutputs:
    """The batched joint program. `enforce=False` is the degraded
    independent rung: the per-pool ladders still refine every pool, but
    the selection stays at the independent point (ratio_ok still reports
    the constraints)."""
    base = inputs.base_desired.to(F32)  # [G, P]
    g, p = base.shape
    c = CANDIDATES**p
    cand, cap_on, hi = ladder(
        base, inputs.min_replicas.to(F32), inputs.max_replicas.to(F32),
        inputs.unit_cost, inputs.max_hourly_cost, inputs.pool_valid,
    )  # [G, P, K]
    demand_hi = inputs.demand_mu + inputs.demand_sigma  # [G, P, M]
    risk = risk_of(cand, demand_hi, inputs.slo_target, inputs.demand_valid)
    # tier preference rides the score's rate only, never the budget
    rate = inputs.unit_cost + inputs.tier_penalty
    hourly = cand * rate[:, :, None]
    score = fma(inputs.slo_weight[:, :, None], risk, hourly)
    k_star = torch.argmin(score, dim=2).to(I32)  # [G, P], first on ties

    # -- joint half: the ladders gathered into the K^P candidate space --
    idx = joint_digits(p, base.device)[None].expand(g, p, c)
    cand_j = cand.gather(2, idx)  # [G, P, C]
    score_j = score.gather(2, idx)
    risk_j = risk.gather(2, idx)
    n_j = cand_j.to(I32)  # integer-valued by construction

    # joint score and spend, pool by pool in the reference's order
    total = score_j[:, 0, :]
    spend = cand_j[:, 0, :] * inputs.unit_cost[:, 0, None]
    for pool in range(1, p):
        total = score_j[:, pool, :] + total
        spend = fma(cand_j[:, pool, :], inputs.unit_cost[:, pool, None], spend)
    viol = _violations(inputs, n_j, spend)  # [G, C]

    # -- two-level selection --------------------------------------------
    indep_c = k_star[:, 0]
    for pool in range(1, p):
        indep_c = indep_c + k_star[:, pool] * CANDIDATES**pool
    indep_viol = viol.gather(1, indep_c.long()[:, None])[:, 0]
    min_viol = viol.amin(dim=1, keepdim=True)
    masked_total = torch.where(viol == min_viol, total, float("inf"))
    repair_c = torch.argmin(masked_total, dim=1).to(I32)
    if enforce:
        selected = torch.where(indep_viol == 0, indep_c, repair_c)
    else:
        selected = indep_c

    sel = selected.long()
    sel_pools = sel[:, None, None].expand(g, p, 1)
    chosen = cand_j.gather(2, sel_pools)[:, :, 0]  # [G, P]
    chosen_risk = risk_j.gather(2, sel_pools)[:, :, 0]
    sel_viol = viol.gather(1, sel[:, None])[:, 0]
    sel_spend = spend.gather(1, sel[:, None])[:, 0]

    need = headroom_need(demand_hi, inputs.slo_target, inputs.demand_valid)
    headroom = torch.clamp_min(need - chosen, 0.0)

    valid = inputs.pool_valid
    desired = torch.where(valid, chosen, base)
    group_valid = inputs.group_valid
    return PoolGroupOutputs(
        desired=to_i32(desired),
        expected_hourly=desired * inputs.unit_cost,
        violation_risk=torch.where(valid, chosen_risk, 0.0),
        headroom=to_i32(torch.where(valid, headroom, 0.0)),
        cost_limited=cap_on & (base > hi),
        slo_raised=valid & (chosen > base),
        ratio_ok=group_valid & (sel_viol == 0),
        group_hourly=torch.where(group_valid, sel_spend, 0.0),
        joint_repair=group_valid & (selected != indep_c),
    )
