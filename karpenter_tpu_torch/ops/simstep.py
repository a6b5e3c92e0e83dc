"""SimLab cluster stepping: one tick / one rollout as tensor programs
(counterpart of karpenter_tpu/ops/simstep.py).

The simulator plane (karpenter_tpu_torch/simlab) advances a simulated
cluster's columnar state — per-row replica counts under a seeded
demand/price/fault trail — with the same batch-everything discipline as
the decision programs: a fleet of simulated clusters stacked on a
leading batch axis advances as one set of batched tensor ops per tick
(`sim_rollout` over [B, T, R] trails; no per-cluster Python loop), and
`sim_*_numpy` are the reference's host mirrors, copied unchanged.

Two entry points:

  sim_step     one tick, ACTION GIVEN (the gym `SimEnv.step` seam): the
               caller's policy already chose per-row replica targets;
               the program applies the actuation rate limit and the
               fault gate, then scores the tick.
  sim_rollout  a whole T-tick episode with the in-program tuned policy
               (parameterized by a per-cluster knob vector), so policy
               search evaluates a full candidate population in one
               program (simlab/policy.py SearchTunedPolicy).

Tick semantics (all f32, elementwise over the row axis R):

  target   = clip(action, min, max)
  delta    = clip(target - replicas, ±step_limit) * (1 - fault)
  replicas'= clip(replicas + delta, min, max)         # fault holds state
  violation= demand > replicas' * cap                 # SLO-violation tick
  cost     = replicas' * hourly * price               # priced replica-ticks
  backlog  = |target - replicas'|                     # reconcile lead debt

The in-program policy (sim_rollout) is the 3-knob decision surface the
search plane tunes — forecast blend floor, cost shed weight,
scale-down stabilization window:

  blend  = max(demand_prev, blend_floor * forecast_prev)
  raw    = ceil(blend / cap)
  shed   = floor(raw * cost_weight * max(price_prev - 1, 0))
  tgt    = clip(raw - shed, min, max)
  target = tgt held at current replicas while a scale-down streak is
           younger than stab_window ticks

knobs = (0, 0, 0) IS the reactive baseline.

Parity contract: bitwise with the numpy mirror on every output field,
on the CPU and on the card. Every operation is one IEEE f32 elementwise
tensor op, in `_step_math`'s and `_policy_math`'s operand order, each
its own kernel, so no multiply and add contract into an FMA (no
torch.compile, no fused kernel). The five scalars ride as 0-d tensors on
the program's device: a CUDA division by a host scalar is computed as a
multiply by its reciprocal, which is not the IEEE quotient. No reduction
happens in the program: per-tick per-row components come back whole and
the composite reward is summed on the host in float64
(simlab/env.composite_reward).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from karpenter_tpu_torch.utils.operands import F32, Operands, on_device

_ONE = np.float32(1.0)
_ZERO = np.float32(0.0)

# knob vector layout (simlab/policy.py builds/search-tunes these)
KNOB_BLEND_FLOOR = 0
KNOB_COST_WEIGHT = 1
KNOB_STAB_WINDOW = 2
KNOBS = 3

_SCALARS = ("cap", "hourly", "step_limit", "min_replicas", "max_replicas")


@dataclass
class SimStepInputs(Operands):
    """One tick's operands. Row tensors are f32[..., R]; `price` and
    `fault` are per-cluster f32[...] (the program broadcasts them over
    rows); the five scalars are f32[] shared across the batch."""

    replicas: torch.Tensor  # f32[..., R] current replicas per HA row
    target: torch.Tensor  # f32[..., R] the action: requested replicas
    demand: torch.Tensor  # f32[..., R] this tick's observed demand
    price: torch.Tensor  # f32[...] price multiplier (spot spike > 1)
    fault: torch.Tensor  # f32[...] 1.0 = actuation blocked this tick
    cap: torch.Tensor  # f32[] demand served per replica
    hourly: torch.Tensor  # f32[] on-demand price per replica-tick
    step_limit: torch.Tensor  # f32[] max replica movement per tick
    min_replicas: torch.Tensor  # f32[]
    max_replicas: torch.Tensor  # f32[]

    KINDS = {
        name: F32 for name in (
            "replicas", "target", "demand", "price", "fault",
        ) + _SCALARS
    }


@dataclass
class SimStepOutputs(Operands):
    replicas: torch.Tensor  # f32[..., R] post-actuation replicas
    violation: torch.Tensor  # f32[..., R] 1.0 where demand outran capacity
    cost: torch.Tensor  # f32[..., R] priced replica-ticks
    backlog: torch.Tensor  # f32[..., R] |target - replicas'| lead debt

    KINDS = {
        name: F32 for name in ("replicas", "violation", "cost", "backlog")
    }


@dataclass
class SimRolloutInputs(Operands):
    """A whole episode's operands: time-major trails f32[..., T, R]
    (f32[..., T] for the per-cluster price/fault schedules), the initial
    cluster state, and the per-cluster policy knob vector f32[..., 3]."""

    replicas0: torch.Tensor  # f32[..., R]
    streak0: torch.Tensor  # f32[..., R] scale-down streak ages
    demand: torch.Tensor  # f32[..., T, R]
    forecast: torch.Tensor  # f32[..., T, R] preview of the NEXT demand
    price: torch.Tensor  # f32[..., T]
    fault: torch.Tensor  # f32[..., T]
    knobs: torch.Tensor  # f32[..., KNOBS]
    cap: torch.Tensor  # f32[]
    hourly: torch.Tensor  # f32[]
    step_limit: torch.Tensor  # f32[]
    min_replicas: torch.Tensor  # f32[]
    max_replicas: torch.Tensor  # f32[]

    KINDS = {
        name: F32 for name in (
            "replicas0", "streak0", "demand", "forecast", "price", "fault",
            "knobs",
        ) + _SCALARS
    }


@dataclass
class SimRolloutOutputs(Operands):
    """Whole per-tick component trails (no in-program reductions — the
    module docstring's parity contract) plus the final carry state."""

    replicas: torch.Tensor  # f32[..., R] final replicas
    streak: torch.Tensor  # f32[..., R] final scale-down streaks
    violation: torch.Tensor  # f32[..., T, R]
    cost: torch.Tensor  # f32[..., T, R]
    backlog: torch.Tensor  # f32[..., T, R]
    target: torch.Tensor  # f32[..., T, R] the actions the policy took

    KINDS = {
        name: F32 for name in (
            "replicas", "streak", "violation", "cost", "backlog", "target",
        )
    }


# -- the numpy mirror (the reference's, unchanged) ---------------------------


def _step_math(m, replicas, target, demand, price, fault, inputs):
    """The shared tick program (module docstring), generic over the
    array module `m` (the numpy mirror; `_step_torch` is the tensor
    program with the same operand order)."""
    tgt = m.clip(target, inputs.min_replicas, inputs.max_replicas)
    can_act = _ONE - fault  # exactly 0.0 or 1.0: FMA-safe multiplicand
    delta = (
        m.clip(tgt - replicas, -inputs.step_limit, inputs.step_limit)
        * can_act[..., None]
    )
    new = m.clip(
        replicas + delta, inputs.min_replicas, inputs.max_replicas
    )
    served = new * inputs.cap
    violation = (demand > served).astype(np.float32)
    cost = new * inputs.hourly * price[..., None]
    backlog = m.abs(tgt - new)
    return new, violation, cost, backlog


def _policy_math(
    m, knobs, demand_prev, forecast_prev, price_prev, replicas, streak,
    inputs,
):
    """The 3-knob tuned policy (module docstring), generic over the
    array module. knobs[..., 0]=blend floor, [..., 1]=cost shed weight,
    [..., 2]=stabilization window in ticks."""
    blend_floor = knobs[..., 0:1]
    cost_weight = knobs[..., 1:2]
    stab_window = knobs[..., 2:3]
    blend = m.maximum(demand_prev, blend_floor * forecast_prev)
    raw = m.ceil(blend / inputs.cap)
    spike = m.maximum(price_prev - _ONE, _ZERO)
    shed = m.floor(raw * cost_weight * spike[..., None])
    tgt = m.clip(
        raw - shed, inputs.min_replicas, inputs.max_replicas
    )
    down = tgt < replicas
    streak2 = m.where(down, streak + _ONE, _ZERO)
    hold = down & (streak2 <= stab_window)
    target = m.where(hold, replicas, tgt)
    return target, streak2


def sim_step_numpy(inputs) -> SimStepOutputs:
    """Bit-identical host mirror of sim_step."""
    new, violation, cost, backlog = _step_math(
        np, np.asarray(inputs.replicas), np.asarray(inputs.target),
        np.asarray(inputs.demand), np.asarray(inputs.price),
        np.asarray(inputs.fault), inputs,
    )
    return SimStepOutputs(
        replicas=new, violation=violation, cost=cost, backlog=backlog
    )


def _rollout_numpy_one(inputs) -> SimRolloutOutputs:
    ticks, rows = inputs.demand.shape
    replicas = np.asarray(inputs.replicas0, np.float32).copy()
    streak = np.asarray(inputs.streak0, np.float32).copy()
    d_prev = np.zeros(rows, np.float32)
    f_prev = np.zeros(rows, np.float32)
    # 0-d arrays, not numpy scalars: the programs broadcast per-cluster
    # price/fault over rows with `[..., None]`, which scalars reject
    p_prev = np.asarray(_ONE)
    violation = np.zeros((ticks, rows), np.float32)
    cost = np.zeros((ticks, rows), np.float32)
    backlog = np.zeros((ticks, rows), np.float32)
    target = np.zeros((ticks, rows), np.float32)
    for t in range(ticks):
        tgt, streak = _policy_math(
            np, inputs.knobs, d_prev, f_prev, p_prev, replicas, streak,
            inputs,
        )
        replicas, violation[t], cost[t], backlog[t] = _step_math(
            np, replicas, tgt, inputs.demand[t],
            np.asarray(inputs.price[t]), np.asarray(inputs.fault[t]),
            inputs,
        )
        target[t] = tgt
        d_prev, f_prev, p_prev = (
            inputs.demand[t], inputs.forecast[t],
            np.asarray(inputs.price[t]),
        )
    return SimRolloutOutputs(
        replicas=replicas, streak=streak, violation=violation,
        cost=cost, backlog=backlog, target=target,
    )


def sim_rollout_numpy(inputs) -> SimRolloutOutputs:
    """Bit-identical host mirror of sim_rollout: unbatched trails run
    one episode loop; batched trails loop the clusters (the sequential
    reference the parity tests compare)."""
    if np.asarray(inputs.replicas0).ndim == 1:
        return _rollout_numpy_one(inputs)
    outs = [
        _rollout_numpy_one(_cluster_slice(inputs, b))
        for b in range(np.asarray(inputs.replicas0).shape[0])
    ]
    return SimRolloutOutputs(
        replicas=np.stack([o.replicas for o in outs]),
        streak=np.stack([o.streak for o in outs]),
        violation=np.stack([o.violation for o in outs]),
        cost=np.stack([o.cost for o in outs]),
        backlog=np.stack([o.backlog for o in outs]),
        target=np.stack([o.target for o in outs]),
    )


def _cluster_slice(inputs, b: int) -> SimRolloutInputs:
    """Cluster b's unbatched view of a batched SimRolloutInputs."""
    return SimRolloutInputs(
        replicas0=np.asarray(inputs.replicas0)[b],
        streak0=np.asarray(inputs.streak0)[b],
        demand=np.asarray(inputs.demand)[b],
        forecast=np.asarray(inputs.forecast)[b],
        price=np.asarray(inputs.price)[b],
        fault=np.asarray(inputs.fault)[b],
        knobs=np.asarray(inputs.knobs)[b],
        cap=inputs.cap,
        hourly=inputs.hourly,
        step_limit=inputs.step_limit,
        min_replicas=inputs.min_replicas,
        max_replicas=inputs.max_replicas,
    )


# -- the tensor programs ------------------------------------------------------


def _step_torch(replicas, target, demand, price, fault, inputs):
    """`_step_math` on tensors: the same ops in the same order."""
    lo, hi = inputs.min_replicas, inputs.max_replicas
    tgt = torch.clamp(target, lo, hi)
    can_act = 1.0 - fault  # exactly 0.0 or 1.0: FMA-safe multiplicand
    delta = (
        torch.clamp(tgt - replicas, -inputs.step_limit, inputs.step_limit)
        * can_act[..., None]
    )
    new = torch.clamp(replicas + delta, lo, hi)
    served = new * inputs.cap
    violation = (demand > served).to(torch.float32)
    cost = new * inputs.hourly * price[..., None]
    backlog = torch.abs(tgt - new)
    return new, violation, cost, backlog


def _policy_torch(knobs, demand_prev, forecast_prev, price_prev, replicas,
                  streak, inputs):
    """`_policy_math` on tensors: the same ops in the same order."""
    blend_floor = knobs[..., 0:1]
    cost_weight = knobs[..., 1:2]
    stab_window = knobs[..., 2:3]
    blend = torch.maximum(demand_prev, blend_floor * forecast_prev)
    raw = torch.ceil(blend / inputs.cap)
    spike = torch.clamp_min(price_prev - 1.0, 0.0)
    shed = torch.floor(raw * cost_weight * spike[..., None])
    tgt = torch.clamp(raw - shed, inputs.min_replicas, inputs.max_replicas)
    down = tgt < replicas
    streak2 = torch.where(down, streak + 1.0, torch.zeros_like(streak))
    hold = down & (streak2 <= stab_window)
    target = torch.where(hold, replicas, tgt)
    return target, streak2


def sim_step(inputs: SimStepInputs) -> SimStepOutputs:
    """One tick on the inputs' device (elementwise: any leading batch
    shape rides the same program; host operands: see
    utils/operands.on_device)."""
    inputs = on_device(inputs)
    new, violation, cost, backlog = _step_torch(
        inputs.replicas, inputs.target, inputs.demand, inputs.price,
        inputs.fault, inputs,
    )
    return SimStepOutputs(
        replicas=new, violation=violation, cost=cost, backlog=backlog
    )


def sim_rollout(inputs: SimRolloutInputs) -> SimRolloutOutputs:
    """A whole episode on the inputs' device: trails [..., T, R] with any
    leading batch shape ([T, R] is one cluster, [B, T, R] a fleet). Each
    tick is one set of batched ops over [..., R]; the per-tick component
    rows are stacked on the time axis at the end. Host operands are
    placed as utils/operands.on_device says."""
    inputs = on_device(inputs)
    replicas = inputs.replicas0
    streak = inputs.streak0
    d_prev = torch.zeros_like(replicas)
    f_prev = torch.zeros_like(replicas)
    p_prev = torch.ones(
        inputs.price.shape[:-1], dtype=torch.float32,
        device=inputs.price.device,
    )
    violation, cost, backlog, target = [], [], [], []
    for t in range(int(inputs.demand.shape[-2])):
        demand_t = inputs.demand[..., t, :]
        price_t = inputs.price[..., t]
        tgt, streak = _policy_torch(
            inputs.knobs, d_prev, f_prev, p_prev, replicas, streak, inputs
        )
        replicas, v, c, b = _step_torch(
            replicas, tgt, demand_t, price_t, inputs.fault[..., t], inputs
        )
        violation.append(v)
        cost.append(c)
        backlog.append(b)
        target.append(tgt)
        d_prev, f_prev, p_prev = (
            demand_t, inputs.forecast[..., t, :], price_t,
        )
    return SimRolloutOutputs(
        replicas=replicas, streak=streak,
        violation=torch.stack(violation, dim=-2),
        cost=torch.stack(cost, dim=-2),
        backlog=torch.stack(backlog, dim=-2),
        target=torch.stack(target, dim=-2),
    )


def sim_rollout_vmapped(inputs: SimRolloutInputs) -> SimRolloutOutputs:
    """The batched program: B clusters' trails and knobs stacked on a
    leading axis ([B, T, R]), the five scalars shared. It is sim_rollout
    itself — every op already broadcasts over the batch axis."""
    inputs = on_device(inputs)
    if inputs.replicas0.dim() != 2:
        raise ValueError(
            "sim_rollout_vmapped takes batched trails (replicas0 f32[B, R]), "
            f"got replicas0 of shape {tuple(inputs.replicas0.shape)}"
        )
    return sim_rollout(inputs)
