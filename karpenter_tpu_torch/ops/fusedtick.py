"""The fused steady-state tick: forecast -> decide -> cost -> pool groups
as one tensor program (counterpart of karpenter_tpu/ops/fusedtick.py).

    forecast (Holt-Winters / robust linear over the masked histories)
        |  point / sigma2 / n_valid per series, kept on the device
        v  scatter into the fleet's [N, M] metric grid
    decide (max(reactive, predicted) blend, windows, rate limits)
        |  desired + movement bounds (up_ceiling / down_floor)
        v
    cost ladder (8 candidates, budget cap, SLO risk)
        v
    pool groups (joint K^P ladder over each group's member rows)

Absent stages are absent operands: `forecast=None`, `slo_valid=None` and
`poolgroup=None` each drop their stage from the program.

The forecast -> decide scatter. Series that pass their gate (n_valid >=
need, and for the blend also the skill verdict) write their point into
their (row, col) cell; pad series carry row N, a trash row sliced off.
Where two gated series share a cell, the one with the largest series
index wins; a cell that no gated series reaches stays (0, False). This
is the numpy mirror's result (`fused_tick_numpy`'s `_np_scatter`) on
every input, and the reference's jitted program's wherever cells are
distinct, as production's series map makes them. The rule is computed
deterministically: an amax scatter of the gated series' indices into an
[N+1, M] grid, then a gather (a duplicate-index `index_put_` has no
defined winner on CUDA).

`FusedTickProgram` runs `fused_tick` as one captured CUDA graph per
operand shape class: the counterpart of `fused_tick_jit`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from karpenter_tpu_torch.forecast import models as M
from karpenter_tpu_torch.ops import cost as C
from karpenter_tpu_torch.ops import decision as D
from karpenter_tpu_torch.ops import poolgroup as PG
from karpenter_tpu_torch.utils.device import DeviceLike, resolve_device
from karpenter_tpu_torch.utils.operands import BOOL, F32, I32, Operands

_I32_MAX = int(np.iinfo(np.int32).max)


@dataclass
class PoolGroupOperands(Operands):
    """The tick's optional pool-group stage: G groups x P pools, each pool
    a fleet row. The base counts and movement bounds come from the decide
    and cost stages in the device; pg_min/pg_max are the spec bounds."""

    member_row: torch.Tensor  # i32[G, P] fleet row per pool (pad slots: 0)
    pg_min: torch.Tensor  # i32[G, P]
    pg_max: torch.Tensor  # i32[G, P]
    unit_cost: torch.Tensor  # f32[G, P]
    slo_weight: torch.Tensor  # f32[G, P]
    max_hourly_cost: torch.Tensor  # f32[G, P]
    tier_penalty: torch.Tensor  # f32[G, P]
    pool_valid: torch.Tensor  # bool[G, P]
    slo_target: torch.Tensor  # f32[G, P, M]
    observed: torch.Tensor  # f32[G, P, M]
    demand_base_valid: torch.Tensor  # bool[G, P, M]
    prior_point: torch.Tensor  # f32[G, P, M]
    prior_sigma2: torch.Tensor  # f32[G, P, M]
    prior_valid: torch.Tensor  # bool[G, P, M]
    ratio_a: torch.Tensor  # i32[G, R]
    ratio_b: torch.Tensor  # i32[G, R]
    ratio_min_num: torch.Tensor  # i32[G, R]
    ratio_min_den: torch.Tensor  # i32[G, R]
    ratio_max_num: torch.Tensor  # i32[G, R]
    ratio_max_den: torch.Tensor  # i32[G, R]
    ratio_valid: torch.Tensor  # bool[G, R]
    group_budget: torch.Tensor  # f32[G]
    group_valid: torch.Tensor  # bool[G]

    KINDS = {
        "member_row": I32, "pg_min": I32, "pg_max": I32, "unit_cost": F32,
        "slo_weight": F32, "max_hourly_cost": F32, "tier_penalty": F32,
        "pool_valid": BOOL, "slo_target": F32, "observed": F32,
        "demand_base_valid": BOOL, "prior_point": F32, "prior_sigma2": F32,
        "prior_valid": BOOL, "ratio_a": I32, "ratio_b": I32,
        "ratio_min_num": I32, "ratio_min_den": I32, "ratio_max_num": I32,
        "ratio_max_den": I32, "ratio_valid": BOOL, "group_budget": F32,
        "group_valid": BOOL,
    }


@dataclass
class FusedTickInputs(Operands):
    """Operands of the whole chain. `decision` is the fleet's decide()
    view with the forecast operands None (the tick fills them); each
    optional group may be None, and its stage is then absent."""

    decision: D.DecisionInputs
    # -- forecast stage (None = absent) --
    forecast: Optional[M.ForecastInputs] = None
    series_row: Optional[torch.Tensor] = None  # i32[S] fleet row (N = trash)
    series_col: Optional[torch.Tensor] = None  # i32[S] metric column
    series_need: Optional[torch.Tensor] = None  # i32[S] min samples
    series_blend: Optional[torch.Tensor] = None  # bool[S] skill gate verdict
    # -- cost stage (None = absent; slo_valid is the presence sentinel) --
    ha_min: Optional[torch.Tensor] = None  # i32[N] spec minReplicas
    ha_max: Optional[torch.Tensor] = None  # i32[N] spec maxReplicas
    unit_cost: Optional[torch.Tensor] = None  # f32[N]
    slo_weight: Optional[torch.Tensor] = None  # f32[N]
    max_hourly_cost: Optional[torch.Tensor] = None  # f32[N]
    slo_valid: Optional[torch.Tensor] = None  # bool[N]
    slo_target: Optional[torch.Tensor] = None  # f32[N, M]
    observed: Optional[torch.Tensor] = None  # f32[N, M] reactive demand
    demand_base_valid: Optional[torch.Tensor] = None  # bool[N, M]
    prior_point: Optional[torch.Tensor] = None  # f32[N, M] host dist read
    prior_sigma2: Optional[torch.Tensor] = None  # f32[N, M]
    prior_valid: Optional[torch.Tensor] = None  # bool[N, M]
    # -- joint pool-group stage (None = absent) --
    poolgroup: Optional[PoolGroupOperands] = None

    KINDS = {
        "decision": D.DecisionInputs, "forecast": M.ForecastInputs,
        "series_row": I32, "series_col": I32, "series_need": I32,
        "series_blend": BOOL, "ha_min": I32, "ha_max": I32,
        "unit_cost": F32, "slo_weight": F32, "max_hourly_cost": F32,
        "slo_valid": BOOL, "slo_target": F32, "observed": F32,
        "demand_base_valid": BOOL, "prior_point": F32, "prior_sigma2": F32,
        "prior_valid": BOOL, "poolgroup": PoolGroupOperands,
    }


@dataclass
class FusedTickOutputs(Operands):
    decision: D.DecisionOutputs
    forecast: Optional[M.ForecastOutputs] = None
    cost: Optional[C.CostOutputs] = None
    poolgroup: Optional[PG.PoolGroupOutputs] = None

    KINDS = {
        "decision": D.DecisionOutputs, "forecast": M.ForecastOutputs,
        "cost": C.CostOutputs, "poolgroup": PG.PoolGroupOutputs,
    }


def programs(inputs: FusedTickInputs) -> int:
    """Device programs the chained path needs for these operands (the
    fused path always needs one)."""
    return (
        1
        + int(inputs.forecast is not None)
        + int(inputs.slo_valid is not None)
        + int(inputs.poolgroup is not None)
    )


def _winners(n: int, m: int, rows, cols, gate) -> torch.Tensor:
    """i64[N, M]: per cell, the largest index of a gated series that lands
    there, -1 where none does (module docstring: the scatter rule). Pad
    series (row N) land in the trash row, which is sliced off."""
    s = rows.shape[0]
    order = torch.arange(s, dtype=I32, device=rows.device)
    cell = rows.long() * m + cols.long()
    win = torch.full(((n + 1) * m,), -1, dtype=I32, device=rows.device)
    win.scatter_reduce_(0, cell, torch.where(gate, order, -1), reduce="amax")
    return win.view(n + 1, m)[:n].long()


def _pick(values: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """values[win] where win >= 0, else 0 (same shape as win)."""
    got = values.gather(0, win.clamp_min(0).view(-1)).view(win.shape)
    return torch.where(win >= 0, got, 0.0)


def _demand(observed, prior_point, prior_sigma2, have, valid):
    """The engine's demand selection: mu = max(observed, prior) where a
    finite prior is known, sigma = sqrt(prior_sigma2) where positive and
    finite; both 0 off `valid`."""
    mu = torch.where(
        have & torch.isfinite(prior_point),
        torch.maximum(observed, prior_point),
        observed,
    )
    sigma = torch.where(
        have & torch.isfinite(prior_sigma2) & (prior_sigma2 > 0),
        torch.sqrt(prior_sigma2),
        0.0,
    )
    return torch.where(valid, mu, 0.0), torch.where(valid, sigma, 0.0)


def _demand_overlay(inputs: FusedTickInputs, dout, dist) -> C.CostInputs:
    """The decide -> cost seam: movement-bound clamps, and the fresh
    in-device distribution overlaid on the host-read prior."""
    prior_point = inputs.prior_point
    prior_sigma2 = inputs.prior_sigma2
    have = inputs.prior_valid
    if dist is not None:
        dist_point, dist_sigma2, dist_ok = dist
        prior_point = torch.where(dist_ok, dist_point, prior_point)
        prior_sigma2 = torch.where(dist_ok, dist_sigma2, prior_sigma2)
        have = dist_ok | have
    mu, sigma = _demand(
        inputs.observed, prior_point, prior_sigma2, have,
        inputs.demand_base_valid,
    )
    slo = inputs.slo_valid
    min_eff = torch.where(
        slo,
        torch.maximum(inputs.ha_min, torch.minimum(dout.down_floor, inputs.ha_max)),
        0,
    )
    max_eff = torch.where(
        slo,
        torch.minimum(inputs.ha_max, torch.maximum(dout.up_ceiling, inputs.ha_min)),
        0,
    )
    return C.CostInputs(
        base_desired=dout.desired,
        min_replicas=min_eff,
        max_replicas=max_eff,
        unit_cost=inputs.unit_cost,
        slo_weight=inputs.slo_weight,
        max_hourly_cost=inputs.max_hourly_cost,
        slo_valid=slo,
        slo_target=inputs.slo_target,
        demand_mu=mu,
        demand_sigma=sigma,
        demand_valid=inputs.demand_base_valid,
    )


def _pg_overlay(pg: PoolGroupOperands, final_desired, dout, dist):
    """The cost -> pool-group seam: each pool's base from the tick's final
    desired, movement-clamped bounds from decide's up_ceiling/down_floor
    (spec bounds outrank the rate bound), and the cost seam's demand
    overlay gathered at each pool's fleet row."""
    n = final_desired.shape[0]
    g, p = pg.member_row.shape
    rows = pg.member_row.clamp(0, n - 1).long().view(-1)

    def at_rows(x):  # x[member_row] for a fleet vector or [N, M] grid
        return x.index_select(0, rows).view((g, p) + x.shape[1:])

    valid = pg.pool_valid
    base = torch.where(valid, at_rows(final_desired), 0)
    down = at_rows(dout.down_floor)
    up = at_rows(dout.up_ceiling)
    min_eff = torch.where(
        valid, torch.maximum(pg.pg_min, torch.minimum(down, pg.pg_max)), 0
    )
    max_eff = torch.where(
        valid, torch.minimum(pg.pg_max, torch.maximum(up, pg.pg_min)), 0
    )
    prior_point = pg.prior_point
    prior_sigma2 = pg.prior_sigma2
    have = pg.prior_valid
    if dist is not None:
        dist_point, dist_sigma2, dist_ok = dist  # [N, M] grids
        g_ok = at_rows(dist_ok)
        prior_point = torch.where(g_ok, at_rows(dist_point), prior_point)
        prior_sigma2 = torch.where(g_ok, at_rows(dist_sigma2), prior_sigma2)
        have = g_ok | have
    mu, sigma = _demand(
        pg.observed, prior_point, prior_sigma2, have, pg.demand_base_valid
    )
    return PG.PoolGroupInputs(
        base_desired=base,
        min_replicas=min_eff,
        max_replicas=max_eff,
        unit_cost=pg.unit_cost,
        slo_weight=pg.slo_weight,
        max_hourly_cost=pg.max_hourly_cost,
        tier_penalty=pg.tier_penalty,
        pool_valid=valid,
        slo_target=pg.slo_target,
        demand_mu=mu,
        demand_sigma=sigma,
        demand_valid=pg.demand_base_valid,
        ratio_a=pg.ratio_a,
        ratio_b=pg.ratio_b,
        ratio_min_num=pg.ratio_min_num,
        ratio_min_den=pg.ratio_min_den,
        ratio_max_num=pg.ratio_max_num,
        ratio_max_den=pg.ratio_max_den,
        ratio_valid=pg.ratio_valid,
        group_budget=pg.group_budget,
        group_valid=pg.group_valid,
    )


def fused_tick(inputs: FusedTickInputs) -> FusedTickOutputs:
    """forecast -> decide -> cost -> pool groups with every seam on the
    device, and no host synchronisation: no .item(), no boolean-mask
    indexing, no branch on a tensor's value."""
    dec = inputs.decision
    n, m = dec.metric_value.shape
    fout = None
    dist = None
    if inputs.forecast is not None:
        fout = M.forecast(inputs.forecast)
        rows, cols = inputs.series_row, inputs.series_col
        dist_gate = fout.n_valid >= inputs.series_need
        blend_win = _winners(n, m, rows, cols, inputs.series_blend & dist_gate)
        dist_win = _winners(n, m, rows, cols, dist_gate)
        dist = (
            _pick(fout.point, dist_win),
            _pick(fout.sigma2, dist_win),
            dist_win >= 0,
        )
        dec = replace(
            dec,
            forecast_value=_pick(fout.point, blend_win),
            forecast_valid=blend_win >= 0,
        )
    dout = D.decide(dec)
    cout = None
    if inputs.slo_valid is not None:
        cout = C.cost_decide(_demand_overlay(inputs, dout, dist))
    pout = None
    if inputs.poolgroup is not None:
        final = cout.desired if cout is not None else dout.desired
        pout = PG.poolgroup_decide(
            _pg_overlay(inputs.poolgroup, final, dout, dist)
        )
    return FusedTickOutputs(
        decision=dout, forecast=fout, cost=cout, poolgroup=pout
    )


# -- one program per shape class: a captured CUDA graph --------------------


def _leaves(obj, prefix=""):
    """(path, tensor) of every tensor in a tree of Operands, None skipped."""
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if isinstance(value, Operands):
            yield from _leaves(value, f"{prefix}{f.name}.")
        elif value is not None:
            yield f"{prefix}{f.name}", value


def shape_class(inputs: FusedTickInputs) -> tuple:
    """The key of one captured program: every present leaf's path, shape
    and dtype (stage presence included)."""
    return tuple(
        (path, tuple(t.shape), t.dtype) for path, t in _leaves(inputs)
    )


def _clone_tree(obj):
    return dataclasses.replace(
        obj,
        **{
            f.name: None if getattr(obj, f.name) is None
            else _clone_tree(getattr(obj, f.name))
            if isinstance(getattr(obj, f.name), Operands)
            else getattr(obj, f.name).clone()
            for f in dataclasses.fields(obj)
        },
    )


class FusedTickProgram:
    """`fused_tick` as one captured CUDA graph per operand shape class
    (the counterpart of `fused_tick_jit`, which compiles one XLA program
    per shape class).

    A call on the card copies the operands into the shape class's static
    input buffers, replays the graph (one launch sequence, no host round
    trip) and returns clones of the static outputs. The first call of a
    shape class captures it: two eager warm-up ticks on a side stream,
    then the capture. A failed capture raises; it never falls back to
    eager. On the CPU a call is `fused_tick` itself."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._graphs = {}  # shape class -> (static inputs, outputs, graph)
        self.captures = 0
        self.replays = 0

    def __call__(self, inputs: FusedTickInputs) -> FusedTickOutputs:
        inputs = inputs.to(self.device)
        if self.device.type != "cuda":
            return fused_tick(inputs)
        key = shape_class(inputs)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(inputs)
            self._graphs[key] = entry
        static_in, static_out, graph = entry
        for (_, dst), (_, src) in zip(_leaves(static_in), _leaves(inputs)):
            dst.copy_(src)
        graph.replay()
        self.replays += 1
        return _clone_tree(static_out)

    def _capture(self, inputs: FusedTickInputs):
        static_in = _clone_tree(inputs)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                fused_tick(static_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = fused_tick(static_in)
        self.captures += 1
        return static_in, static_out, graph


# -- padding ------------------------------------------------------------------


def pad_series(inputs: FusedTickInputs, s_pad: int) -> FusedTickInputs:
    """Pad the forecast group to `s_pad` series. Pad series carry an
    impossible sample requirement, a False blend gate and the trash row
    N: they cannot touch a live cell."""
    if inputs.forecast is None:
        return inputs
    s = inputs.forecast.values.shape[0]
    if s == s_pad:
        return inputs
    pad = s_pad - s
    if pad < 0:
        raise ValueError(f"cannot shrink {s} series to {s_pad}")
    n = inputs.decision.spec_replicas.shape[0]

    def extend(t, fill):
        return torch.cat([t, t.new_full((pad,), fill)])

    return replace(
        inputs,
        forecast=M.concat_forecast_inputs([inputs.forecast], s_pad),
        series_row=extend(inputs.series_row, n),
        series_col=extend(inputs.series_col, 0),
        series_need=extend(inputs.series_need, _I32_MAX),
        series_blend=extend(inputs.series_blend, False),
    )
