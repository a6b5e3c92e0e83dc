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
deterministically: the largest gated index of a cell, by an amax scatter
of the gated series' indices into an [N+1, M] grid and a gather in the
plain version (a duplicate-index `index_put_` has no defined winner on
CUDA), by atomicMax in the kernel.

The row stages (the scatter, decide, the cost seam and the cost ladder)
are `tick_rows`: for CUDA tensors one memset and two hand-written kernels
(csrc/tick_rows.cu: one thread a series for the scatter, one thread a
fleet row for the rest), counted in LAUNCHES, raising on any failure; for
CPU tensors, and only for them, the plain version `tick_rows_reference`
(the stages' PyTorch programs, which the kernels are held against on the
card). The kernels follow the stages' operands: an absent forecast or
cost group is an absent part of the kernel. `decide()` and
`cost_decide()` called alone stay PyTorch programs.

`FusedTickProgram` runs `fused_tick` as one captured CUDA graph per
operand shape class: the counterpart of `fused_tick_jit`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.forecast import models as M
from karpenter_tpu_torch.observability.tracing import default_tracer
from karpenter_tpu_torch.ops import cost as C
from karpenter_tpu_torch.ops import decision as D
from karpenter_tpu_torch.ops import poolgroup as PG
from karpenter_tpu_torch.utils.device import DeviceLike, resolve_device
from karpenter_tpu_torch.utils.operands import (
    BOOL,
    F32,
    I32,
    Operands,
    fetch,
    host_seam,
    on_device,
)

_I32_MAX = int(np.iinfo(np.int32).max)

# kernel launches of `tick_rows` (none for CPU tensors): "tick_scatter" one
# a call with series, "tick_rows" one a call with rows. Inside a CUDA graph
# they count the eager warm-ups and the capture, not the replays.
LAUNCHES = {"tick_scatter": 0, "tick_rows": 0}


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


def tick_rows_reference(inputs: FusedTickInputs, fout):
    """The plain version of `tick_rows`: the scatter, decide, the cost
    seam and cost_decide as the stages' PyTorch programs. (decide's
    outputs, cost's outputs or None, the dist grids (point, sigma2, ok)
    or None)."""
    dec = inputs.decision
    n, m = dec.metric_value.shape
    dist = None
    if fout is not None:
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
    return dout, cout, dist


_COST_FIELDS = (
    "ha_min", "ha_max", "unit_cost", "slo_weight", "max_hourly_cost",
    "slo_valid", "slo_target", "observed", "demand_base_valid",
    "prior_point", "prior_sigma2", "prior_valid",
)
_SERIES_FIELDS = ("series_row", "series_col", "series_need", "series_blend")
_COST_OUTPUTS = tuple(
    "cost_desired" if name == "desired" else name for name in C.CostOutputs.KINDS
)
_DIST = (("dist_point", F32), ("dist_sigma2", F32), ("dist_ok", BOOL))
# csrc/tick_rows.cu's Slots, in order: the kernel's operands and outputs
SLOTS = (
    *D.DecisionInputs.KINDS, "point", "sigma2", "winners", *_COST_FIELDS,
    *D.DecisionOutputs.KINDS, *_COST_OUTPUTS, *(name for name, _ in _DIST),
)
# the slots of [N, M] grids and of [N, K] policy slots; "now" is 0-d
_GRID_SLOTS = frozenset((
    "metric_value", "target_value", "target_type", "metric_valid",
    "forecast_value", "forecast_valid", "slo_target", "observed",
    "demand_base_valid", "prior_point", "prior_sigma2", "prior_valid",
    "dist_point", "dist_sigma2", "dist_ok",
))
_POLICY_SLOTS = frozenset(
    f"{d}_p{x}" for d in ("up", "down") for x in ("type", "value", "period", "valid")
)


def _kernel_operands(inputs: FusedTickInputs, fout):
    """The kernels' operands, checked, and their outputs, allocated:
    (slot name -> tensor for every present slot, the series operands
    (n_valid, need, blend, row, col) or None, N, M, K, S). Raises
    ValueError on a dtype, shape or device the kernels do not take."""
    dec = inputs.decision
    dev = dec.metric_value.device
    if dec.metric_value.dim() != 2 or dec.up_ptype.dim() != 2:
        raise ValueError("tick_rows: metric_value and up_ptype must be 2-d")
    n, m = dec.metric_value.shape
    k = dec.up_ptype.shape[1]
    if m < 1 or k < 1:
        raise ValueError(f"tick_rows: {m} metrics, {k} policy slots (>= 1)")
    forecast = fout is not None
    cost = inputs.slo_valid is not None
    s = fout.point.shape[0] if forecast else 0
    wanted = dict(D.DecisionInputs.KINDS)
    sources = {name: getattr(dec, name) for name in wanted}
    if forecast:
        wanted.update(point=F32, sigma2=F32)
        sources.update(point=fout.point, sigma2=fout.sigma2)
    if cost:
        wanted.update((name, FusedTickInputs.KINDS[name]) for name in _COST_FIELDS)
        sources.update((name, getattr(inputs, name)) for name in _COST_FIELDS)

    def shape(name):
        if name in ("point", "sigma2", "n_valid") or name in _SERIES_FIELDS:
            return (s,)
        if name == "now":
            return ()
        return (n, m) if name in _GRID_SLOTS else (
            (n, k) if name in _POLICY_SLOTS else (n,))

    def checked(name, t, dtype):
        if t is None:
            raise ValueError(f"tick_rows: {name} is missing from its stage")
        t = t.contiguous()
        if t.dtype != dtype or tuple(t.shape) != shape(name) or t.device != dev:
            raise ValueError(
                f"tick_rows: {name} wants {dtype} {shape(name)} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        return t

    slots = {}
    for name, dtype in wanted.items():
        if name in ("forecast_value", "forecast_valid") and (
            forecast or dec.forecast_value is None
        ):
            continue  # the scatter's blend, or none
        slots[name] = checked(name, sources[name], dtype)
    series = None
    if forecast:
        series = (checked("n_valid", fout.n_valid, I32),) + tuple(
            checked(name, getattr(inputs, name), FusedTickInputs.KINDS[name])
            for name in ("series_need", "series_blend", "series_row", "series_col")
        )
        slots["winners"] = torch.empty((2, n, m), dtype=I32, device=dev)
    outputs = list(D.DecisionOutputs.KINDS.items())
    if cost:
        outputs += zip(_COST_OUTPUTS, C.CostOutputs.KINDS.values())
    if forecast:
        outputs += _DIST
    for name, dtype in outputs:
        slots[name] = torch.empty(shape(name), dtype=dtype, device=dev)
    return slots, series, n, m, k, s


def tick_rows(inputs: FusedTickInputs, fout):
    """The fused tick's row stages on `fout`, the forecast's outputs (None
    without the forecast stage): (decide's outputs, cost's outputs or None,
    the dist grids (point, sigma2, ok) or None). For CUDA tensors the
    winners memset and csrc/tick_rows.cu's two kernels, each counted in
    LAUNCHES; for CPU tensors tick_rows_reference."""
    dev = inputs.decision.metric_value.device
    if dev.type == "cpu":
        return tick_rows_reference(inputs, fout)
    if dev.type != "cuda":
        raise ValueError(f"tick_rows: unsupported device {dev}")
    slots, series, n, m, k, s = _kernel_operands(inputs, fout)
    lib = kernels.library("tick_rows")
    stream = torch.cuda.current_stream(dev).cuda_stream
    pointers = kernels.pointer_array(
        [slots[name].data_ptr() if name in slots else None for name in SLOTS]
    )
    with torch.cuda.device(dev):
        if series is not None:
            err = lib.tick_scatter_launch(
                *(t.data_ptr() for t in series), s, n, m,
                slots["winners"].data_ptr(), stream,
            )
            kernels.check("tick_rows", err, "tick_scatter launch")
            LAUNCHES["tick_scatter"] += int(s > 0)
        err = lib.tick_rows_launch(pointers, len(SLOTS), n, m, k, stream)
    kernels.check("tick_rows", err, "tick_rows launch")
    LAUNCHES["tick_rows"] += int(n > 0)
    dout = D.DecisionOutputs(**{f: slots[f] for f in D.DecisionOutputs.KINDS})
    cout = None
    if inputs.slo_valid is not None:
        cout = C.CostOutputs(**dict(zip(
            C.CostOutputs.KINDS, (slots[f] for f in _COST_OUTPUTS)
        )))
    dist = None
    if series is not None:
        dist = tuple(slots[name] for name, _ in _DIST)
    return dout, cout, dist


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fused_tick(inputs: FusedTickInputs) -> FusedTickOutputs:
    """forecast -> decide -> cost -> pool groups with every seam on the
    device, and no host synchronisation: no .item(), no boolean-mask
    indexing, no branch on a tensor's value. Host operands are placed
    as utils/operands.on_device says."""
    inputs = on_device(inputs)
    fout = None if inputs.forecast is None else M.forecast(inputs.forecast)
    dout, cout, dist = tick_rows(inputs, fout)
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


def _all_tensors(obj) -> bool:
    return all(isinstance(t, torch.Tensor) for _, t in _leaves(obj))


class FusedTickProgram:
    """`fused_tick` as one captured CUDA graph per operand shape class
    (the counterpart of `fused_tick_jit`, which compiles one XLA program
    per shape class).

    A call on the card copies the operands (tensors on any device, or
    host numpy arrays) into the shape class's static input buffers,
    replays the graph (one launch sequence, no host round trip) and
    returns clones of the static outputs, or with `host=True` the
    outputs as numpy in one device->host copy (utils/operands.fetch).
    The first call of a shape class captures it: two eager warm-up
    ticks on a side stream, then the capture with capture_error_mode
    "thread_local", so another thread's CUDA calls (the solve service's
    worker launching bin-pack kernels) neither fail nor invalidate the
    capture. A failed capture raises; it never falls back to eager.
    One call at a time runs: a lock is held from the copy into the
    static buffers through the fetch, since concurrent calls of one
    shape class share those buffers. On the CPU a call runs `fused_tick`
    itself, eagerly.

    Each call opens three spans (observability/tracing.py), in order:
    `solver.fused.upload` (the operands into the static buffers, and a
    shape class's capture; on the CPU their placement),
    `solver.fused.replay` (the graph's replay; on the CPU the eager
    program) and `solver.fused.fetch` (the one device->host copy, or the
    outputs' clones). `record(stage, seconds)`, when given, receives the
    three as stages "fused_upload", "fused_replay" and "fused_fetch",
    and on the card with `host=True` also "fused_device": two CUDA
    events on the stream, before and after the replay, read once the
    fetch has synchronised, so they add no sync."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._graphs = {}  # shape class -> (static inputs, outputs, graph)
        self._events = None  # the replay's (start, end) on the card
        self.captures = 0
        self.replays = 0

    def __call__(self, inputs: FusedTickInputs, host: bool = False,
                 record: Optional[Callable[[str, float], None]] = None):
        tracer = default_tracer()
        card = self.device.type == "cuda"
        with self._lock:
            t0 = time.perf_counter()
            with tracer.span("solver.fused.upload"):
                if not _all_tensors(inputs):
                    inputs = FusedTickInputs.from_numpy(inputs, "cpu")
                if card:
                    static_out, graph = self._staged(inputs)
                else:
                    inputs = inputs.to(self.device)
            t1 = time.perf_counter()
            with tracer.span("solver.fused.replay"):
                if card:
                    stream = torch.cuda.current_stream(self.device)
                    self._events[0].record(stream)
                    graph.replay()
                    self._events[1].record(stream)
                    self.replays += 1
                    out = static_out
                else:
                    out = fused_tick(inputs)
            t2 = time.perf_counter()
            with tracer.span("solver.fused.fetch"):
                if host:
                    out = fetch(out)
                elif card:
                    out = _clone_tree(out)
            t3 = time.perf_counter()
            # the fetch's device->host copy waited for the stream
            device_ms = (self._events[0].elapsed_time(self._events[1])
                         if card and host else None)
        if record is not None:
            record("fused_upload", t1 - t0)
            record("fused_replay", t2 - t1)
            record("fused_fetch", t3 - t2)
            if device_ms is not None:
                record("fused_device", device_ms / 1e3)
        return out

    def _staged(self, inputs: FusedTickInputs):
        """The shape class's (static outputs, graph), captured on its
        first call, with `inputs` copied into its static buffers."""
        key = shape_class(inputs)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(inputs)
        if self._events is None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        static_in, static_out, graph = entry
        for (_, dst), (_, src) in zip(_leaves(static_in), _leaves(inputs)):
            dst.copy_(src)
        return static_out, graph

    def _capture(self, inputs: FusedTickInputs):
        static_in = _clone_tree(inputs.to(self.device))
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                fused_tick(static_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static_out = fused_tick(static_in)
        self.captures += 1
        return static_in, static_out, graph


# -- chained path and numpy floor (the reference's, copied) -----------------
# Same operands, one program PER STAGE with numpy host glue between —
# the pre-fusion wire. The glue mirrors the program's seams (boolean-
# index writes land on zero-initialised cells), so chained == fused
# bitwise wherever live series take distinct cells (module docstring).


def _np_scatter(inputs, fout, n: int, m: int):
    rows = np.asarray(inputs.series_row, np.int64)
    cols = np.asarray(inputs.series_col, np.int64)
    point = np.asarray(fout.point, np.float32)
    sigma2 = np.asarray(fout.sigma2, np.float32)
    live = rows < n
    dist_gate = (
        np.asarray(fout.n_valid, np.int32)
        >= np.asarray(inputs.series_need, np.int32)
    ) & live
    blend_gate = np.asarray(inputs.series_blend, bool) & dist_gate
    fv = np.zeros((n, m), np.float32)
    fvalid = np.zeros((n, m), bool)
    fv[rows[blend_gate], cols[blend_gate]] = point[blend_gate]
    fvalid[rows[blend_gate], cols[blend_gate]] = True
    dist_point = np.zeros((n, m), np.float32)
    dist_sigma2 = np.zeros((n, m), np.float32)
    dist_ok = np.zeros((n, m), bool)
    dist_point[rows[dist_gate], cols[dist_gate]] = point[dist_gate]
    dist_sigma2[rows[dist_gate], cols[dist_gate]] = sigma2[dist_gate]
    dist_ok[rows[dist_gate], cols[dist_gate]] = True
    return fv, fvalid, (dist_point, dist_sigma2, dist_ok)


def _np_demand_overlay(inputs, dout, dist) -> C.CostInputs:
    prior_point = np.asarray(inputs.prior_point, np.float32)
    prior_sigma2 = np.asarray(inputs.prior_sigma2, np.float32)
    have = np.asarray(inputs.prior_valid, bool)
    if dist is not None:
        dist_point, dist_sigma2, dist_ok = dist
        prior_point = np.where(dist_ok, dist_point, prior_point)
        prior_sigma2 = np.where(dist_ok, dist_sigma2, prior_sigma2)
        have = dist_ok | have
    observed = np.asarray(inputs.observed, np.float32)
    with np.errstate(invalid="ignore"):
        mu = np.where(
            have & np.isfinite(prior_point),
            np.maximum(observed, prior_point),
            observed,
        )
        sigma = np.where(
            have & np.isfinite(prior_sigma2) & (prior_sigma2 > 0),
            np.sqrt(prior_sigma2),
            np.float32(0.0),
        )
    valid = np.asarray(inputs.demand_base_valid, bool)
    mu = np.where(valid, mu, np.float32(0.0)).astype(np.float32)
    sigma = np.where(valid, sigma, np.float32(0.0)).astype(np.float32)
    slo = np.asarray(inputs.slo_valid, bool)
    ha_min = np.asarray(inputs.ha_min, np.int32)
    ha_max = np.asarray(inputs.ha_max, np.int32)
    down_floor = np.asarray(dout.down_floor, np.int32)
    up_ceiling = np.asarray(dout.up_ceiling, np.int32)
    min_eff = np.where(
        slo, np.maximum(ha_min, np.minimum(down_floor, ha_max)), 0
    ).astype(np.int32)
    max_eff = np.where(
        slo, np.minimum(ha_max, np.maximum(up_ceiling, ha_min)), 0
    ).astype(np.int32)
    return C.CostInputs(
        base_desired=np.asarray(dout.desired, np.int32),
        min_replicas=min_eff,
        max_replicas=max_eff,
        unit_cost=np.asarray(inputs.unit_cost, np.float32),
        slo_weight=np.asarray(inputs.slo_weight, np.float32),
        max_hourly_cost=np.asarray(inputs.max_hourly_cost, np.float32),
        slo_valid=slo,
        slo_target=np.asarray(inputs.slo_target, np.float32),
        demand_mu=mu,
        demand_sigma=sigma,
        demand_valid=valid,
    )


def _np_pg_overlay(
    pg: PoolGroupOperands, final_desired, dout, dist
) -> PG.PoolGroupInputs:
    """Host mirror of _pg_overlay (same gather + overlay, np ops)."""
    final_desired = np.asarray(final_desired, np.int32)
    n = final_desired.shape[0]
    rows = np.clip(np.asarray(pg.member_row, np.int32), 0, n - 1)
    valid = np.asarray(pg.pool_valid, bool)
    base = np.where(valid, final_desired[rows], 0).astype(np.int32)
    down = np.asarray(dout.down_floor, np.int32)[rows]
    up = np.asarray(dout.up_ceiling, np.int32)[rows]
    pg_min = np.asarray(pg.pg_min, np.int32)
    pg_max = np.asarray(pg.pg_max, np.int32)
    min_eff = np.where(
        valid, np.maximum(pg_min, np.minimum(down, pg_max)), 0
    ).astype(np.int32)
    max_eff = np.where(
        valid, np.minimum(pg_max, np.maximum(up, pg_min)), 0
    ).astype(np.int32)
    prior_point = np.asarray(pg.prior_point, np.float32)
    prior_sigma2 = np.asarray(pg.prior_sigma2, np.float32)
    have = np.asarray(pg.prior_valid, bool)
    if dist is not None:
        dist_point, dist_sigma2, dist_ok = dist  # [N, M] grids
        g_ok = dist_ok[rows]
        prior_point = np.where(g_ok, dist_point[rows], prior_point)
        prior_sigma2 = np.where(g_ok, dist_sigma2[rows], prior_sigma2)
        have = g_ok | have
    observed = np.asarray(pg.observed, np.float32)
    with np.errstate(invalid="ignore"):
        mu = np.where(
            have & np.isfinite(prior_point),
            np.maximum(observed, prior_point),
            observed,
        )
        sigma = np.where(
            have & np.isfinite(prior_sigma2) & (prior_sigma2 > 0),
            np.sqrt(prior_sigma2),
            np.float32(0.0),
        )
    dvalid = np.asarray(pg.demand_base_valid, bool)
    mu = np.where(dvalid, mu, np.float32(0.0)).astype(np.float32)
    sigma = np.where(dvalid, sigma, np.float32(0.0)).astype(np.float32)
    return PG.PoolGroupInputs(
        base_desired=base,
        min_replicas=min_eff,
        max_replicas=max_eff,
        unit_cost=np.asarray(pg.unit_cost, np.float32),
        slo_weight=np.asarray(pg.slo_weight, np.float32),
        max_hourly_cost=np.asarray(pg.max_hourly_cost, np.float32),
        tier_penalty=np.asarray(pg.tier_penalty, np.float32),
        pool_valid=valid,
        slo_target=np.asarray(pg.slo_target, np.float32),
        demand_mu=mu,
        demand_sigma=sigma,
        demand_valid=dvalid,
        ratio_a=np.asarray(pg.ratio_a, np.int32),
        ratio_b=np.asarray(pg.ratio_b, np.int32),
        ratio_min_num=np.asarray(pg.ratio_min_num, np.int32),
        ratio_min_den=np.asarray(pg.ratio_min_den, np.int32),
        ratio_max_num=np.asarray(pg.ratio_max_num, np.int32),
        ratio_max_den=np.asarray(pg.ratio_max_den, np.int32),
        ratio_valid=np.asarray(pg.ratio_valid, bool),
        group_budget=np.asarray(pg.group_budget, np.float32),
        group_valid=np.asarray(pg.group_valid, bool),
    )


def fused_tick_chained(
    inputs: FusedTickInputs,
    forecast_fn: Optional[Callable] = None,
    decide_fn: Optional[Callable] = None,
    cost_fn: Optional[Callable] = None,
    poolgroup_fn: Optional[Callable] = None,
    device: DeviceLike = None,
) -> FusedTickOutputs:
    """One program per stage, host round-trip between each — the
    pre-fusion wire and the CPU service's fallback rung. A stage
    function left None is the port's program for it on `device` (the
    card by default), its operands uploaded and its outputs fetched in
    one copy (utils/operands.host_seam). `inputs` may hold tensors or
    numpy arrays: the glue runs on host copies."""
    inputs = FusedTickInputs.from_arrays(inputs)
    forecast_fn = forecast_fn or host_seam(M.forecast, M.ForecastInputs, device)
    decide_fn = decide_fn or host_seam(D.decide, D.DecisionInputs, device)
    cost_fn = cost_fn or host_seam(C.cost_decide, C.CostInputs, device)
    poolgroup_fn = poolgroup_fn or host_seam(
        PG.poolgroup_decide, PG.PoolGroupInputs, device
    )
    dec = inputs.decision
    n = int(np.asarray(dec.spec_replicas).shape[0])
    m = int(np.asarray(dec.metric_value).shape[1])
    fout = None
    dist = None
    if inputs.forecast is not None:
        fout = fetch(forecast_fn(inputs.forecast))
        fv, fvalid, dist = _np_scatter(inputs, fout, n, m)
        dec = replace(dec, forecast_value=fv, forecast_valid=fvalid)
    dout = fetch(decide_fn(dec))
    cout = None
    if inputs.slo_valid is not None:
        cout = fetch(cost_fn(_np_demand_overlay(inputs, dout, dist)))
    pout = None
    if inputs.poolgroup is not None:
        final = cout.desired if cout is not None else dout.desired
        pout = fetch(
            poolgroup_fn(
                _np_pg_overlay(inputs.poolgroup, final, dout, dist)
            )
        )
    return FusedTickOutputs(
        decision=dout, forecast=fout, cost=cout, poolgroup=pout
    )


def fused_tick_numpy(inputs: FusedTickInputs) -> FusedTickOutputs:
    """Pure-host floor of the never-block ladder: the stage mirrors
    joined by the same glue. Bitwise equal to fused_tick."""
    return fused_tick_chained(
        inputs,
        M.forecast_numpy,
        D.decide_numpy,
        C.cost_numpy,
        PG.poolgroup_numpy,
    )


# -- padding ------------------------------------------------------------------


def pad_series(inputs: FusedTickInputs, s_pad: int) -> FusedTickInputs:
    """Pad the forecast group to `s_pad` series (tensors or host numpy,
    answered in kind). Pad series carry an impossible sample
    requirement, a False blend gate and the trash row N: they cannot
    touch a live cell."""
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
        if isinstance(t, torch.Tensor):
            return torch.cat([t, t.new_full((pad,), fill)])
        t = np.asarray(t)
        return np.concatenate([t, np.full(pad, fill, t.dtype)])

    return replace(
        inputs,
        forecast=M.concat_forecast_inputs([inputs.forecast], s_pad),
        series_row=extend(inputs.series_row, n),
        series_col=extend(inputs.series_col, 0),
        series_need=extend(inputs.series_need, _I32_MAX),
        series_blend=extend(inputs.series_blend, False),
    )
