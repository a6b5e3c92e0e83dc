"""The fused tick's row-stage kernels (csrc/tick_rows.cu: the forecast ->
decide scatter, decide, the cost seam and the cost ladder) on a CUDA card
== the plain version `tick_rows_reference` on the card and the numpy
mirror `fused_tick_numpy`, bit for bit on every leaf (ints and bools
exact, floats as int32 bits), on every combination of the stages and on
the edges of the arithmetic; and one `FusedTickProgram` replay at the HA
fleet cell's shape == the mirror. Every test carries the `cuda` marker
and skips without a card; on the CPU the plain version is held against
the composition it replaces by tests/test_torch_fusedtick.py.

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_tick_rows_cuda.py -q
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.forecast import models as M
from karpenter_tpu_torch.ops import fusedtick as FT

pytestmark = pytest.mark.cuda

_I32_MAX = np.iinfo(np.int32).max
COST_FIELDS = (
    "ha_min", "ha_max", "unit_cost", "slo_weight", "max_hourly_cost",
    "slo_valid", "slo_target", "observed", "demand_base_valid",
    "prior_point", "prior_sigma2", "prior_valid",
)
FORECAST_FIELDS = (
    "forecast", "series_row", "series_col", "series_need", "series_blend",
)


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these tests run the tick_rows kernels")


def _policies(r, n, k):
    return {
        f"{d}_{name}": value
        for d in ("up", "down")
        for name, value in (
            ("ptype", r.randint(0, 3, (n, k)).astype(np.int32)),
            # 0 makes a Percent budget ceil(-1e-5) = -0
            ("pvalue", r.randint(0, 10, (n, k)).astype(np.int32)),
            ("pperiod", r.randint(15, 120, (n, k)).astype(np.int32)),
            ("pvalid", r.rand(n, k) > 0.4),
        )
    }


def _edge_rows(f, k):
    """Rows 0-10 (those below N) are the edges: 0 zero targets; 1 a
    recommendation past 2**31 - 128 and 2 one below -2**31 (both must
    saturate); 3 min > max; 4 Percent policies at spec 0; 5 an unknown
    target type; 6 weight 0 and unit cost 0 (8 distinct candidates whose
    scores tie: candidate 0 wins); 7 weight 0 and a one-replica band (the candidates tie); 8 a budget
    below the base (cost_limited); 9 non-finite priors; 10 a zero SLO
    target (the headroom's floor of the divisor)."""
    dec = f["decision"]
    n, m = dec["metric_value"].shape
    now = float(dec["now"])
    rows = {i for i in range(11) if i < n}
    if 0 in rows:
        dec["target_value"][0] = 0.0
        dec["metric_valid"][0] = True
    if 1 in rows:
        dec["metric_value"][1] = 1e30
        dec["target_value"][1] = 1.0
        dec["target_type"][1] = 0
        dec["metric_valid"][1] = True
        dec["max_replicas"][1] = _I32_MAX
        dec["has_last_scale"][1] = False
        dec["up_policy"][1] = 0
    if 2 in rows:
        dec["metric_value"][2] = -1e30
        dec["target_value"][2] = 1.0
        dec["target_type"][2] = 1
        dec["metric_valid"][2] = True
        dec["has_last_scale"][2] = False
        # Min select both ways: a blended metric cannot lift the minimum
        dec["up_policy"][2] = dec["down_policy"][2] = 1
    if 3 in rows:
        dec["min_replicas"][3] = 30
        dec["max_replicas"][3] = 5
    if 4 in rows:
        dec["spec_replicas"][4] = 0
        dec["status_replicas"][4] = 3
        dec["target_type"][4] = 1
        dec["metric_valid"][4] = True
        dec["has_last_scale"][4] = True
        dec["last_scale_time"][4] = np.float32(now - 1000.0)
        dec["up_window"][4] = 0
        dec["up_ptype"][4] = 1
        dec["up_pvalue"][4] = (50, 200, 7, 0)[:k] if k <= 4 else 50
        dec["up_pvalid"][4] = True
    if 5 in rows:
        dec["target_type"][5] = 3
    if f.get("slo_valid") is None:
        return
    for i in rows & {6, 7, 8, 9, 10}:
        f["slo_valid"][i] = True
        f["demand_base_valid"][i] = True
    if 6 in rows:
        f["slo_weight"][6] = 0.0
        f["unit_cost"][6] = 0.0
        # desired 5, no hold, a band of [0, 30]: the 8 candidates differ
        dec["metric_valid"][6] = False
        dec["spec_replicas"][6] = 5
        dec["has_last_scale"][6] = False
        dec["min_replicas"][6], dec["max_replicas"][6] = 0, 40
        f["ha_min"][6], f["ha_max"][6] = 0, 30
    if 7 in rows:
        f["slo_weight"][7] = 0.0
        f["ha_min"][7] = f["ha_max"][7] = 4
    if 8 in rows:
        f["unit_cost"][8] = 5.0
        f["max_hourly_cost"][8] = 3.0
        dec["spec_replicas"][8] = dec["min_replicas"][8] = 6
    if 9 in rows:
        f["prior_valid"][9] = True
        f["prior_point"][9] = (np.nan, np.inf, -np.inf, 7.0, np.nan)[:m]
        f["prior_sigma2"][9] = (np.inf, np.nan, -4.0, np.inf, 0.0)[:m]
    if 10 in rows:
        f["slo_target"][10, 0] = 0.0


def draw(seed, n, m, k=2, s=None, t=16, groups=0, pools=4, s_pad=None):
    """Numpy FusedTickInputs fields of n HAs x m metrics with k policy
    slots, every stage present: workloads.build_fused_tick_inputs's draw,
    with k policy slots, unknown target types, non-finite priors on ~5% of
    the cells, a series need drawn over [0, t], a tenth of the series
    moved onto the cell of the series before them (two gated series in
    one cell: the larger index wins), the edge rows of `_edge_rows`, and
    the series padded to s_pad (pad series carry the trash row N)."""
    s = min(n * m, 48) if s is None else s
    f = workloads.build_fused_tick_inputs(seed, n, m, s, t, groups, pools)
    r = np.random.RandomState(seed + 7)
    dec = f["decision"]
    dec.update(_policies(r, n, k))
    dec["target_type"] = r.randint(0, 4, (n, m)).astype(np.int32)
    odd = r.rand(n, m) < 0.05
    f["prior_point"] = np.where(
        odd, r.choice([np.nan, np.inf, -np.inf], (n, m)), f["prior_point"]
    ).astype(np.float32)
    f["prior_sigma2"] = np.where(
        odd, r.choice([np.nan, np.inf, -1.0], (n, m)), f["prior_sigma2"]
    ).astype(np.float32)
    f["series_need"] = r.randint(0, t + 1, s).astype(np.int32)
    if s > 1:
        twin = np.flatnonzero(r.rand(s - 1) < 0.1) + 1
        f["series_row"][twin] = f["series_row"][twin - 1]
        f["series_col"][twin] = f["series_col"][twin - 1]
    _edge_rows(f, k)
    if s_pad is not None:
        f = FT.pad_series(FT.FusedTickInputs.from_arrays(f), s_pad)
    return f


def with_stages(fields, forecast, cost, poolgroup):
    inputs = FT.FusedTickInputs.from_arrays(fields)
    drop = (() if forecast else FORECAST_FIELDS) + (() if cost else COST_FIELDS)
    drop += () if poolgroup else ("poolgroup",)
    return FT.FusedTickInputs(**{
        name: None if name in drop else getattr(inputs, name)
        for name in FT.FusedTickInputs.KINDS
    })


def _flat(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def assert_same_bits(got, want, what):
    """Two trees (Operands or dicts of arrays / tensors) hold the same
    leaves, dtypes, shapes and bits (floats as int32 bits)."""
    def numpy(tree):
        if hasattr(tree, "to_numpy"):
            tree = tree.to_numpy()
        return {path: None if x is None else np.asarray(
            x.cpu() if isinstance(x, torch.Tensor) else x)
            for path, x in _flat(tree)}

    got, want = numpy(got), numpy(want)
    assert got.keys() == want.keys(), what
    for path, x in got.items():
        y = want[path]
        if x is None or y is None:
            assert x is None and y is None, f"{what}: {path} presence"
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, (what, path)
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        bad = np.flatnonzero((x != y).reshape(-1))
        assert bad.size == 0, (
            f"{what}: {path} differs at {bad.size} cells, first {bad[:5]}: "
            f"{x.reshape(-1)[bad[:5]]} vs {y.reshape(-1)[bad[:5]]}")


def rows_tree(dout, cout, dist):
    return {
        "decision": dout.to_numpy(),
        "cost": None if cout is None else cout.to_numpy(),
        "dist": None if dist is None else dict(zip(
            ("point", "sigma2", "ok"), (x.cpu().numpy() for x in dist))),
    }


def check_rows(host, what):
    """tick_rows on the card (one launch of each kernel) == the plain
    version on the card, leaf for leaf, and fused_tick on the card == the
    numpy mirror."""
    card = FT.FusedTickInputs.from_numpy(host, "cuda")
    fout = None if card.forecast is None else M.forecast(card.forecast)
    FT.reset_launch_counts()
    got = FT.tick_rows(card, fout)
    assert FT.LAUNCHES == {"tick_scatter": int(fout is not None),
                           "tick_rows": 1}, what
    want = FT.tick_rows_reference(card, fout)
    assert_same_bits(rows_tree(*got), rows_tree(*want), f"{what} plain")
    assert_same_bits(FT.fused_tick(card), FT.fused_tick_numpy(host),
                     f"{what} mirror")


@pytest.mark.parametrize("poolgroup", [True, False], ids=["pg", "no-pg"])
@pytest.mark.parametrize("cost", [True, False], ids=["cost", "no-cost"])
@pytest.mark.parametrize("forecast", [True, False], ids=["fc", "no-fc"])
def test_every_stage_combination(forecast, cost, poolgroup):
    """N = 300, not a multiple of the block's 128 threads."""
    fields = draw(11, 300, 3, groups=12, s=400, s_pad=512)
    check_rows(with_stages(fields, forecast, cost, poolgroup),
               f"fc={forecast} cost={cost} pg={poolgroup}")


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("m", [1, 3, 5])
def test_metrics_and_policy_slots(m, k):
    fields = draw(100 * m + k, 259, m, k=k, s=200, s_pad=256)
    check_rows(with_stages(fields, True, True, False), f"m={m} k={k}")


def test_own_blend_without_the_forecast_stage():
    """No forecast stage, and the decision's own forecast_value /
    forecast_valid blend."""
    fields = draw(5, 130, 3, s=64)
    host = with_stages(fields, False, True, False)
    r = np.random.RandomState(9)
    dec = host.decision
    dec.forecast_value = r.uniform(0, 150, (130, 3)).astype(np.float32)
    dec.forecast_valid = r.rand(130, 3) > 0.3
    check_rows(host, "own blend")


def test_edges_are_reached():
    """The draw reaches what the tests claim to cover: saturated casts,
    ties of weight 0, budget caps, two gated series in a cell, pad series
    and non-finite priors."""
    fields = draw(11, 300, 3, groups=12, s=400, s_pad=512)
    host = FT.FusedTickInputs.from_arrays(fields)
    out = FT.fused_tick_numpy(host)
    dec, cost = out.decision, out.cost
    assert dec.recommendation[1] == 2**31 - 128
    assert dec.recommendation[2] == -(2**31)
    assert dec.desired[6] == 5 and cost.desired[6] == 5
    assert cost.cost_limited[8]
    rows = np.asarray(host.series_row)
    assert (rows == 300).sum() == 112
    cells = rows[rows < 300] * 3 + np.asarray(host.series_col)[rows < 300]
    assert np.unique(cells).size < cells.size
    assert not np.isfinite(np.asarray(host.prior_point)).all()


def test_edges_tiled_over_the_fleet_width():
    """The edge rows repeated every 16 rows over 10,000 HAs (so every
    block of the launch holds each of them), 6,000 series padded to
    6,144."""
    fields = draw(3, 10000, 3, s=6000, t=8)
    edge = np.arange(10000) % 16
    edge = np.where(edge < 11, edge, np.arange(10000))
    for group in (fields["decision"], fields):
        for name, x in group.items():
            if isinstance(x, np.ndarray) and x.ndim and x.shape[0] == 10000:
                group[name] = np.ascontiguousarray(x[edge])
    host = FT.pad_series(FT.FusedTickInputs.from_arrays(fields), 6144)
    check_rows(host, "fleet width")


def test_operands_the_kernels_do_not_take_raise():
    fields = draw(2, 130, 3, s=64)
    def on_card():
        return FT.FusedTickInputs.from_numpy(fields, "cuda")

    card = on_card()
    fout = M.forecast(card.forecast)
    bad = on_card()
    bad.decision.metric_value = bad.decision.metric_value.double()
    with pytest.raises(ValueError, match="metric_value"):
        FT.tick_rows(bad, fout)
    bad = on_card()
    bad.observed = bad.observed[:-1]
    with pytest.raises(ValueError, match="observed"):
        FT.tick_rows(bad, fout)
    bad = on_card()
    bad.prior_valid = None
    with pytest.raises(ValueError, match="prior_valid"):
        FT.tick_rows(bad, fout)
    bad = on_card()
    bad.series_col = bad.series_col.cpu()
    with pytest.raises(ValueError, match="series_col"):
        FT.tick_rows(bad, fout)
    FT.reset_launch_counts()
    FT.tick_rows(card, fout)
    assert FT.LAUNCHES == {"tick_scatter": 1, "tick_rows": 1}


def test_graph_replay_at_the_fleet_cell_equals_the_mirror():
    """One FusedTickProgram replay of the fleet cell's draw (10,000 HAs x
    3 metrics, 5,000 series x 64 samples padded to 6,144, 64 pool groups
    of 4) == fused_tick_numpy on every leaf. The capture launches each
    kernel three times (two warm-ups and the capture); replays add
    none."""
    from portbench.reference import fleet_draws

    fields = fleet_draws.build_fused_tick_inputs(
        7, n=10000, m=3, s=5000, t=64, groups=64, pools=4)
    host = FT.pad_series(FT.FusedTickInputs.from_arrays(fields), 6144)
    program = FT.FusedTickProgram("cuda")
    FT.reset_launch_counts()
    program(host, host=True)
    assert program.captures == 1
    assert FT.LAUNCHES == {"tick_scatter": 3, "tick_rows": 3}
    got = program(host, host=True)
    assert program.replays == 2
    assert FT.LAUNCHES == {"tick_scatter": 3, "tick_rows": 3}
    assert_same_bits(got, FT.fused_tick_numpy(host), "fleet replay")
