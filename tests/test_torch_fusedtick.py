"""The port's fused steady-state tick (karpenter_tpu_torch/ops/
fusedtick.py) == the reference's `fused_tick_jit` and `fused_tick_numpy`,
bitwise on every output leaf, for every stage-presence combination
(forecast, cost, pool groups each on or off), with padded series, and on
the bench's shared-cell draw (where the port follows the numpy mirror).

Inputs come from karpenter_tpu_torch.workloads.build_fused_tick_inputs
(the bench's draws, with distinct series cells as production emits
them), made once with numpy and handed to both packages.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from karpenter_tpu.forecast import models as RM
from karpenter_tpu.ops import decision as RD
from karpenter_tpu.ops import fusedtick as RFT
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.ops import fusedtick as FT

from test_torch_decision import assert_bitwise

REPO = pathlib.Path(__file__).resolve().parents[1]
N, M, S, T, G = 64, 3, 48, 16, 6

COST_FIELDS = (
    "ha_min", "ha_max", "unit_cost", "slo_weight", "max_hourly_cost",
    "slo_valid", "slo_target", "observed", "demand_base_valid",
    "prior_point", "prior_sigma2", "prior_valid",
)
FORECAST_FIELDS = (
    "forecast", "series_row", "series_col", "series_need", "series_blend",
)


def ref_inputs(fields):
    """The reference's FusedTickInputs from a numpy dict of
    build_fused_tick_inputs's form."""
    f = dict(fields)
    f["decision"] = RD.DecisionInputs(**f["decision"])
    if f.get("forecast") is not None:
        f["forecast"] = RM.ForecastInputs(**f["forecast"])
    if f.get("poolgroup") is not None:
        f["poolgroup"] = RFT.PoolGroupOperands(**f["poolgroup"])
    return RFT.FusedTickInputs(**f)


def with_stages(fields, forecast, cost, poolgroup):
    f = dict(fields)
    for name in (() if forecast else FORECAST_FIELDS) + (() if cost else COST_FIELDS):
        f[name] = None
    if not poolgroup:
        f["poolgroup"] = None
    return f


def check(fields, context, jit=True):
    """The port's tick on `fields`, held against the numpy mirror and
    (when `jit`) the jitted reference program."""
    ref = ref_inputs(fields)
    port = FT.fused_tick(FT.FusedTickInputs.from_numpy(fields, "cpu"))
    assert_bitwise(port, RFT.fused_tick_numpy(ref), f"numpy {context}")
    if jit:
        assert_bitwise(port, RFT.fused_tick_jit(ref), f"jit {context}")
    return port


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def full(request):
    return workloads.build_fused_tick_inputs(
        3, N, M, S, T, groups=G, pools=request.param
    )


class TestFusedTickParity:
    @pytest.mark.parametrize("poolgroup", [True, False], ids=["pg", "no-pg"])
    @pytest.mark.parametrize("cost", [True, False], ids=["cost", "no-cost"])
    @pytest.mark.parametrize("forecast", [True, False], ids=["fc", "no-fc"])
    def test_every_stage_combination(self, full, forecast, cost, poolgroup):
        fields = with_stages(full, forecast, cost, poolgroup)
        out = check(fields, f"fc={forecast} cost={cost} pg={poolgroup}")
        assert (out.forecast is None) == (not forecast)
        assert (out.cost is None) == (not cost)
        assert (out.poolgroup is None) == (not poolgroup)

    def test_pool_groups_repair_somewhere(self):
        repaired = 0
        for seed in range(3):
            fields = workloads.build_fused_tick_inputs(
                seed, N, M, S, T, groups=8, pools=4
            )
            out = check(fields, f"seed={seed}", jit=False)
            repaired += int(out.poolgroup.joint_repair.sum())
        assert repaired > 0

    def test_pad_series(self, full):
        """Padding the series changes no live output, and equals the
        reference's own pad_series."""
        padded = FT.pad_series(FT.FusedTickInputs.from_numpy(full, "cpu"), 64)
        assert padded.forecast.values.shape == (64, T)
        bare = FT.fused_tick(FT.FusedTickInputs.from_numpy(full, "cpu"))
        out = FT.fused_tick(padded)
        for stage in ("decision", "cost", "poolgroup"):
            for name, x in getattr(bare, stage).to_numpy().items():
                y = getattr(getattr(out, stage), name).numpy()
                assert x.tobytes() == y.tobytes(), f"{stage}.{name}"
        ref = RFT.pad_series(ref_inputs(full), 64)
        assert_bitwise(out, RFT.fused_tick_numpy(ref), "padded vs numpy")
        assert FT.pad_series(padded, 64) is padded
        with pytest.raises(ValueError):
            FT.pad_series(padded, 32)

    def test_bench_shared_cell_draw_follows_the_mirror(self):
        """bench.py::_fusedtick_inputs(1, 256, 3, 128, 32), rebuilt here from
        the same RandomState calls: row and column are drawn
        independently, so series share cells. The port equals
        fused_tick_numpy there (the largest gated series index wins a
        shared cell); the reference's jitted program does not."""
        fields = bench_fusedtick_fields(1, 256, 3, 128, 32)
        cells = fields["series_row"] * 3 + fields["series_col"]
        assert cells.size - np.unique(cells).size == 11
        check(fields, "bench seed 1", jit=False)

    def test_distinct_cells(self):
        fields = workloads.build_fused_tick_inputs(5, 256, 3, 512, 8)
        cells = fields["series_row"] * 3 + fields["series_col"]
        assert np.unique(cells).size == 512


def bench_fusedtick_fields(seed, n, m, s, t):
    """bench.py::_fusedtick_inputs's draw as a numpy dict of
    build_fused_tick_inputs's form."""
    r = np.random.RandomState(seed)
    decision = workloads._decision_fields(r, n, m, 1000.0)
    forecast = {
        "values": r.uniform(0, 100, (s, t)).astype(np.float32),
        "valid": r.rand(s, t) > 0.2,
        "times": np.cumsum(r.uniform(10, 20, (s, t)), 1).astype(np.float32),
        "weights": np.ones((s, t), np.float32),
        "horizon": np.full(s, 60.0, np.float32),
        "step_s": np.full(s, 15.0, np.float32),
        "model": r.randint(0, 2, s).astype(np.int32),
        "season": np.full(s, 4, np.int32),
        "alpha": np.full(s, 0.5, np.float32),
        "beta": np.full(s, 0.1, np.float32),
        "gamma": np.full(s, 0.1, np.float32),
    }
    return {
        "decision": decision,
        "forecast": forecast,
        "series_row": r.randint(0, n, s).astype(np.int32),
        "series_col": r.randint(0, m, s).astype(np.int32),
        "series_need": np.full(s, 2, np.int32),
        "series_blend": r.rand(s) > 0.3,
        "ha_min": r.randint(0, 3, n).astype(np.int32),
        "ha_max": r.randint(20, 40, n).astype(np.int32),
        "unit_cost": r.uniform(0.1, 3.0, n).astype(np.float32),
        "slo_weight": r.uniform(0, 2, n).astype(np.float32),
        "max_hourly_cost": r.uniform(5, 50, n).astype(np.float32),
        "slo_valid": r.rand(n) > 0.4,
        "slo_target": r.uniform(1, 80, (n, m)).astype(np.float32),
        "observed": r.uniform(0, 100, (n, m)).astype(np.float32),
        "demand_base_valid": r.rand(n, m) > 0.3,
        "prior_point": r.uniform(0, 100, (n, m)).astype(np.float32),
        "prior_sigma2": r.uniform(0, 10, (n, m)).astype(np.float32),
        "prior_valid": r.rand(n, m) > 0.5,
    }


class TestScatterRule:
    def test_largest_gated_index_wins(self):
        rows = torch.tensor([0, 0, 0, 1, 2, 2], dtype=torch.int32)
        cols = torch.tensor([1, 1, 1, 0, 2, 2], dtype=torch.int32)
        gate = torch.tensor([True, True, False, False, True, True])
        win = FT._winners(2, 3, rows, cols, gate)
        # series 2 is not gated, so series 1 takes (0, 1); series 3's cell
        # stays empty; row 2 is the trash row and is sliced off
        assert win.tolist() == [[-1, 1, -1], [-1, -1, -1]]
        values = torch.arange(6, dtype=torch.float32) + 10.0
        assert FT._pick(values, win).tolist() == [[0, 11, 0], [0, 0, 0]]


class TestOperandsAndProgram:
    def test_from_numpy_nested(self, full):
        port = FT.FusedTickInputs.from_numpy(full, "cpu")
        assert port.decision.now.shape == ()
        assert port.poolgroup.member_row.dtype == torch.int32
        assert port.forecast.valid.dtype == torch.bool
        again = FT.FusedTickInputs.from_numpy(ref_inputs(full), "cpu")
        assert FT.shape_class(again) == FT.shape_class(port)
        none = FT.FusedTickInputs.from_numpy(with_stages(full, True, True, False), "cpu")
        assert none.poolgroup is None
        assert FT.shape_class(none) != FT.shape_class(port)

    def test_programs(self, full):
        port = FT.FusedTickInputs.from_numpy(full, "cpu")
        assert FT.programs(port) == 4
        assert FT.programs(dataclasses.replace(port, poolgroup=None)) == 3
        assert FT.programs(FT.FusedTickInputs(decision=port.decision)) == 1

    def test_program_on_the_cpu_is_fused_tick(self, full):
        port = FT.FusedTickInputs.from_numpy(full, "cpu")
        program = FT.FusedTickProgram(device="cpu")
        assert_bitwise(program(port), FT.fused_tick(port).to_numpy(), "cpu")
        assert program.captures == 0

    def test_program_default_device_raises_without_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            FT.FusedTickProgram()


NEW_MODULES = [
    "karpenter_tpu_torch/ops/decision.py",
    "karpenter_tpu_torch/ops/cost.py",
    "karpenter_tpu_torch/ops/poolgroup.py",
    "karpenter_tpu_torch/ops/fusedtick.py",
    "karpenter_tpu_torch/forecast/models.py",
    "karpenter_tpu_torch/parallel/mesh.py",
    "karpenter_tpu_torch/utils/operands.py",
    "karpenter_tpu_torch/workloads.py",
]


@pytest.mark.parametrize("path", NEW_MODULES)
def test_slice_modules_are_standalone(path):
    """This slice's modules import torch and numpy and the port, never jax
    or the reference (TestPortIsStandalone scans the whole package)."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root in {"__future__", "dataclasses", "typing", "numpy",
                            "torch", "karpenter_tpu_torch"}, f"{path}: {name}"
