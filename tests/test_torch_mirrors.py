"""The port's numpy mirrors == the reference's, byte for byte.

`decide_numpy`, `forecast_numpy`, `cost_numpy`, `poolgroup_numpy` (both
rungs), `fused_tick_numpy` and the port's `fused_tick_chained` (its
per-stage tensor programs on the CPU) are held against the reference's
mirrors on seeded numpy draws, the decision fleets with their edge rows
(workloads.with_edge_rows). The port's mirrors take the port's operand
dataclasses holding numpy arrays (`Cls.from_arrays`), as the solve
service hands them; `fetch` packs a tree of tensors into one copy.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.forecast import models as RM
from karpenter_tpu.ops import cost as RC
from karpenter_tpu.ops import decision as RD
from karpenter_tpu.ops import fusedtick as RFT
from karpenter_tpu.ops import poolgroup as RPG
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.forecast import models as M
from karpenter_tpu_torch.ops import cost as C
from karpenter_tpu_torch.ops import decision as D
from karpenter_tpu_torch.ops import fusedtick as FT
from karpenter_tpu_torch.ops import poolgroup as PG
from karpenter_tpu_torch.utils import operands

from test_cost import random_inputs as random_cost_inputs
from test_forecast import random_forecast_inputs
from test_poolgroup import random_group_inputs
from test_torch_decision import _flat, ref_fields
from test_torch_fusedtick import ref_inputs, with_stages

N, M_COLS, S, T = 64, 3, 32, 16


def assert_same_bytes(got, want, context=""):
    """Two dataclass trees (numpy leaves, or anything np.asarray takes)
    have the same leaves, each of the same dtype, shape and bytes."""
    a, b = dict(_flat(ref_fields(got))), dict(_flat(ref_fields(want)))
    assert a.keys() == b.keys(), context
    for path, x in a.items():
        y = b[path]
        if x is None or y is None:
            assert x is None and y is None, f"{context}: {path} presence"
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, (
            f"{context}: {path} {x.dtype}{x.shape} vs {y.dtype}{y.shape}"
        )
        assert x.tobytes() == y.tobytes(), f"{context}: {path} differs"


def decision_fields(seed, forecast):
    return workloads.build_decision_inputs(seed, N, M_COLS, forecast=forecast)


class TestDecideMirror:
    @pytest.mark.parametrize("forecast", [False, True])
    @pytest.mark.parametrize("seed", range(4))
    def test_equals_reference(self, seed, forecast):
        fields = decision_fields(seed, forecast)
        got = D.decide_numpy(D.DecisionInputs.from_arrays(fields))
        assert_same_bytes(got, RD.decide_numpy(RD.DecisionInputs(**fields)))
        # and the tensor program agrees with the mirror
        program = D.decide(D.DecisionInputs.from_numpy(fields, "cpu"))
        assert_same_bytes(operands.fetch(program), got, "program")

    def test_helpers_equal_reference(self):
        fields = decision_fields(9, True)
        port_in = D.DecisionInputs.from_arrays(fields)
        ref_in = RD.DecisionInputs(**fields)
        for values in (None, fields["forecast_value"]):
            got = D._recommendations_numpy(port_in, values)
            want = RD._recommendations_numpy(ref_in, values)
            assert got.tobytes() == want.tobytes()
        x = np.linspace(-3, 3, 97, dtype=np.float32)
        assert D._ceil_guarded_np(x).tobytes() == RD._ceil_guarded_np(x).tobytes()


class TestForecastMirror:
    @pytest.mark.parametrize("seed", range(4))
    def test_equals_reference(self, seed):
        ref_in = random_forecast_inputs(np.random.RandomState(seed), S, T)
        port_in = M.ForecastInputs.from_arrays(ref_in)
        assert_same_bytes(M.forecast_numpy(port_in), RM.forecast_numpy(ref_in))

    def test_helpers_equal_reference(self):
        ref_in = random_forecast_inputs(np.random.RandomState(11), S, T)
        port_in = M.ForecastInputs.from_arrays(ref_in)
        for got, want in zip(M._np_hw_scan(port_in), RM._np_hw_scan(ref_in)):
            assert got.tobytes() == want.tobytes()
        args = [np.asarray(getattr(ref_in, f))
                for f in ("values", "valid", "times", "weights")]
        fit = M._np_linear_fit(*args)
        for got, want in zip(fit, RM._np_linear_fit(*args)):
            assert got.tobytes() == want.tobytes()
        stats = M._np_residual_stats(*args, fit[0], fit[1])
        for got, want in zip(stats, RM._np_residual_stats(*args, fit[0], fit[1])):
            assert got.tobytes() == want.tobytes()
        assert M.MODEL_CODES == RM.MODEL_CODES

    @pytest.mark.parametrize("t_pad", [16, 32])
    def test_host_plumbing_equals_reference(self, t_pad):
        a = random_forecast_inputs(np.random.RandomState(5), 5, T)
        b = random_forecast_inputs(np.random.RandomState(6), 3, T)
        pa, pb = M.ForecastInputs.from_arrays(a), M.ForecastInputs.from_arrays(b)
        got = M.concat_forecast_inputs(
            [M.pad_forecast_inputs(pa, t_pad), M.pad_forecast_inputs(pb, t_pad)], 16
        )
        want = RM.concat_forecast_inputs(
            [RM.pad_forecast_inputs(a, t_pad), RM.pad_forecast_inputs(b, t_pad)], 16
        )
        assert_same_bytes(got, want, "host pad + concat")
        out = M.forecast_numpy(got)
        assert_same_bytes(
            M.slice_forecast_outputs(out, 5, 8),
            RM.slice_forecast_outputs(RM.forecast_numpy(want), 5, 8),
        )


class TestCostMirror:
    @pytest.mark.parametrize("seed", range(4))
    def test_equals_reference(self, seed):
        ref_in = random_cost_inputs(seed, n=N, m=M_COLS)
        got = C.cost_numpy(C.CostInputs.from_arrays(ref_in))
        assert_same_bytes(got, RC.cost_numpy(ref_in))
        program = C.cost_decide(C.CostInputs.from_numpy(ref_in, "cpu"))
        assert_same_bytes(operands.fetch(program), got, "program")


class TestPoolGroupMirror:
    @pytest.mark.parametrize("enforce", [True, False])
    @pytest.mark.parametrize("g, p, m", [(8, 4, 2), (8, 2, 3), (4, 3, 1)])
    @pytest.mark.parametrize("seed", range(2))
    def test_equals_reference(self, seed, g, p, m, enforce):
        ref_in = random_group_inputs(seed, g, p, m)
        got = PG.poolgroup_numpy(PG.PoolGroupInputs.from_arrays(ref_in), enforce)
        assert_same_bytes(got, RPG.poolgroup_numpy(ref_in, enforce=enforce))

    @pytest.mark.parametrize("p", [2, 3, 4])
    def test_digits(self, p):
        assert PG._np_joint_digits(p).tobytes() == RPG.joint_digits(p).tobytes()
        assert np.array_equal(PG.joint_digits(p).numpy(), RPG.joint_digits(p))


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def tick_fields(request):
    return workloads.build_fused_tick_inputs(
        5, N, M_COLS, S, T, groups=6, pools=request.param
    )


class TestFusedTickMirror:
    @pytest.mark.parametrize("poolgroup", [True, False], ids=["pg", "no-pg"])
    @pytest.mark.parametrize("cost", [True, False], ids=["cost", "no-cost"])
    @pytest.mark.parametrize("forecast", [True, False], ids=["fc", "no-fc"])
    def test_numpy_and_chained_equal_reference(
        self, tick_fields, forecast, cost, poolgroup
    ):
        fields = with_stages(tick_fields, forecast, cost, poolgroup)
        want = RFT.fused_tick_numpy(ref_inputs(fields))
        port_in = FT.FusedTickInputs.from_arrays(fields)
        assert_same_bytes(FT.fused_tick_numpy(port_in), want, "numpy")
        assert_same_bytes(
            FT.fused_tick_chained(port_in, device="cpu"), want, "chained"
        )
        # the one-program tick, fetched in one copy, agrees too
        got = FT.FusedTickProgram(device="cpu")(port_in, host=True)
        assert_same_bytes(got, want, "program")

    def test_glue_equals_reference(self, tick_fields):
        port_in = FT.FusedTickInputs.from_arrays(tick_fields)
        ref_in = ref_inputs(tick_fields)
        fout = M.forecast_numpy(port_in.forecast)
        n, m = N, M_COLS
        got = FT._np_scatter(port_in, fout, n, m)
        want = RFT._np_scatter(ref_in, fout, n, m)
        for x, y in zip(got[:2] + got[2], want[:2] + want[2]):
            assert x.tobytes() == y.tobytes()
        dout = D.decide_numpy(port_in.decision)
        assert_same_bytes(
            FT._np_demand_overlay(port_in, dout, got[2]),
            RFT._np_demand_overlay(ref_in, dout, want[2]),
        )
        assert_same_bytes(
            FT._np_pg_overlay(port_in.poolgroup, dout.desired, dout, got[2]),
            RFT._np_pg_overlay(ref_in.poolgroup, dout.desired, dout, want[2]),
        )

    def test_host_pad_series_equals_reference(self, tick_fields):
        got = FT.pad_series(FT.FusedTickInputs.from_arrays(tick_fields), 48)
        want = RFT.pad_series(ref_inputs(tick_fields), 48)
        assert_same_bytes(got, want, "pad_series")
        assert isinstance(got.series_row, np.ndarray)


class TestFetch:
    def test_one_copy_for_a_nested_tree(self, tick_fields):
        tick = FT.fused_tick(FT.FusedTickInputs.from_numpy(tick_fields, "cpu"))
        before = operands.FETCHES["count"]
        host = operands.fetch(tick)
        assert operands.FETCHES["count"] == before + 1
        assert_same_bytes(host, tick.to_numpy(), "fetch")
        assert isinstance(host.decision.desired, np.ndarray)
        assert host.decision.able_to_scale.dtype == np.bool_
        # a tree without tensors passes through without a fetch
        assert operands.fetch(host) is host
        assert operands.FETCHES["count"] == before + 1

    def test_from_arrays_pins_dtypes(self):
        fields = decision_fields(2, False)
        fields["spec_replicas"] = fields["spec_replicas"].astype(np.int64)
        arrays = D.DecisionInputs.from_arrays(fields)
        assert arrays.spec_replicas.dtype == np.int32
        assert isinstance(arrays.now, np.float32)
        back = D.DecisionInputs.from_arrays(D.DecisionInputs.from_numpy(fields, "cpu"))
        assert_same_bytes(back, arrays)

    def test_host_seams_answer_numpy(self):
        fields = decision_fields(4, True)
        before = operands.FETCHES["count"]
        seam = operands.host_seam(D.decide, D.DecisionInputs, "cpu")
        got = seam(D.DecisionInputs.from_arrays(fields))
        assert operands.FETCHES["count"] == before + 1
        assert isinstance(got.desired, np.ndarray)
        assert_same_bytes(got, RD.decide_numpy(RD.DecisionInputs(**fields)))
        for fn in (D.decide_host, M.forecast_host, C.cost_host, PG.poolgroup_host):
            assert fn.__name__.endswith("_host")


def test_default_host_seams_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fields = decision_fields(1, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.decide_host(D.DecisionInputs.from_arrays(fields))
