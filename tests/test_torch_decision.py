"""The port's HA decision (karpenter_tpu_torch/ops/decision.py) and its
single-card fleet step (parallel/mesh.py) == the reference's, bitwise.

Inputs are drawn once with numpy from a seed
(karpenter_tpu_torch.workloads, which draws like
tests/test_fusedtick.py::mk_decision) and handed to both packages: the
reference as its dataclass of numpy arrays, the port through
`from_numpy(..., device="cpu")`. Every output leaf is compared on its
bytes (f32 bits, i32 and bool exactly) against the jitted reference
program and its numpy mirror.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.ops import binpack as RB
from karpenter_tpu.ops import decision as RD
from karpenter_tpu.parallel import mesh as RMESH
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.ops import decision as D
from karpenter_tpu_torch.parallel import mesh as MESH

N, M = 64, 3


def ref_fields(obj):
    """A reference dataclass (or dict) as a dict of numpy arrays, nested
    for nested dataclasses, None kept."""
    if isinstance(obj, dict):
        items = obj.items()
    else:
        items = ((f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    out = {}
    for name, value in items:
        if value is None:
            out[name] = None
        elif dataclasses.is_dataclass(value) or isinstance(value, dict):
            out[name] = ref_fields(value)
        else:
            out[name] = np.asarray(value)
    return out


def _flat(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def assert_bitwise(port_out, ref_out, context=""):
    """Every leaf of the port's outputs (an Operands dataclass) has the
    reference's dtype, shape and bytes; both trees have the same leaves."""
    got = dict(_flat(port_out.to_numpy()))
    want = dict(_flat(ref_fields(ref_out)))
    assert got.keys() == want.keys(), context
    for path, x in got.items():
        y = want[path]
        if x is None or y is None:
            assert x is None and y is None, f"{context}: {path} presence"
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, (
            f"{context}: {path} {x.dtype}{x.shape} vs {y.dtype}{y.shape}"
        )
        assert x.tobytes() == y.tobytes(), f"{context}: {path} differs bitwise"


def fleet(seed, forecast=False, n=N, m=M):
    """(reference DecisionInputs, port DecisionInputs on the CPU) of one
    numpy draw."""
    fields = workloads.build_decision_inputs(seed, n, m, forecast=forecast)
    return RD.DecisionInputs(**fields), D.DecisionInputs.from_numpy(fields, "cpu")


class TestDecideParity:
    @pytest.mark.parametrize("forecast", [False, True])
    @pytest.mark.parametrize("seed", range(3))
    def test_against_jit_and_numpy(self, seed, forecast):
        ref_in, port_in = fleet(seed, forecast)
        port = D.decide(port_in)
        assert_bitwise(port, RD.decide_jit(ref_in), f"jit seed={seed}")
        assert_bitwise(port, RD.decide_numpy(ref_in), f"numpy seed={seed}")

    def test_draw_is_mk_decision(self):
        """build_decision_inputs draws tests/test_fusedtick.py::mk_decision's fleet
        (edge rows 0-3 aside)."""
        from test_fusedtick import mk_decision

        want = ref_fields(mk_decision(4, N, M))
        got = workloads.build_decision_inputs(4, N, M)
        for name, value in want.items():
            if value is None:
                assert name not in got
            elif value.ndim == 0:
                assert got[name] == value, name
            else:
                np.testing.assert_array_equal(got[name][4:], value[4:], name)

    def test_edge_rows(self):
        """Rows 0-3 of build_decision_inputs: zero target, a recommendation past
        2**31 - 128, a Percent policy at spec 0, min > max."""
        ref_in, port_in = fleet(7)
        out = D.decide(port_in).to_numpy()
        assert_bitwise(D.decide(port_in), RD.decide_numpy(ref_in), "edges")
        # a zero target collapses the ratio to 0: Value/Utilization give
        # 1, AverageValue 0, never a division by zero
        assert np.isfinite(out["able_at"]).all()
        # saturate at 2**31 - 128, never wrap to a negative count
        assert out["recommendation"][1] == 2**31 - 128
        assert out["desired"][1] == 2**31 - 128
        # Percent at spec 0: the budget is floored at one replica's worth
        # (ceil(1 * 50 / 100) = 1, ceil(1 * 200 / 100) = 2)
        assert out["desired"][2] in (1, 2) and out["able_to_scale"][2]
        # min > max: the clamp gives max
        assert out["desired"][3] == 5

    def test_saturating_cast(self):
        x = torch.tensor([3e9, -3e9, 2.0**31, 2.0**31 - 128, -(2.0**31), 7.9])
        assert D.to_i32(x).tolist() == [
            2**31 - 128, -(2**31), 2**31 - 128, 2**31 - 128, -(2**31), 7
        ]

    def test_clip_upper_bound_wins(self):
        x = torch.tensor([0.0, 10.0, 50.0])
        lo = torch.full((3,), 30.0)
        hi = torch.full((3,), 5.0)
        assert D.clip(x, lo, hi).tolist() == [5.0, 5.0, 5.0]

    @pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 4000])
    def test_pad_to(self, n):
        assert D.pad_to(n) == RD.pad_to(n)


class TestOperands:
    def test_dtypes_pinned_and_none_kept(self):
        fields = workloads.build_decision_inputs(1, 8, 2)
        wide = {k: np.asarray(v, np.float64 if v.dtype.kind == "f"
                              else np.int64 if v.dtype.kind == "i" else v.dtype)
                for k, v in fields.items()}
        port = D.DecisionInputs.from_numpy(wide, device="cpu")
        for name, kind in D.DecisionInputs.KINDS.items():
            value = getattr(port, name)
            if name.startswith("forecast_"):
                assert value is None
                continue
            assert value.dtype == kind, name
            assert value.device.type == "cpu"
        assert port.now.shape == () and port.now.dtype == torch.float32

    def test_from_reference_dataclass(self):
        ref_in, port_in = fleet(2, forecast=True)
        again = D.DecisionInputs.from_numpy(ref_in, device="cpu")
        for name in D.DecisionInputs.KINDS:
            assert torch.equal(getattr(again, name), getattr(port_in, name))

    def test_never_aliases_the_caller(self):
        fields = workloads.build_decision_inputs(3, 8, 2)
        port = D.DecisionInputs.from_numpy(fields, device="cpu")
        fields["metric_value"][:] = -1.0
        assert (port.metric_value >= 0).all()

    def test_unknown_field_raises(self):
        fields = workloads.build_decision_inputs(3, 8, 2)
        fields["metric_values"] = fields.pop("metric_value")
        with pytest.raises(ValueError, match="unknown"):
            D.DecisionInputs.from_numpy(fields, device="cpu")

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        fields = workloads.build_decision_inputs(3, 8, 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            D.DecisionInputs.from_numpy(fields)
        with pytest.raises(RuntimeError, match="CUDA"):
            MESH.example_decision_inputs()

    def test_to_numpy_round_trip(self):
        _, port_in = fleet(5, forecast=True)
        back = D.DecisionInputs.from_numpy(port_in.to_numpy(), device="cpu")
        for name in D.DecisionInputs.KINDS:
            assert torch.equal(getattr(back, name), getattr(port_in, name))


# the shapes the reference's graft entry compile-checks
GRAFT = dict(N=64, M=4, P_=256, T=16, K=16, L=16, buckets=16)


@pytest.fixture(scope="module")
def graft_step():
    """(reference outputs, port outputs) of one fleet step at the graft
    entry's shapes; the reference is its jitted fleet_step."""
    ref = RMESH.fleet_step(
        RMESH.example_decision_inputs(N=GRAFT["N"], M=GRAFT["M"]),
        RMESH.example_binpack_inputs(
            P_=GRAFT["P_"], T=GRAFT["T"], K=GRAFT["K"], L=GRAFT["L"]
        ),
        buckets=GRAFT["buckets"],
    )
    port = MESH.fleet_step(
        MESH.example_decision_inputs(N=GRAFT["N"], M=GRAFT["M"], device="cpu"),
        MESH.example_binpack_inputs(
            P_=GRAFT["P_"], T=GRAFT["T"], K=GRAFT["K"], L=GRAFT["L"],
            device="cpu",
        ),
        buckets=GRAFT["buckets"],
        device="cpu",
    )
    return jax.tree_util.tree_map(np.asarray, ref), port


class TestFleetStep:
    def test_example_inputs_are_the_reference_arrays(self):
        ref_d = ref_fields(RMESH.example_decision_inputs(N=64, M=4))
        port_d = MESH.example_decision_inputs(N=64, M=4, device="cpu").to_numpy()
        for name, value in ref_d.items():
            if value is None:
                assert port_d[name] is None
            else:
                assert port_d[name].tobytes() == value.tobytes(), name
        ref_b = RMESH.example_binpack_inputs(P_=256, T=16, K=16, L=16)
        port_b = MESH.example_binpack_inputs(P_=256, T=16, K=16, L=16,
                                             device="cpu")
        for f in dataclasses.fields(RB.BinPackInputs):
            want = getattr(ref_b, f.name)
            got = getattr(port_b, f.name)
            assert (want is None) == (got is None), f.name
            if want is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_decision_half(self, graft_step):
        ref, port = graft_step
        assert_bitwise(port[0], ref[0], "fleet_step decision")

    @pytest.mark.parametrize(
        "field",
        ["assigned", "assigned_count", "nodes_needed", "lp_bound", "unschedulable"],
    )
    def test_binpack_half(self, graft_step, field):
        ref, port = graft_step
        got = getattr(port[1], field)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), getattr(ref[1], field))

    def test_default_device_raises_without_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        d = MESH.example_decision_inputs(device="cpu")
        b = MESH.example_binpack_inputs(device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            MESH.fleet_step(d, b)
