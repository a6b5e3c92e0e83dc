"""The port's decision, fleet step and fused tick on a CUDA card == the same
programs on the CPU, bitwise, and the captured CUDA graph of the tick ==
its eager run. Every test carries the `cuda` marker and skips without a
card; on the CPU the programs are held against the JAX reference by
tests/test_torch_decision.py and tests/test_torch_fusedtick.py.

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_tick_cuda.py -q
"""

import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops import decision as D
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.ops import fusedtick as FT
from karpenter_tpu_torch.parallel import mesh as MESH

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these tests compare the card's "
                    "run with the CPU's")


def _leaves(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}.")
        elif value is not None:
            yield f"{prefix}{name}", value


def assert_same_bits(got, want):
    """Two output dataclasses hold the same leaves, dtypes, shapes and
    bytes."""
    got, want = dict(_leaves(got.to_numpy())), dict(_leaves(want.to_numpy()))
    assert got.keys() == want.keys()
    for path, x in got.items():
        y = want[path]
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), f"{path} differs bitwise"


@pytest.mark.parametrize("forecast", [False, True])
def test_decide_card_equals_cpu(forecast):
    fields = workloads.build_decision_inputs(2, 512, 3, forecast=forecast)
    assert_same_bits(
        D.decide(D.DecisionInputs.from_numpy(fields, "cuda")),
        D.decide(D.DecisionInputs.from_numpy(fields, "cpu")),
    )


def test_fleet_step_runs_both_kernels():
    dec = MESH.example_decision_inputs(N=64, M=4, device="cuda")
    pack = MESH.example_binpack_inputs(P_=256, T=16, K=16, L=16, device="cuda")
    TF.reset_launch_counts()
    dout, bout = MESH.fleet_step(dec, pack, buckets=16)
    assert TF.LAUNCHES["fused_assign"] > 0, TF.LAUNCHES
    assert TF.LAUNCHES["shelf_bfd"] > 0, TF.LAUNCHES
    assert_same_bits(dout, D.decide(dec.to("cpu")))
    plain = TB.solve(pack, buckets=16, backend="torch")
    for name in ("assigned", "assigned_count", "nodes_needed", "unschedulable"):
        assert torch.equal(getattr(bout, name), getattr(plain, name)), name


@pytest.mark.parametrize("pools", [2, 4])
def test_fused_tick_card_graph_and_cpu_agree(pools):
    sets = [
        workloads.build_fused_tick_inputs(seed, 256, 3, 128, 32, groups=8,
                                          pools=pools)
        for seed in (0, 1)
    ]
    cards = [FT.FusedTickInputs.from_numpy(f, "cuda") for f in sets]
    program = FT.FusedTickProgram()
    program(cards[0])  # capture outside the sync check
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = [FT.fused_tick(c) for c in cards]
        replay = [program(c) for c in cards]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert program.captures == 1
    for fields, e, r in zip(sets, eager, replay):
        assert_same_bits(e, FT.fused_tick(FT.FusedTickInputs.from_numpy(fields, "cpu")))
        assert_same_bits(r, e)


def test_program_captures_once_per_shape_class():
    fields = workloads.build_fused_tick_inputs(3, 128, 3, 64, 16, groups=4)
    full = FT.FusedTickInputs.from_numpy(fields, "cuda")
    bare = FT.FusedTickInputs(decision=full.decision)
    program = FT.FusedTickProgram()
    for inputs in (full, bare, full, bare):
        out = program(inputs)
        assert (out.forecast is None) == (inputs.forecast is None)
    assert program.captures == 2 and program.replays == 4
    assert_same_bits(program(bare), FT.fused_tick(bare))
