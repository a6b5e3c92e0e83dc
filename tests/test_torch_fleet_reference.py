"""The HA fleet cell's plain reference (portbench/reference/fleet_tick.py),
which decides the benchmark's `correct` for `ha-fleet-10000.forecast`,
held bit for bit against two witnesses on the CPU, at small sizes with
every stage present:

  * the JAX package's numpy mirror `fused_tick_numpy`, and its jitted
    program `fused_tick_jit` on the draws where
    tests/test_torch_fusedtick.py holds the port to the jit (the
    reference package's own jit and numpy forecasts differ in one sigma2
    element across history buckets, so the jit is no witness elsewhere);
  * the port: `FusedTickProgram` on the CPU, and `SolverService.fused_tick`
    (the cell's path), whose door pads the series up the S ladder.

Every float32 leaf is compared as its bit pattern. Also: the frozen draw
equals the port's workloads draw, the bfloat16 control differs, and the
cell's generator replays exactly the operands it sent.
"""

import dataclasses

import numpy as np
import pytest

from karpenter_tpu.forecast import models as RM
from karpenter_tpu.ops import decision as RD
from karpenter_tpu.ops import fusedtick as RFT
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.ops import fusedtick as FT
from karpenter_tpu_torch.solver import SolverService
from portbench import harness
from portbench.reference import fleet_draws
from portbench.reference import fleet_tick as R

N, M, S, T, G = 64, 3, 48, 16, 6
CELL = "ha-fleet-10000.forecast"


def ref_inputs(fields):
    """The JAX package's FusedTickInputs from the draw's numpy dicts."""
    f = dict(fields)
    f["decision"] = RD.DecisionInputs(**f["decision"])
    f["forecast"] = RM.ForecastInputs(**f["forecast"])
    f["poolgroup"] = RFT.PoolGroupOperands(**f["poolgroup"])
    return RFT.FusedTickInputs(**f)


def as_bits(outputs, n_series=None):
    """A FusedTickOutputs (numpy, jax or torch leaves) in the reference's
    answer form; the forecast leaves cut to the first `n_series`."""
    out = {}
    for stage in R.STAGES:
        group = getattr(outputs, stage)
        leaves = {}
        for f in dataclasses.fields(group):
            x = getattr(group, f.name)
            x = np.asarray(x.cpu() if hasattr(x, "cpu") else x)
            if stage == "forecast" and n_series is not None:
                x = x[:n_series]
            leaves[f.name] = R.bits(x) if x.dtype == np.float32 else x
        out[stage] = leaves
    return out


def assert_same_bits(got, want, context):
    assert got.keys() == want.keys(), context
    for stage, leaves in want.items():
        assert got[stage].keys() == leaves.keys(), (context, stage)
        for name, x in leaves.items():
            y = got[stage][name]
            assert y.dtype == x.dtype and y.shape == x.shape, (
                context, stage, name)
            assert y.tobytes() == x.tobytes(), (context, stage, name)


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def full(request):
    """tests/test_torch_fusedtick.py's `full` draw: seed 3, every stage."""
    return workloads.build_fused_tick_inputs(
        3, N, M, S, T, groups=G, pools=request.param)


def _draws():
    return [workloads.build_fused_tick_inputs(seed, N, M, S, T, groups=G,
                                              pools=pools)
            for seed, pools in ((0, 4), (1, 2), (5, 4))]


class TestSecondWitness:
    def test_equals_the_jax_numpy_mirror(self):
        for i, fields in enumerate(_draws()):
            want = R.answer({}, fields)
            assert_same_bits(
                as_bits(RFT.fused_tick_numpy(ref_inputs(fields))), want,
                f"draw {i}")

    def test_equals_the_jax_jit_where_the_port_does(self, full):
        want = R.answer({}, full)
        assert_same_bits(as_bits(RFT.fused_tick_jit(ref_inputs(full))),
                         want, "jit")
        assert_same_bits(
            as_bits(RFT.fused_tick_numpy(ref_inputs(full))), want, "numpy")

    def test_padded_series_move_no_live_output(self, full):
        """The mirror on the series padded to 64 (as the service's door
        pads them) answers the reference's unpadded tick."""
        padded = RFT.pad_series(ref_inputs(full), 64)
        assert np.asarray(padded.forecast.values).shape == (64, T)
        assert_same_bits(as_bits(RFT.fused_tick_numpy(padded), S),
                         R.answer({}, full), "padded mirror")


class TestThePort:
    def test_program_on_the_cpu(self, full):
        for i, fields in enumerate(_draws() + [full]):
            program = FT.FusedTickProgram(device="cpu")
            got = program(FT.FusedTickInputs.from_arrays(fields), host=True)
            assert_same_bits(as_bits(got), R.answer({}, fields), f"draw {i}")

    def test_service_fused_tick_pads_at_the_door(self):
        """40 series: the door pads them to 48, the answer is cut back."""
        fields = workloads.build_fused_tick_inputs(7, N, M, 40, T, groups=G)
        service = SolverService(device="cpu", registry=GaugeRegistry())
        try:
            got = service.fused_tick(fields, backend="torch")
        finally:
            service.close()
        assert service.stats.fused_dispatches == 1
        assert_same_bits(as_bits(got), R.answer({}, fields), "service")


class TestDrawsAndControl:
    @pytest.mark.parametrize("seed,pools", [(0, 4), (9, 2)])
    def test_frozen_draw_equals_the_ports(self, seed, pools):
        ours = fleet_draws.build_fused_tick_inputs(seed, N, M, S, T,
                                                   groups=G, pools=pools)
        theirs = workloads.build_fused_tick_inputs(seed, N, M, S, T,
                                                   groups=G, pools=pools)
        assert_same_bits(_tree(ours), _tree(theirs), f"seed {seed}")

    def test_control_differs(self, full):
        want, ctl = R.answer({}, full), R.control({}, full)
        differ = sum(int(np.count_nonzero(ctl[s][n] != want[s][n]))
                     for s in want for n in want[s])
        assert differ > 0


def _tree(fields):
    """The draw's nested dicts as {group: {leaf: array}}, groups flat."""
    out = {"top": {}}
    for name, value in fields.items():
        if isinstance(value, dict):
            out[name] = {k: np.asarray(v) for k, v in value.items()}
        else:
            out["top"][name] = np.asarray(value)
    return out


class TestGenerator:
    @pytest.mark.parametrize("seed", [11, 2**41 + 3])
    def test_replay_equals_the_operands_sent(self, seed):
        cell = harness.find_cell(CELL)
        cell.config.update(has=N, series=S, history=T, groups=G)
        cell.mix.update(clients=3)
        gen = cell.traffic(seed)
        sent = {}
        for k in range(3):
            gen.update(2, k)
            sent[k] = _tree(gen.operands(2))
            gen.update(0, k)  # another client's ticks change nothing here
        replayed = gen.replay(2, [2, 0])
        assert sorted(replayed) == [0, 2]
        for k, ops in replayed.items():
            assert_same_bits(_tree(ops), sent[k], f"request {k}")
        # the answer of a replayed tick is the reference's, as judged
        want = R.answer(cell.config, replayed[2])
        assert want["forecast"]["point"].shape == (S,)
