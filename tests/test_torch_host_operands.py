"""The port's programs take host operands, as the reference's jitted
programs do.

The reference's `binpack`, `decide_jit`, `forecast_jit`, `cost_jit`,
`poolgroup_jit`, `sim_step_jit` and `sim_rollout_jit` are jax.jit
programs: handed numpy arrays they place them on the default device.
The port's programs used to take tensors only, and died deep inside on
numpy leaves (binpack: `TypeError: _any() got an unexpected keyword
argument 'dim'` in `_feasibility`, on the encoder's own output). Each
now places host operands first (`ops/binpack.on_device`,
`utils/operands.on_device`): on the card by the port's rule, on the CPU
here, where the tests make the CPU the default.

Each case shows the old failure (the program with its placement step
taken out) and then the reference's answer, bitwise, from the same host
operands. TestPriorityOffBinpack runs preemption's cases of that name,
which the loaded suite leaves out because they wrap the port's inputs
in jax.device_put, on the host operands directly.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_constraints as ref_constraints
import test_poolgroup as ref_poolgroup
from karpenter_tpu.forecast import models as RM
from karpenter_tpu.metrics.producers.pendingcapacity import (
    encoder as ref_encoder,
)
from karpenter_tpu.ops import binpack as RB
from karpenter_tpu.ops import cost as RC
from karpenter_tpu.ops import decision as RD
from karpenter_tpu.ops import fusedtick as RFT
from karpenter_tpu.ops import poolgroup as RPG
from karpenter_tpu.ops import simstep as RSK
from karpenter_tpu.parallel import mesh as RMESH
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.forecast import models as M
from karpenter_tpu_torch.metrics.producers.pendingcapacity import encoder
from karpenter_tpu_torch.ops import binpack as B
from karpenter_tpu_torch.ops import cost as C
from karpenter_tpu_torch.ops import decision as D
from karpenter_tpu_torch.ops import fusedtick as FT
from karpenter_tpu_torch.ops import poolgroup as PG
from karpenter_tpu_torch.ops import simstep as SK
from karpenter_tpu_torch.ops.numpy_binpack import binpack_numpy
from karpenter_tpu_torch.parallel import mesh as MESH
from karpenter_tpu_torch.utils import operands
from karpenter_tpu_torch.utils.device import resolve_device

from test_cost import random_inputs as random_cost_inputs
from test_forecast import random_forecast_inputs
from test_poolgroup import random_group_inputs
from test_torch_decision import assert_bitwise
from test_torch_forecast import jit_equals_mirror
from test_torch_fusedtick import ref_inputs as ref_fused_inputs
from test_torch_fusedtick import with_stages
from test_torch_reference_suites import _helper, _port_defaults_to_cpu  # noqa: F401
from test_torch_simstep import raw_inputs

BINPACK_FIELDS = (
    "assigned", "assigned_count", "nodes_needed", "lp_bound", "unschedulable"
)


@pytest.fixture(autouse=True)
def _fresh_constraint_state():
    for module in (encoder, ref_encoder):
        module.reset_constraint_state()
    yield
    for module in (encoder, ref_encoder):
        module.reset_constraint_state()


def _encoded(seed, constrained):
    """(the port's encoder output, the reference's) for one seeded world
    of the reference's constraint suite: BinPackInputs of numpy arrays."""
    port = _helper("test_constraints")
    worlds = []
    for suite in (port, ref_constraints):
        pods, profiles, groups = suite._random_world(np.random.default_rng(seed))
        worlds.append(suite._encode(pods, profiles, groups if constrained else []))
    return worlds


class TestBinpackHostOperands:
    @pytest.mark.parametrize("constrained", [False, True])
    @pytest.mark.parametrize("seed", range(3))
    def test_encoder_output_equals_reference_bitwise(self, seed, constrained):
        host, ref_host = _encoded(seed, constrained)
        leaves = [getattr(host, f.name) for f in dataclasses.fields(host)]
        assert any(isinstance(v, np.ndarray) for v in leaves)
        assert not any(isinstance(v, torch.Tensor) for v in leaves)
        with pytest.raises(TypeError):  # the old failure
            B.assign_rows(host, 8)
        port = B.binpack(host, buckets=8)
        ref = RB.binpack(ref_host, buckets=8)
        for name in BINPACK_FIELDS:
            got = getattr(port, name).numpy()
            want = np.asarray(getattr(ref, name))
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert got.tobytes() == want.tobytes(), name

    def test_tensor_inputs_keep_their_device(self):
        host, _ = _encoded(0, False)
        tensors = B.inputs_from_numpy(
            {f.name: getattr(host, f.name) for f in dataclasses.fields(host)},
            "cpu",
        )
        assert B.on_device(tensors) is tensors

    @pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
    def test_host_operands_default_to_the_card(self, monkeypatch):
        """Without the tests' CPU default, host operands go to the card,
        which this machine lacks: the port's device rule, not a CPU
        fallback."""
        monkeypatch.setattr(B, "resolve_device", resolve_device)
        host, _ = _encoded(0, False)
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            B.binpack(host)


def _decision():
    fields = workloads.build_decision_inputs(0, 64, 3, forecast=True)
    return D.DecisionInputs, D, D.decide, RD.decide_jit(RD.DecisionInputs(**fields)), fields


def _forecast():
    inputs = random_forecast_inputs(np.random.RandomState(1), 48, 32)
    assert jit_equals_mirror(inputs)
    return M.ForecastInputs, M, M.forecast, RM.forecast_jit(inputs), inputs


def _cost():
    inputs = random_cost_inputs(0, n=64, m=3)
    return C.CostInputs, C, C.cost_decide, RC.cost_jit(inputs), inputs


def _poolgroup():
    inputs = random_group_inputs(0)
    return (PG.PoolGroupInputs, PG, PG.poolgroup_decide,
            RPG.poolgroup_jit(inputs), inputs)


def _sim_rollout():
    inputs = raw_inputs(0)
    return (SK.SimRolloutInputs, SK, SK.sim_rollout_vmapped,
            RSK.sim_rollout_vmapped(inputs), inputs)


def _sim_step():
    rollout = raw_inputs(1)
    inputs = RSK.SimStepInputs(
        replicas=rollout.replicas0, target=rollout.replicas0 + 2,
        demand=rollout.demand[:, 0], price=rollout.price[:, 0],
        fault=rollout.fault[:, 0], cap=rollout.cap, hourly=rollout.hourly,
        step_limit=rollout.step_limit, min_replicas=rollout.min_replicas,
        max_replicas=rollout.max_replicas,
    )
    return SK.SimStepInputs, SK, SK.sim_step, RSK.sim_step_jit(inputs), inputs


@pytest.mark.parametrize("case", [
    _decision, _forecast, _cost, _poolgroup, _sim_step, _sim_rollout,
], ids=lambda f: f.__name__[1:])
def test_program_takes_host_operands(case, monkeypatch):
    cls, module, program, want, ref_inputs = case()
    host = cls.from_arrays(ref_inputs)  # the port's dataclass, numpy leaves
    with monkeypatch.context() as patch:  # the old failure
        patch.setattr(module, "on_device", lambda inputs: inputs)
        with pytest.raises((TypeError, AttributeError)):
            program(host)
    assert_bitwise(program(host), want, program.__name__)


def test_operands_keep_tensor_device_and_scalars():
    fields = workloads.build_decision_inputs(0, 8, 2)
    tensors = D.DecisionInputs.from_numpy(fields, "cpu")
    assert operands.on_device(tensors) is tensors
    # a host scalar beside tensors is not a host array: nothing moves
    scalar_now = dataclasses.replace(tensors, now=np.float32(5.0))
    assert operands.on_device(scalar_now) is scalar_now
    # a host array beside tensors joins them on their device
    mixed = dataclasses.replace(tensors, spec_replicas=fields["spec_replicas"])
    placed = operands.on_device(mixed)
    assert isinstance(placed.spec_replicas, torch.Tensor)
    assert placed.spec_replicas.device == tensors.metric_value.device


class TestPriorityOffBinpack:
    """preemption's TestPriorityOffBinpack with the port's binpack on
    the host operands themselves (the reference wraps them in
    jax.device_put)."""

    problem = _helper("test_preemption").TestPriorityOffBinpack.problem

    def test_absent_equals_zero_operands(self):
        rng = np.random.default_rng(23)
        for trial in range(5):
            fields = self.problem(rng)
            absent = B.BinPackInputs(**fields)
            zeroed = B.BinPackInputs(
                **fields,
                pod_priority=np.zeros(fields["pod_requests"].shape[0], np.int32),
                group_tier=np.zeros(
                    fields["group_allocatable"].shape[0], np.int32
                ),
            )
            for solver in (B.binpack, binpack_numpy):
                a, z = solver(absent), solver(zeroed)
                assert np.array_equal(
                    np.asarray(a.assigned), np.asarray(z.assigned)
                ), f"trial {trial}"
                assert np.array_equal(
                    np.asarray(a.nodes_needed), np.asarray(z.nodes_needed)
                )
                assert int(a.unschedulable) == int(z.unschedulable)

    def test_priority_steers_away_from_preemptible_tiers(self):
        fields = dict(
            pod_requests=np.full((4, 1), 1.0, np.float32),
            pod_valid=np.ones(4, bool),
            pod_intolerant=np.zeros((4, 1), bool),
            pod_required=np.zeros((4, 1), bool),
            group_allocatable=np.full((2, 1), 8.0, np.float32),
            group_taints=np.zeros((2, 1), bool),
            group_labels=np.zeros((2, 1), bool),
        )
        inputs = B.BinPackInputs(
            **fields,
            pod_priority=np.array([0, 0, 500, 500], np.int32),
            group_tier=np.array([1, 0], np.int32),
        )
        device = B.binpack(inputs)
        host = binpack_numpy(inputs)
        assert device.assigned.tolist() == [0, 0, 1, 1]
        assert np.array_equal(
            np.asarray(device.assigned), np.asarray(host.assigned)
        )

    def test_large_preference_scores_survive_steering(self):
        fields = dict(
            pod_requests=np.full((1, 1), 1.0, np.float32),
            pod_valid=np.ones(1, bool),
            pod_intolerant=np.zeros((1, 1), bool),
            pod_required=np.zeros((1, 1), bool),
            group_allocatable=np.full((2, 1), 8.0, np.float32),
            group_taints=np.zeros((2, 1), bool),
            group_labels=np.zeros((2, 1), bool),
            pod_group_score=np.array([[-3000.0, -2500.0]], np.float32),
        )
        plain = B.BinPackInputs(**fields)
        carrying = B.BinPackInputs(
            **fields,
            pod_priority=np.zeros(1, np.int32),
            group_tier=np.array([0, 1], np.int32),
        )
        for solver in (B.binpack, binpack_numpy):
            assert np.asarray(solver(plain).assigned).tolist() == [1]
            assert np.asarray(solver(carrying).assigned).tolist() == [1]

    def test_steer_is_lexicographically_senior_to_score(self):
        inputs = B.BinPackInputs(
            pod_requests=np.full((1, 1), 1.0, np.float32),
            pod_valid=np.ones(1, bool),
            pod_intolerant=np.zeros((1, 1), bool),
            pod_required=np.zeros((1, 1), bool),
            group_allocatable=np.full((3, 1), 8.0, np.float32),
            group_taints=np.zeros((3, 1), bool),
            group_labels=np.zeros((3, 1), bool),
            pod_group_score=np.array([[9000.0, -5000.0, -4000.0]], np.float32),
            pod_priority=np.array([100], np.int32),
            group_tier=np.array([1, 0, 0], np.int32),
        )
        for solver in (B.binpack, binpack_numpy):
            assert np.asarray(solver(inputs).assigned).tolist() == [2]


class TestFusedTickHostOperands:
    """fused_tick on the port's dataclass with numpy leaves, as the
    reference's fused_tick_jit takes them. The draws have distinct series
    cells (production's series map), where the port and the jitted
    reference agree; shared cells follow fused_tick_numpy
    (tests/test_torch_fusedtick.py)."""

    @pytest.mark.parametrize("stages", [
        (True, True, True), (True, False, False), (False, True, True),
        (False, False, True),
    ], ids=["fc-cost-pg", "fc", "cost-pg", "pg"])
    def test_host_operands_equal_the_jitted_reference(self, stages,
                                                      monkeypatch):
        fields = with_stages(
            workloads.build_fused_tick_inputs(3, 64, 3, 48, 16, groups=6,
                                              pools=4),
            *stages,
        )
        host = FT.FusedTickInputs.from_arrays(fields)
        assert not any(isinstance(v, torch.Tensor)
                       for v in operands._leaves(host, []))
        with monkeypatch.context() as patch:  # the old failure
            patch.setattr(FT, "on_device", lambda inputs: inputs,
                          raising=False)
            # the row stages read the device of a numpy leaf: a str
            with pytest.raises(
                AttributeError, match="'str' object has no attribute 'type'"
            ):
                FT.fused_tick(host)
        assert_bitwise(FT.fused_tick(host),
                       RFT.fused_tick_jit(ref_fused_inputs(fields)),
                       f"stages={stages}")

    def test_batch_autoscaler_fused_tick_fn(self, monkeypatch):
        """poolgroup's TestWireCompat::test_fused_tick_matches_the_chained_path
        with the port's fused_tick as the autoscaler's fused_tick_fn: the
        autoscaler hands it numpy operands. The counts equal the port's
        chained path and the reference's jitted fused tick, tick for
        tick, the repair included."""
        port, ref = _helper("test_poolgroup"), ref_poolgroup

        def world(suite, fused_tick_fn=None):
            store, _, auto, _ = suite._world(
                groups=[suite._serving_group(suite.REPAIR_BAND)]
            )
            auto.fused_tick_fn = fused_tick_fn
            return store, auto

        broken = world(port, FT.fused_tick)
        with monkeypatch.context() as patch:  # the old failure
            patch.setattr(FT, "on_device", lambda inputs: inputs,
                          raising=False)
            with pytest.raises(
                AttributeError, match="'str' object has no attribute 'type'"
            ):
                port._tick(*broken)
        chained = world(port)
        fused = world(port, FT.fused_tick)
        reference = world(ref, jax.jit(RFT.fused_tick))
        for _ in range(3):
            counts = port._tick(*fused)
            assert counts == port._tick(*chained)
            assert counts == ref._tick(*reference)
        assert counts["decode"] == 44


class TestFleetStepHostOperands:
    """The reference's fleet_step is decide + binpack over host arrays;
    the port's places both operand trees on its device first."""

    @pytest.mark.parametrize("seed", [3, 11])
    def test_host_operands_equal_the_reference(self, seed, monkeypatch):
        ref_dec = RMESH.example_decision_inputs(N=32, M=4, seed=seed)
        ref_bp = RMESH.example_binpack_inputs(P_=64, T=8, K=8, L=8,
                                              seed=seed)
        dec = D.DecisionInputs.from_arrays(ref_dec)
        bp = B.BinPackInputs(**{
            f.name: None if getattr(ref_bp, f.name) is None
            else np.asarray(getattr(ref_bp, f.name))
            for f in dataclasses.fields(ref_bp)
        })
        with monkeypatch.context() as patch:  # the parent's placement
            patch.setattr(MESH, "on_device",
                          lambda inputs, device: inputs.to(device),
                          raising=False)
            with pytest.raises(
                AttributeError,
                match="'numpy.ndarray' object has no attribute 'to'",
            ):
                MESH.fleet_step(dec, bp, device="cpu")
        d_out, b_out = MESH.fleet_step(dec, bp, buckets=32, device="cpu")
        want_d, want_b = RMESH.fleet_step(ref_dec, ref_bp, buckets=32)
        assert_bitwise(d_out, want_d, "decide")
        for name in BINPACK_FIELDS:
            got = getattr(b_out, name).numpy()
            want = np.asarray(getattr(want_b, name))
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert got.tobytes() == want.tobytes(), name

    def test_placed_operands_pass_through(self):
        dec, bp = MESH.dryrun_inputs("cpu")
        assert operands.on_device(dec, "cpu") is dec
        assert B.on_device(bp, "cpu") is bp
        moved = operands.on_device(D.DecisionInputs.from_arrays(dec), "cpu")
        assert_bitwise(MESH.decide(moved), MESH.decide(dec), "decide")
