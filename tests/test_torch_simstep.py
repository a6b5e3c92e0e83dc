"""The port's SimLab stepping programs (karpenter_tpu_torch/ops/simstep.py)
and the service's sim families against the reference's, on the CPU.

  * sim_step and sim_rollout (unbatched, and batched over a leading
    cluster axis) equal the reference's sim_step_jit, sim_rollout_jit and
    sim_rollout_vmapped and both packages' numpy mirrors, bitwise on every
    output field, on seeded trails: faults, price spikes, knobs at zero,
    per-cluster knobs, and raw draws the trail generator never makes;
  * SolverService.sim_step / sim_rollout: one dispatch for B clusters,
    the reference service's answers, the CPU's never-block ladder (a
    failure serves the mirror and counts toward the FSM), and the card's
    policy (a failure raises, a degraded FSM raises SolverDeviceError, the
    mirror answers only when numpy is named), held on a CPU service with
    the card's policy set, as TestCardFailurePolicy does elsewhere.

The reference runs as its own tests run it (JAX on the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu.faults.registry import injected_faults as ref_faults
from karpenter_tpu.metrics.registry import GaugeRegistry as RefRegistry
from karpenter_tpu.ops import simstep as RSK
from karpenter_tpu.solver.service import SolverService as RefService
from karpenter_tpu_torch import faults
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.ops import simstep as SK
from karpenter_tpu_torch.simlab.builtin import make_trails
from karpenter_tpu_torch.simlab.env import SimParams
from karpenter_tpu_torch.simlab.policy import FROZEN_KNOBS, REACTIVE_KNOBS
from karpenter_tpu_torch.solver.service import SolverDeviceError, SolverService
from karpenter_tpu_torch.utils.operands import host_seam

F32 = np.float32
ROLLOUT_FIELDS = ("replicas", "streak", "violation", "cost", "backlog",
                  "target")
STEP_FIELDS = ("replicas", "violation", "cost", "backlog")


def scalars(p: SimParams = SimParams()) -> dict:
    return {
        "cap": F32(p.cap), "hourly": F32(p.hourly),
        "step_limit": F32(p.step_limit),
        "min_replicas": F32(p.min_replicas),
        "max_replicas": F32(p.max_replicas),
    }


def batched_inputs(seeds, knobs, ticks=32, rows=4, **theme):
    theme = theme or dict(diurnal=True, amplitude=40.0, price_spike=1.5,
                          fault_probability=0.2)
    trails = [make_trails(s, ticks=ticks, rows=rows, **theme) for s in seeds]
    knobs = np.asarray(knobs, F32)
    if knobs.ndim == 1:
        knobs = np.broadcast_to(knobs, (len(trails), SK.KNOBS)).copy()
    return RSK.SimRolloutInputs(
        replicas0=np.stack([t.replicas0 for t in trails]),
        streak0=np.zeros((len(trails), rows), F32),
        demand=np.stack([t.demand for t in trails]),
        forecast=np.stack([t.forecast for t in trails]),
        price=np.stack([t.price for t in trails]),
        fault=np.stack([t.fault for t in trails]),
        knobs=knobs,
        **scalars(),
    )


def raw_inputs(seed, clusters=5, ticks=24, rows=6):
    """Draws make_trails never makes: fractional replicas and demand,
    streaks already running, spiky prices, dense faults, mixed knobs."""
    r = np.random.default_rng(seed)
    return RSK.SimRolloutInputs(
        replicas0=(r.random((clusters, rows)) * 70 - 3).astype(F32),
        streak0=r.integers(0, 4, (clusters, rows)).astype(F32),
        demand=(r.random((clusters, ticks, rows)) * 300).astype(F32),
        forecast=(r.random((clusters, ticks, rows)) * 300).astype(F32),
        price=(1 + r.random((clusters, ticks)) * 3).astype(F32),
        fault=(r.random((clusters, ticks)) < 0.4).astype(F32),
        knobs=np.stack([r.random(clusters) * 1.5, r.random(clusters),
                        r.integers(0, 6, clusters)], axis=1).astype(F32),
        cap=F32(3.5), hourly=F32(0.7), step_limit=F32(2.5),
        min_replicas=F32(1.0), max_replicas=F32(48.0),
    )


def assert_equal(got, want, fields, what, index=None):
    for name in fields:
        a = np.asarray(getattr(got, name))
        b = np.asarray(getattr(want, name))
        if index is not None:
            a = a[index]
        assert a.dtype == b.dtype == np.float32, (what, name)
        assert a.shape == b.shape, (what, name)
        assert a.tobytes() == b.tobytes(), f"{what}: field {name} differs"


def run_rollout(inputs):
    return host_seam(SK.sim_rollout, SK.SimRolloutInputs, "cpu")(inputs)


def run_step(inputs):
    return host_seam(SK.sim_step, SK.SimStepInputs, "cpu")(inputs)


ROLLOUT_CASES = {
    "frozen": lambda: batched_inputs(range(20, 24), FROZEN_KNOBS),
    "reactive": lambda: batched_inputs(range(30, 33), REACTIVE_KNOBS),
    "grid_corner": lambda: batched_inputs(range(40, 43), (1.25, 1.0, 4.0)),
    "per_cluster_knobs": lambda: batched_inputs(
        range(50, 54), [(0, 0, 0), (1, 0.5, 2), (0.5, 1, 4), (1.25, 0.25, 0)]),
    "spikes_and_faults": lambda: batched_inputs(
        range(60, 63), FROZEN_KNOBS, ticks=40, rows=6, spike=30.0,
        price_spike=2.0, fault_probability=0.5),
    "raw_draw": lambda: raw_inputs(7),
}


class TestRolloutParity:
    @pytest.mark.parametrize("case", sorted(ROLLOUT_CASES))
    def test_batched_equals_vmapped_and_mirrors(self, case):
        inputs = ROLLOUT_CASES[case]()
        got = run_rollout(inputs)
        assert_equal(got, RSK.sim_rollout_vmapped(inputs), ROLLOUT_FIELDS,
                     "port vs sim_rollout_vmapped")
        assert_equal(got, RSK.sim_rollout_numpy(inputs), ROLLOUT_FIELDS,
                     "port vs the reference's mirror")
        assert_equal(got, SK.sim_rollout_numpy(inputs), ROLLOUT_FIELDS,
                     "port vs its own mirror")

    @pytest.mark.parametrize("case", sorted(ROLLOUT_CASES))
    def test_each_cluster_unbatched_equals_its_row_and_jit(self, case):
        inputs = ROLLOUT_CASES[case]()
        batched = run_rollout(inputs)
        for b in range(np.asarray(inputs.replicas0).shape[0]):
            one = SK._cluster_slice(inputs, b)
            solo = run_rollout(one)
            assert_equal(batched, solo, ROLLOUT_FIELDS, f"cluster {b}", b)
            assert_equal(solo,
                         RSK.sim_rollout_jit(RSK._cluster_slice(inputs, b)),
                         ROLLOUT_FIELDS,
                         f"cluster {b} vs sim_rollout_jit")

    def test_tensor_program_on_tensors(self):
        inputs = ROLLOUT_CASES["frozen"]()
        dev = SK.SimRolloutInputs.from_numpy(inputs, "cpu")
        out = SK.sim_rollout_vmapped(dev)
        assert isinstance(out.violation, torch.Tensor)
        assert tuple(out.violation.shape) == np.asarray(inputs.demand).shape
        assert_equal(SK.SimRolloutOutputs.from_arrays(out.to_numpy()),
                     RSK.sim_rollout_numpy(inputs), ROLLOUT_FIELDS, "tensors")

    def test_vmapped_takes_batched_trails_only(self):
        one = SK._cluster_slice(ROLLOUT_CASES["frozen"](), 0)
        with pytest.raises(ValueError, match="batched"):
            SK.sim_rollout_vmapped(SK.SimRolloutInputs.from_numpy(one, "cpu"))

    def test_the_mirror_is_the_reference_copy(self):
        inputs = raw_inputs(11, clusters=2, ticks=8, rows=3)
        assert_equal(SK.sim_rollout_numpy(inputs),
                     RSK.sim_rollout_numpy(inputs), ROLLOUT_FIELDS, "mirror")
        step = RSK.SimStepInputs(
            replicas=inputs.replicas0, target=inputs.demand[:, 0],
            demand=inputs.demand[:, 1], price=inputs.price[:, 0],
            fault=inputs.fault[:, 0], cap=inputs.cap, hourly=inputs.hourly,
            step_limit=inputs.step_limit, min_replicas=inputs.min_replicas,
            max_replicas=inputs.max_replicas,
        )
        assert_equal(SK.sim_step_numpy(step), RSK.sim_step_numpy(step),
                     STEP_FIELDS, "step mirror")


def step_cases():
    trails = make_trails(1, ticks=8, rows=6, spike=30.0, price_spike=2.0,
                         fault_probability=0.5)
    for t in range(4):
        yield f"tick{t}", RSK.SimStepInputs(
            replicas=trails.replicas0, target=trails.demand[t] / F32(2.0),
            demand=trails.demand[t], price=np.asarray(trails.price[t]),
            fault=np.asarray(trails.fault[t]), **scalars(),
        )
    batch = [make_trails(10 + i, ticks=4, rows=5) for i in range(3)]
    yield "batched", RSK.SimStepInputs(
        replicas=np.stack([t.replicas0 for t in batch]),
        target=np.stack([t.demand[0] for t in batch]),
        demand=np.stack([t.demand[0] for t in batch]),
        price=np.stack([t.price[0] for t in batch]),
        fault=np.stack([t.fault[0] for t in batch]), **scalars(),
    )
    raw = raw_inputs(3)
    yield "raw_batched", RSK.SimStepInputs(
        replicas=raw.replicas0, target=raw.forecast[:, 2] / F32(3.0) - 5,
        demand=raw.demand[:, 2], price=raw.price[:, 2], fault=raw.fault[:, 2],
        cap=raw.cap, hourly=raw.hourly, step_limit=raw.step_limit,
        min_replicas=raw.min_replicas, max_replicas=raw.max_replicas,
    )


STEP_CASES = dict(step_cases())


class TestStepParity:
    @pytest.mark.parametrize("case", sorted(STEP_CASES))
    def test_step_equals_jit_and_mirrors(self, case):
        inputs = STEP_CASES[case]
        got = run_step(inputs)
        assert_equal(got, RSK.sim_step_jit(inputs), STEP_FIELDS, "jit")
        assert_equal(got, RSK.sim_step_numpy(inputs), STEP_FIELDS, "mirror")
        assert_equal(got, SK.sim_step_numpy(inputs), STEP_FIELDS,
                     "own mirror")

    def test_fault_holds_replicas(self):
        inputs = dataclasses.replace(
            STEP_CASES["batched"],
            fault=np.ones(3, F32),
        )
        out = run_step(inputs)
        np.testing.assert_array_equal(
            out.replicas,
            np.clip(inputs.replicas, inputs.min_replicas,
                    inputs.max_replicas))


# -- the service seam ------------------------------------------------------


@pytest.fixture
def svc():
    service = SolverService(registry=GaugeRegistry(), device="cpu")
    try:
        yield service
    finally:
        service.close()


def card_policy(service):
    """A CPU service with the card's failure policy (no numpy ladder)."""
    service._numpy_ladder = False
    service.on_timeout = "raise"
    return service


class TestServiceSeam:
    def test_one_dispatch_for_b_clusters(self, svc):
        inputs = batched_inputs(range(30, 34), FROZEN_KNOBS)
        batched = svc.sim_rollout(inputs, backend="torch")
        assert (svc.stats.sim_calls, svc.stats.sim_dispatches,
                svc.stats.sim_mirror_serves) == (1, 1, 0)
        for b in range(4):
            solo = svc.sim_rollout(SK._cluster_slice(inputs, b),
                                   backend="torch")
            assert_equal(batched, solo, ROLLOUT_FIELDS, f"cluster {b}", b)
        assert (svc.stats.sim_calls, svc.stats.sim_dispatches) == (5, 5)
        assert svc.stats.dispatches == 5
        assert "sim" in svc.stage_percentiles()

    def test_answers_equal_the_reference_service(self, svc):
        ref = RefService(registry=RefRegistry())
        try:
            inputs = batched_inputs(range(70, 73), FROZEN_KNOBS)
            assert_equal(svc.sim_rollout(inputs, backend="torch"),
                         ref.sim_rollout(inputs, backend="xla"),
                         ROLLOUT_FIELDS, "rollout")
            step = STEP_CASES["batched"]
            assert_equal(svc.sim_step(step, backend="torch"),
                         ref.sim_step(step, backend="xla"), STEP_FIELDS,
                         "step")
        finally:
            ref.close()

    def test_auto_on_the_cpu_serves_the_mirror(self, svc):
        inputs = batched_inputs(range(80, 82), FROZEN_KNOBS)
        out = svc.sim_rollout(inputs)
        assert (svc.stats.sim_dispatches, svc.stats.sim_mirror_serves) == (0, 1)
        assert_equal(out, RSK.sim_rollout_numpy(inputs), ROLLOUT_FIELDS,
                     "numpy rung")

    def test_cuda_backend_needs_a_card(self, svc):
        with pytest.raises(ValueError, match="CUDA device"):
            svc.sim_step(STEP_CASES["batched"], backend="cuda")

    def test_tensor_operands(self, svc):
        inputs = batched_inputs(range(90, 92), FROZEN_KNOBS)
        tensors = SK.SimRolloutInputs.from_numpy(inputs, "cpu")
        assert_equal(svc.sim_rollout(tensors, backend="torch"),
                     RSK.sim_rollout_numpy(inputs), ROLLOUT_FIELDS, "torch")

    def test_device_solver_leaves_sim_to_numpy(self):
        service = SolverService(registry=GaugeRegistry(), device="cpu",
                                device_solver=lambda *a, **k: None)
        try:
            out = service.sim_step(STEP_CASES["tick0"], backend="torch")
            assert service.stats.sim_mirror_serves == 1
            assert_equal(out, RSK.sim_step_numpy(STEP_CASES["tick0"]),
                         STEP_FIELDS, "mirror")
        finally:
            service.close()


class TestCpuLadder:
    def test_failure_serves_the_bit_identical_mirror(self, svc):
        inputs = batched_inputs(range(40, 43), REACTIVE_KNOBS)
        with faults.injected_faults(seed=5) as reg:
            reg.plan("simlab.step", mode="error", probability=1.0)
            out = svc.sim_rollout(inputs, backend="torch")
        assert (svc.stats.sim_mirror_serves, svc.stats.sim_dispatches) == (1, 0)
        assert svc.stats.device_failures == 1
        assert_equal(out, RSK.sim_rollout_numpy(inputs), ROLLOUT_FIELDS,
                     "mirror")

    def test_same_accounting_as_the_reference(self, svc):
        inputs = batched_inputs(range(40, 43), REACTIVE_KNOBS)
        ref = RefService(registry=RefRegistry())
        try:
            with ref_faults(seed=5) as reg:
                reg.plan("simlab.step", mode="error", probability=1.0)
                for _ in range(4):
                    ref.sim_rollout(inputs, backend="xla")
            with faults.injected_faults(seed=5) as reg:
                reg.plan("simlab.step", mode="error", probability=1.0)
                for _ in range(4):
                    svc.sim_rollout(inputs, backend="torch")
            for name in ("sim_calls", "sim_dispatches", "sim_mirror_serves",
                         "device_failures", "fsm_trips"):
                assert getattr(svc.stats, name) == getattr(ref.stats, name), name
            assert svc.backend_health() == ref.backend_health() == "degraded"
        finally:
            ref.close()


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


class TestCardFailurePolicy:
    def _svc(self):
        clock = FakeClock()
        service = card_policy(SolverService(
            registry=GaugeRegistry(), device="cpu", clock=clock,
            health_failure_threshold=2, health_probe_interval_s=30.0,
        ))
        return service, clock

    def test_failure_raises_then_degraded_raises_then_probe_heals(self):
        service, clock = self._svc()
        inputs = batched_inputs(range(40, 42), FROZEN_KNOBS)
        try:
            raised = []
            with faults.injected_faults(seed=3) as reg:
                reg.plan("simlab.step", mode="error")
                for call in (
                    lambda: service.sim_step(STEP_CASES["batched"],
                                             backend="torch"),
                    lambda: service.sim_rollout(inputs, backend="torch"),
                    lambda: service.sim_rollout(inputs, backend="torch"),
                ):
                    with pytest.raises(Exception) as info:
                        call()
                    raised.append(type(info.value).__name__)
            assert raised == ["FaultInjected", "FaultInjected",
                              "SolverDeviceError"]
            assert service.stats.sim_mirror_serves == 0
            assert service.backend_health() == "degraded"
            with pytest.raises(SolverDeviceError):
                service.sim_rollout(inputs, backend="torch")
            clock.now += 31.0
            out = service.sim_rollout(inputs, backend="torch")
            assert service.backend_health() == "healthy"
            assert service.stats.sim_mirror_serves == 0
            assert_equal(out, RSK.sim_rollout_numpy(inputs), ROLLOUT_FIELDS,
                         "probe")
        finally:
            service.close()

    def test_numpy_named_is_the_only_mirror_serve(self):
        service, _ = self._svc()
        try:
            with faults.injected_faults(seed=3) as reg:
                reg.plan("simlab.step", mode="error")
                out = service.sim_step(STEP_CASES["tick1"], backend="numpy")
            assert service.stats.sim_mirror_serves == 1
            assert service.stats.device_failures == 0
            assert_equal(out, RSK.sim_step_numpy(STEP_CASES["tick1"]),
                         STEP_FIELDS, "numpy")
        finally:
            service.close()
