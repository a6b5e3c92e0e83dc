"""The port's disruption path on a CUDA card: the consolidation and
preemption engines behind SolverService() on the card (the cuda rung)
against the same world behind a CPU service. Every test carries the
`cuda` marker and skips without a card (the cuda rung launches CUDA C++
kernels with no interpret mode); on the CPU,
tests/test_torch_consolidation.py and tests/test_torch_preempt.py hold
the torch and numpy rungs against the reference.

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_disruption_cuda.py -q
"""

import threading
import time

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.consolidation import planner as CP
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.ops import preempt as P
from karpenter_tpu_torch.solver import SolverService

pytestmark = pytest.mark.cuda

WORLD = dict(nodes=40, pods=400, pending_critical=6, seed=0)
ROUNDS = 8
FIELDS = ("chosen_node", "evict_count", "evict_mask", "unplaceable")


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cuda rung launches CUDA C++ "
                    "kernels with no interpret mode")


def run_world(svc):
    world = workloads.build_disruption_world(**WORLD, service=svc)
    snaps, errors = [], []
    for _ in range(ROUNDS):
        errors.append({k: None if e is None else type(e).__name__
                       for k, e in world.round().items()})
        snaps.append(world.snapshot())
    return snaps, errors, world.verdicts, world.plans


def test_card_world_equals_the_cpu_torch_rung():
    card = SolverService(registry=GaugeRegistry())
    cpu = SolverService(registry=GaugeRegistry(), device="cpu",
                        backend="torch")
    try:
        got = run_world(card)
        want = run_world(cpu)
        assert got == want
        assert card.stats.fallbacks == 0
        assert card.stats.consolidate_calls >= 2
        assert card.stats.preempt_dispatches == ROUNDS
    finally:
        card.close()
        cpu.close()


def test_consolidate_batch_launches_each_kernel_once_per_candidate():
    svc = SolverService(registry=GaugeRegistry())
    try:
        world = workloads.build_disruption_world(**WORLD, service=svc)
        view = CP.cluster_view(world.store)
        names = [nv.name for nv in view.nodes]
        solved, inputs, _ = CP.build_problems(view, names)
        assert len(inputs) >= 8
        torch.cuda.synchronize()
        TF.reset_launch_counts()
        got = svc.consolidate(inputs)
        assert TF.LAUNCHES == {"fused_assign": len(inputs),
                               "shelf_bfd": len(inputs), "demand_reduce": 0,
                               "pack_bits": len(inputs)}
        cpu = SolverService(registry=GaugeRegistry(), device="cpu",
                            backend="torch")
        try:
            want = cpu.consolidate(inputs)
        finally:
            cpu.close()
        for name, a, b in zip(solved, got, want):
            for field in ("assigned", "assigned_count", "nodes_needed",
                          "unschedulable"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, field)),
                    np.asarray(getattr(b, field)), err_msg=f"{name}:{field}",
                )
        assert svc.stats.dispatches == len(inputs)
    finally:
        svc.close()


def test_solve_beside_a_waiting_batch():
    """A 67-candidate consolidate batch (the engine's 64 plus re-verified
    nodes) waiting behind a running dispatch takes one slot of the
    default queue: a solve() beside it is admitted on the card."""
    from karpenter_tpu_torch.faults import FaultRegistry

    svc = SolverService(registry=GaugeRegistry())
    try:
        world = workloads.build_disruption_world(**WORLD, service=svc)
        view = CP.cluster_view(world.store)
        _, inputs, _ = CP.build_problems(view, [nv.name for nv in view.nodes])
        batch = [inputs[i % len(inputs)] for i in range(67)]
        out = {}
        with FaultRegistry() as reg:
            reg.plan("solver.dispatch", mode="latency", latency_s=1.0,
                     times=1)
            first = threading.Thread(
                target=lambda: out.setdefault("first", svc.solve(inputs[0])))
            first.start()
            deadline = time.monotonic() + 30.0
            while reg.injected.get("solver.dispatch", 0) < 1:
                assert time.monotonic() < deadline
                time.sleep(0.001)
            drain = threading.Thread(
                target=lambda: out.setdefault("batch",
                                              svc.consolidate(batch)))
            drain.start()
            while svc.queue_depth() < len(batch):
                assert time.monotonic() < deadline
                time.sleep(0.001)
            got = svc.solve(inputs[1])
            first.join(30.0)
            drain.join(30.0)
        assert svc.stats.rejected == svc.stats.fallbacks == 0
        assert len(out["batch"]) == len(batch)
        np.testing.assert_array_equal(np.asarray(got.assigned),
                                      np.asarray(out["batch"][1].assigned))
    finally:
        svc.close()


def test_preempt_seam_at_the_victim_ceiling_equals_the_mirror():
    inputs = workloads.build_preempt_inputs(64, 2000, 16384, seed=0)
    svc = SolverService(registry=GaugeRegistry())
    try:
        got = svc.preempt(inputs)
        want = P.preempt_numpy(inputs)
        for field in FIELDS:
            assert np.array_equal(np.asarray(getattr(got, field)),
                                  np.asarray(getattr(want, field))), field
        assert np.asarray(got.chosen_node).dtype == np.int32
        assert svc.stats.preempt_dispatches == 1
    finally:
        svc.close()
