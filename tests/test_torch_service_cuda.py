"""The port's solve service on a CUDA card: the `cuda` rung (both
hand-written kernels through ops/binpack.solve(backend="cuda")) against
the `torch` rung and the `numpy` rung, on the same inputs. Every test
carries the `cuda` marker and skips without a card (a CUDA kernel has no
interpret mode); on the CPU, tests/test_torch_solver_service.py holds the
torch and numpy rungs against the reference's service.

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_service_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.solver import SolverService

pytestmark = pytest.mark.cuda

OUTPUT_FIELDS = (
    "assigned", "assigned_count", "nodes_needed", "lp_bound", "unschedulable"
)


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cuda rung launches CUDA C++ "
                    "kernels with no interpret mode")


def make_inputs(seed, pods, types, resources=3, taints=16, labels=16,
                **optional):
    """Integer-valued requests, so every float sum is exact."""
    rng = np.random.default_rng(seed)
    fields = dict(
        pod_requests=rng.integers(1, 8, (pods, resources)).astype(np.float32),
        pod_valid=rng.random(pods) > 0.05,
        pod_intolerant=rng.random((pods, taints)) < 0.05,
        pod_required=rng.random((pods, labels)) < 0.03,
        group_allocatable=rng.choice(
            [8, 16, 32, 64], (types, resources)).astype(np.float32),
        group_taints=rng.random((types, taints)) < 0.1,
        group_labels=rng.random((types, labels)) < 0.8,
    )
    if optional.get("weight"):
        fields["pod_weight"] = rng.integers(1, 5, pods).astype(np.int32)
    if optional.get("score"):
        fields["pod_group_score"] = rng.integers(
            0, 3, (pods, types)).astype(np.float32)
    if optional.get("forbidden"):
        fields["pod_group_forbidden"] = rng.random((pods, types)) < 0.2
    if optional.get("exclusive"):
        fields["pod_exclusive"] = rng.random(pods) < 0.1
    return TB.BinPackInputs(**fields)


def assert_equal(got, want, what=""):
    for name in OUTPUT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=f"{what}{name}",
        )


@pytest.mark.parametrize("resources", [3, 4])
@pytest.mark.parametrize(
    "optional",
    [{}, {"weight": True}, {"weight": True, "score": True,
                            "forbidden": True, "exclusive": True}],
    ids=["plain", "weight", "all"],
)
def test_cuda_rung_equals_torch_and_numpy_rungs(resources, optional):
    svc = SolverService(registry=GaugeRegistry())
    try:
        assert svc.device.type == "cuda"
        for pods, types in ((17, 3), (300, 12), (2000, 40)):
            inputs = make_inputs(pods + types, pods, types, resources,
                                 **optional)
            TF.reset_launch_counts()
            cuda = svc.solve(inputs)  # auto on the card: the cuda rung
            assert TF.LAUNCHES == {"fused_assign": 1, "shelf_bfd": 1,
                                   "demand_reduce": 0, "pack_bits": 1}
            assert_equal(cuda, svc.solve(inputs, backend="torch"), "torch ")
            assert_equal(cuda, svc.solve(inputs, backend="numpy"), "numpy ")
        assert svc.stats.fallbacks == 0
        assert svc.backend_health() == "healthy"
    finally:
        svc.close()


def test_torch_rung_resident_scatter_equals_cold_on_the_card():
    """On CUDA tensors the auto gate engages the scatter rung; a churned
    successor's resident tensors equal the padded cold upload bitwise.
    The operands are at their bucket widths (R = 4, K = 32, L = 64), as
    the encoder emits them: the scatter splices whole rows, and a narrower
    host row rebuilds instead, as in the reference."""
    from karpenter_tpu_torch.solver.bucketing import pad_to_bucket

    class Plan:
        def __init__(self, prev, rows):
            self.prev = prev
            self.rows = np.asarray(rows, np.int32)
            self.weight_rows = np.zeros(0, np.int32)

    first = make_inputs(1, 500, 20, resources=4, taints=32, labels=64,
                        weight=True)
    changed = np.array([3, 77, 401])
    second = dataclasses.replace(
        first, pod_requests=first.pod_requests.copy())
    second.pod_requests[changed] += 1.0
    svc = SolverService(registry=GaugeRegistry(), backend="torch")
    cold = SolverService(registry=GaugeRegistry(), backend="torch",
                         resident=False)
    try:
        import karpenter_tpu_torch.solver.resident as R

        plans = {id(second): Plan(first, changed)}
        real = R._plan_for
        R._plan_for = lambda inputs: plans.get(id(inputs))
        try:
            assert_equal(svc.solve(first), cold.solve(first))
            assert_equal(svc.solve(second), cold.solve(second))
        finally:
            R._plan_for = real
        assert svc.stats.resident_scatters == 1
        entry = next(iter(svc._resident._entries.values()))
        assert entry.host is second
        padded = pad_to_bucket(second, entry.shape)
        for f in dataclasses.fields(padded):
            want = getattr(padded, f.name)
            if want is None:
                continue
            got = getattr(entry.stacked, f.name)[0].cpu().numpy()
            assert got.tobytes() == np.asarray(want).tobytes(), f.name
    finally:
        svc.close()
        cold.close()
