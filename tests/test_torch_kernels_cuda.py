"""The port's compiled CUDA kernels vs their plain PyTorch versions, on a
CUDA card. Every test carries the `cuda` marker and skips without a card
(a CUDA kernel has no interpret mode); on the CPU the plain versions are
held against the JAX reference by tests/test_torch_fused_assign.py.

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops import fused_assign as TF

pytestmark = pytest.mark.cuda

OUTPUT_FIELDS = (
    "assigned", "assigned_count", "nodes_needed", "lp_bound", "unschedulable"
)


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no "
                    "interpret mode")


def random_fields(rng, pods, types, taints=8, labels=8):
    alloc = rng.uniform(1.0, 64.0, (types, 3)).astype(np.float32)
    alloc[rng.random(types) < 0.1] = 0.0
    return {
        "pod_requests": rng.uniform(0.05, 8.0, (pods, 3)).astype(np.float32),
        "pod_valid": rng.random(pods) > 0.05,
        "pod_intolerant": rng.random((pods, taints)) < 0.1,
        "pod_required": rng.random((pods, labels)) < 0.05,
        "group_allocatable": alloc,
        "group_taints": rng.random((types, taints)) < 0.15,
        "group_labels": rng.random((types, labels)) < 0.8,
        "pod_weight": rng.integers(1000, 5000, pods).astype(np.int32),
    }


@pytest.mark.parametrize(
    "operand", ["none", "score", "forbidden", "exclusive"]
)
def test_fused_kernel_matches_plain(operand):
    rng = np.random.default_rng(8)
    fields = random_fields(rng, 512, 24)
    if operand == "score":
        fields["pod_group_score"] = rng.integers(0, 100, (512, 24)).astype(
            np.float32
        )
    elif operand == "forbidden":
        fields["pod_group_forbidden"] = rng.random((512, 24)) < 0.3
    elif operand == "exclusive":
        fields["pod_exclusive"] = rng.random(512) < 0.3
    inputs = TB.inputs_from_numpy(fields, "cuda")
    before = TF.LAUNCHES["fused_assign"]
    got = TF.fused_assign(inputs, 16)
    assert TF.LAUNCHES["fused_assign"] == before + 1
    assert_stage_equal(got, TF.fused_assign_reference(inputs, 16))


def assert_stage_equal(got, want):
    """Kernel vs plain fused stage: assigned, hist and unschedulable exact,
    demand within rtol 1e-5 (f64 sums in another order, rounded once)."""
    torch.cuda.synchronize()
    (a, h, d, u), (ra, rh, rd, ru) = got, want
    assert torch.equal(a, ra) and torch.equal(h, rh) and torch.equal(u, ru)
    torch.testing.assert_close(d, rd, rtol=1e-5, atol=0.0)


def test_fused_kernel_multi_word_and_ragged():
    rng = np.random.default_rng(9)
    fields = random_fields(rng, 777, 53, taints=70, labels=130)
    fields["pod_group_score"] = rng.integers(0, 5, (777, 53)).astype(
        np.float32
    )
    inputs = TB.inputs_from_numpy(fields, "cuda")
    assert_stage_equal(
        TF.fused_assign(inputs, 32), TF.fused_assign_reference(inputs, 32)
    )


@pytest.mark.parametrize(
    "groups,taints", [(2000, 64), (2000, 512), (4096, 64)]
)
def test_fused_kernel_past_the_old_group_limit(groups, taints):
    """T = 2,000 and 4,096 run through the kernel (past 1,447 groups):
    the narrow instance's records in shared memory (2000 x 64) and the
    generic instance's group side from global memory (2000 x 512,
    4096 x 64)."""
    fields = workloads.build_inputs(3000, groups, taints, taints, seed=7)
    fields["pod_weight"] = np.random.default_rng(7).integers(
        1, 5000, 3000
    ).astype(np.int32)
    inputs = TB.inputs_from_numpy(fields, "cuda")
    words = -(-taints // 64)
    plan = TF.fused_assign_plan(3000, groups, 3, words, words, 32)
    assert plan.narrow == (groups * taints == 2000 * 64)
    assert_stage_equal(
        TF.fused_assign(inputs, 32), TF.fused_assign_reference(inputs, 32)
    )


def test_fused_demand_is_bitwise_stable():
    """No float atomics: two launches on the same inputs give the same
    demand bits."""
    fields = workloads.build_inputs(20000, 300, 64, 64, seed=3)
    fields["pod_weight"] = np.random.default_rng(3).integers(
        1000, 5000, 20000
    ).astype(np.int32)
    inputs = TB.inputs_from_numpy(fields, "cuda")
    first = TF.fused_assign(inputs, 32)[2].clone()
    second = TF.fused_assign(inputs, 32)[2]
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.parametrize("buckets", [1, 8, 32, 33, 64])
def test_shelf_kernel_matches_plain(buckets):
    hist = torch.from_numpy(
        np.random.default_rng(4).integers(0, 400, (300, buckets)).astype(np.int32)
    ).cuda()
    before = TF.LAUNCHES["shelf_bfd"]
    nodes, count = TF.shelf_bfd(hist, buckets)
    want_nodes, want_count = TF.shelf_bfd_reference(hist, buckets)
    assert torch.equal(nodes, want_nodes) and torch.equal(count, want_count)
    assert TF.LAUNCHES["shelf_bfd"] == before + 1


def test_solve_cuda_matches_torch_and_cpu():
    fields = workloads.build_inputs(5000, 300, 64, 64, seed=1)
    inputs = TB.inputs_from_numpy(fields, "cuda")
    fused = TB.solve(inputs, backend="cuda")
    plain = TB.solve(inputs, backend="torch")
    cpu = TB.solve(
        TB.inputs_from_numpy(fields, "cpu"), backend="torch", device="cpu"
    )
    for name in OUTPUT_FIELDS:
        assert torch.equal(getattr(fused, name), getattr(plain, name)), name
        assert torch.equal(getattr(fused, name).cpu(), getattr(cpu, name)), name


def test_wrapper_rejects_bad_operands_on_card():
    fields = random_fields(np.random.default_rng(3), 64, 8)
    inputs = TB.inputs_from_numpy(fields, "cuda")
    inputs.pod_requests = inputs.pod_requests.t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        TF.fused_assign(inputs, 8)
    with pytest.raises(ValueError, match="histogram"):
        TF.shelf_bfd(torch.zeros((4, 8), dtype=torch.int64, device="cuda"), 8)


@pytest.mark.parametrize("invert", [False, True], ids=["plain", "invert"])
@pytest.mark.parametrize("rows", [1, 7, 513, 100_000])
@pytest.mark.parametrize("k", [0, 1, 15, 16, 63, 64, 65, 130, 512])
def test_pack_kernel_matches_plain(k, rows, invert):
    """pack_masks on the card == the plain pack_bits, bit for bit: the
    row-contiguous path (K a multiple of 16) and the general one."""
    mask = torch.rand((rows, k), device="cuda") < 0.5
    before = TF.LAUNCHES["pack_bits"]
    (got,) = TF.pack_masks([mask], [invert])
    assert TF.LAUNCHES["pack_bits"] == before + 1
    want = TF.pack_bits(~mask if invert else mask)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want)


def test_pack_kernel_packs_four_masks_in_one_launch():
    """Four masks of different shapes, the third empty and the last on an
    unaligned base (K a multiple of 16 there, so the general path): one
    launch, each mask's words the plain version's."""
    base = torch.rand(3000 * 48 + 1, device="cuda") < 0.3
    masks = [torch.rand((2049, 64), device="cuda") < 0.5,
             torch.rand((300, 130), device="cuda") < 0.5,
             torch.zeros((0, 64), dtype=torch.bool, device="cuda"),
             base[1:].view(3000, 48)]
    assert masks[3].data_ptr() % 16 != 0
    invert = (False, True, False, True)
    before = TF.LAUNCHES["pack_bits"]
    got = TF.pack_masks(masks, invert)
    assert TF.LAUNCHES["pack_bits"] == before + 1
    torch.cuda.synchronize()
    for words, mask, inv in zip(got, masks, invert):
        assert torch.equal(words, TF.pack_bits(~mask if inv else mask))


def test_each_solve_packs_once_a_repeat_included():
    fields = workloads.build_inputs(5000, 300, 64, 64, seed=2)
    inputs = TB.inputs_from_numpy(fields, "cuda")
    before = TF.LAUNCHES["pack_bits"]
    first = TB.solve(inputs, backend="cuda")
    assert TF.LAUNCHES["pack_bits"] == before + 1
    again = TB.solve(inputs, backend="cuda")
    assert TF.LAUNCHES["pack_bits"] == before + 2
    words, words_again = TF.pack_operands(inputs), TF.pack_operands(inputs)
    assert TF.LAUNCHES["pack_bits"] == before + 4
    assert all(torch.equal(a, b) for a, b in zip(words, words_again))
    for name in OUTPUT_FIELDS:
        assert torch.equal(getattr(first, name), getattr(again, name)), name
