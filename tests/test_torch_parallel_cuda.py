"""The shard route on a CUDA card. Every test carries the `cuda` marker and
skips without a card (the sharded solve's card route launches the CUDA
C++ kernels of csrc/fused_assign.cu and csrc/shelf_bfd.cu, which have no
interpret mode); on the CPU, tests/test_torch_parallel.py holds the mesh
against the reference.

The shards are virtual copies of the card (utils/device.
force_virtual_devices): one device runs every shard's kernels, so every
partition, slab, gather and reduction of a real mesh runs. Tolerance:
bitwise on every output.

  * the split host entry (fused_assign_scan + demand_reduce, slab by slab
    into views of one buffer) equals fused_assign_launch bitwise;
  * a sharded solve equals the single-device cuda solve at T = 2,000 and
    P = 4,096 on 2, 3 and 8 shards, with one scan per non-empty row slab,
    one reduction and one shelf launch per non-empty group slab; at
    P = 33 seven of eight row slabs are empty and launch nothing;
  * SolverService() on the card with shard_threshold=1 routes a solve
    through the mesh and answers the same bits, nothing from numpy.

This file imports neither jax nor the reference package:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_parallel_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.parallel import mesh as PM
from karpenter_tpu_torch.utils import device as UD

pytestmark = pytest.mark.cuda

OUTPUTS = ("assigned", "assigned_count", "nodes_needed", "lp_bound",
           "unschedulable")


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sharded solve launches CUDA C++ "
                    "kernels with no interpret mode")
    UD.force_virtual_devices(8, "cuda")
    yield
    UD.reset_virtual_devices()


def wide_inputs(seed=1):
    fields = workloads.build_inputs(pods=4096, types=2000, taints=64,
                                    labels=64, seed=seed)
    fields["pod_weight"] = np.random.default_rng(seed).integers(
        1, 50, 4096).astype(np.int32)
    return TB.inputs_from_numpy(fields, "cuda")


def test_split_entry_equals_the_fused_launch():
    inputs = wide_inputs()
    assigned, hist, demand, unsched = TF.fused_assign(inputs, 32)
    n_pods, n_res = inputs.pod_requests.shape
    n_groups = inputs.group_allocatable.shape[0]
    bufs = TF.scan_buffers(n_pods, n_groups, n_res, 32, inputs.pod_requests.device)
    words = TF.pack_operands(inputs)
    hists = []
    TF.reset_launch_counts()
    for start, stop in PM.slab_bounds(n_pods, 3, TF.ROWS_PER_BLOCK):
        b0, b1 = start // TF.ROWS_PER_BLOCK, -(-stop // TF.ROWS_PER_BLOCK)
        rows = dataclasses.replace(inputs, **{
            name: getattr(inputs, name)[start:stop]
            for name in ("pod_requests", "pod_valid", "pod_intolerant",
                         "pod_required", "pod_weight")})
        slab_words = (words[0][start:stop], words[1][start:stop],
                      words[2], words[3])
        out = (bufs[0][start:stop], torch.empty_like(hist),
               bufs[2][b0:b1], bufs[3][b0:b1])
        hists.append(TF.fused_assign_scan(rows, 32, slab_words, out)[1])
    got_demand, got_unsched = TF.demand_reduce(bufs[2], bufs[3])
    torch.cuda.synchronize()
    # the slabs' words were packed above, before the counts were reset
    assert TF.LAUNCHES == {"fused_assign": 3, "shelf_bfd": 0,
                           "demand_reduce": 1, "pack_bits": 0}
    assert torch.equal(bufs[0], assigned)
    assert torch.equal(torch.stack(hists).sum(0, dtype=torch.int32), hist)
    assert got_demand.cpu().numpy().tobytes() == demand.cpu().numpy().tobytes()
    assert int(got_unsched) == int(unsched)


@pytest.mark.parametrize("n_devices", [2, 3, 8])
def test_sharded_solve_equals_single_device(n_devices):
    inputs = wide_inputs(seed=n_devices)
    single = TB.solve(inputs, buckets=32, backend="cuda")
    mesh = PM.build_mesh(n_devices=n_devices)
    want = {**PM.launch_plan(PM.shard_binpack_inputs(mesh, inputs)),
            "pack_bits": 1}
    TF.reset_launch_counts()
    out = PM.sharded_binpack(mesh, inputs, 32, backend="cuda")
    torch.cuda.synchronize()
    assert TF.LAUNCHES == want, (TF.LAUNCHES, want)
    assert want["demand_reduce"] == 1
    for name in OUTPUTS:
        got, ref = getattr(out, name), getattr(single, name)
        assert got.device.type == "cuda"
        assert got.cpu().numpy().tobytes() == ref.cpu().numpy().tobytes(), name


def test_empty_slabs_launch_nothing():
    """P = 33 on 8 shards: one row slab holds every row and the other
    seven are empty, so one scan, one reduction and a shelf per group
    slab run, and the answer is the single-device one."""
    fields = workloads.build_inputs(pods=33, types=2000, taints=64,
                                    labels=64, seed=7)
    inputs = TB.inputs_from_numpy(fields, "cuda")
    single = TB.solve(inputs, buckets=32, backend="cuda")
    mesh = PM.build_mesh(n_devices=8)
    TF.reset_launch_counts()
    out = PM.sharded_binpack(mesh, inputs, 32, backend="cuda")
    torch.cuda.synchronize()
    assert TF.LAUNCHES == {"fused_assign": 1, "shelf_bfd": 8,
                           "demand_reduce": 1, "pack_bits": 1}
    for name in OUTPUTS:
        assert torch.equal(getattr(out, name), getattr(single, name)), name


def test_service_routes_through_the_mesh_on_the_card():
    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.solver import SolverService

    fields = workloads.build_inputs(pods=3000, types=300, taints=64,
                                    labels=64, seed=5)
    inputs = TB.BinPackInputs(**fields)
    single = TB.solve(inputs, buckets=32, backend="cuda")
    svc = SolverService(registry=GaugeRegistry(), shard_threshold=1)
    try:
        TF.reset_launch_counts()
        out = svc.solve(inputs)
        assert TF.LAUNCHES["demand_reduce"] == 1
        assert svc.stats.shard_requests == svc.stats.shard_dispatches == 1
        assert svc.stats.fallbacks == svc.stats.shard_fallbacks == 0
        for name in OUTPUTS:
            np.testing.assert_array_equal(
                np.asarray(getattr(out, name)),
                getattr(single, name).cpu().numpy(), err_msg=name)
    finally:
        svc.close()
