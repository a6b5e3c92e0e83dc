"""The port's multi-device scale-out (karpenter_tpu_torch/parallel/mesh.py)
against the reference's (karpenter_tpu/parallel/mesh.py), on the CPU.

The reference shards over the eight virtual CPU devices tests/conftest.py
gives JAX; the port over eight virtual copies of the CPU
(utils/device.force_virtual_devices, set by a fixture here and undone
after each test). Each test is the counterpart of tests/test_parallel.py's
of the same name, with its parametrisation: inputs are drawn by the
reference's seeded builders and handed to both packages as the same numpy
arrays.

Tolerance: bitwise on every output (integers and lp_bound's i32 alike,
forecast's f32 too): the sharded programs equal the port's single-device
programs, its numpy mirrors and the reference's sharded programs exactly.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import karpenter_tpu.parallel as RP
from karpenter_tpu.ops import binpack as RB
from karpenter_tpu.ops.decision import decide_jit as ref_decide
from karpenter_tpu.parallel import mesh as RM
from karpenter_tpu_torch.forecast import models as TM
from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.ops import preempt as TP
from karpenter_tpu_torch.ops.decision import DecisionInputs, decide
from karpenter_tpu_torch.ops.numpy_binpack import binpack_numpy
from karpenter_tpu_torch.parallel import mesh as PM
from karpenter_tpu_torch.utils import device as UD
from test_parallel import (
    _constrained_inputs,
    _forecast_problem,
    _full_operand_inputs,
    _preempt_problem,
    service_t_bucket,
)

OUTPUTS = ("assigned", "assigned_count", "nodes_needed", "lp_bound",
           "unschedulable")


@pytest.fixture(autouse=True)
def eight_devices():
    UD.force_virtual_devices(8, "cpu")
    yield
    UD.reset_virtual_devices()


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def fields_of(ref) -> dict:
    return {f.name: np.asarray(getattr(ref, f.name))
            for f in dataclasses.fields(ref)
            if getattr(ref, f.name) is not None}


def port_binpack(ref) -> TB.BinPackInputs:
    return TB.inputs_from_numpy(fields_of(ref), "cpu")


def same(got, want, label, names=OUTPUTS):
    for name in names:
        np.testing.assert_array_equal(
            host(getattr(got, name)), host(getattr(want, name)),
            err_msg=f"{label}.{name}",
        )


def check_binpack(ref_inputs, mesh_kwargs, buckets=8):
    """Port sharded == port single == port numpy mirror == reference
    sharded, all five outputs bitwise; returns the port's outputs."""
    inputs = port_binpack(ref_inputs)
    out = PM.sharded_binpack(PM.build_mesh(**mesh_kwargs), inputs, buckets)
    ref_out = jax.device_get(RP.sharded_binpack(
        RP.build_mesh(**mesh_kwargs), ref_inputs, buckets=buckets
    ))
    same(out, TB.binpack(inputs, buckets), "single")
    same(out, binpack_numpy(inputs, buckets=buckets), "numpy")
    same(out, ref_out, "reference")
    return out


def test_factorize_pods_major():
    assert PM.factorize(8) == (4, 2)
    assert PM.factorize(4) == (2, 2)
    assert PM.factorize(2) == (2, 1)
    assert PM.factorize(1) == (1, 1)
    assert PM.factorize(6) == (3, 2)
    for n in range(1, 33):
        assert PM.factorize(n) == RM.factorize(n)


def test_build_mesh_shapes():
    mesh = PM.build_mesh(n_devices=8)
    assert mesh.shape[PM.AXIS_PODS] == 4
    assert mesh.shape[PM.AXIS_GROUPS] == 2
    assert mesh.shape == dict(RP.build_mesh(n_devices=8).shape)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert PM.mesh_extents(mesh) == RM.mesh_extents(RP.build_mesh(n_devices=8))
    with pytest.raises(ValueError, match="need 9 devices"):
        PM.build_mesh(n_devices=9)


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_sharded_binpack_matches_single_device(n_devices):
    check_binpack(RM.example_binpack_inputs(P_=64, T=8, K=8, L=8, seed=3),
                  dict(n_devices=n_devices))


def test_sharded_binpack_matches_single_device_at_scale():
    """10k pods x 56 types (bench.py's draw) on the 8-shard mesh: the
    plain route's slabs are 1,536 rows (three fused blocks) each."""
    from karpenter_tpu.ops.numpy_binpack import binpack_numpy as ref_numpy
    from karpenter_tpu_torch import workloads

    fields = workloads.build_inputs(pods=10_000, types=56, taints=32,
                                    labels=32, seed=0)
    inputs = TB.inputs_from_numpy(fields, "cpu")
    out = PM.sharded_binpack(PM.build_mesh(n_devices=8), inputs, 16)
    same(out, TB.binpack(inputs, 16), "single")
    same(out, ref_numpy(RB.BinPackInputs(**fields), buckets=16), "reference")


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_decide_matches_single_device(n_devices):
    ref_in = RM.example_decision_inputs(N=32, M=4, seed=7)
    inputs = DecisionInputs.from_numpy(ref_in, "cpu")
    out = PM.sharded_decide(PM.build_mesh(n_devices=n_devices), inputs)
    names = [f.name for f in dataclasses.fields(out)]
    same(out, decide(inputs), "single", names)
    same(out, jax.device_get(RP.sharded_decide(
        RP.build_mesh(n_devices=n_devices), ref_in)), "reference", names)
    same(out, jax.device_get(ref_decide(ref_in)), "reference single", names)


def test_padding_masks_not_truncates():
    # P=33, T=5 on a 4x2 mesh: P pads to 36, T to 6; results for the real
    # rows/columns must be unchanged
    ref_in = RM.example_binpack_inputs(P_=33, T=5, K=8, L=8, seed=11)
    inputs = port_binpack(ref_in)
    mesh = PM.build_mesh(n_devices=8)
    padded = PM.pad_binpack_inputs_for_mesh(inputs, mesh)
    assert padded.pod_requests.shape[0] == 36
    assert padded.group_allocatable.shape[0] == 6
    ref_padded = RP.pad_binpack_inputs_for_mesh(
        ref_in, RP.build_mesh(n_devices=8)
    )
    for name, value in fields_of(ref_padded).items():
        np.testing.assert_array_equal(host(getattr(padded, name)), value,
                                      err_msg=name)
    out = check_binpack(ref_in, dict(n_devices=8))
    assert out.assigned.shape == (33,) and out.nodes_needed.shape == (5,)
    # padding columns got no pods, padding rows are invalid
    full = PM.binpack_sharded(PM.shard_binpack_inputs(mesh, inputs), 8)
    assert np.all(host(full.assigned_count)[5:] == 0)
    assert np.all(host(full.assigned)[33:] == -1)


def test_fleet_step_combined():
    mesh = PM.build_mesh(n_devices=8)
    d_ref = RM.example_decision_inputs(N=16)
    d_in = PM.shard_decision_inputs(mesh, DecisionInputs.from_numpy(d_ref, "cpu"))
    b_in = PM.shard_binpack_inputs(
        mesh, port_binpack(RM.example_binpack_inputs(P_=32, T=8))
    )
    d_out, b_out = PM.fleet_step(d_in, b_in, buckets=8)
    np.testing.assert_array_equal(host(d_out.desired)[:16],
                                  np.asarray(ref_decide(d_ref).desired))
    assert int(b_out.assigned_count.sum()) + int(b_out.unschedulable) == 32


@pytest.mark.parametrize("n_devices", [1, 4, 8])
def test_dryrun_fleet_step(n_devices):
    PM.dryrun_fleet_step(n_devices)


def test_virtual_devices_dryrun_smoke():
    """The counterpart of the reference's graft-entry composition
    (force_virtual_cpu -> dryrun_fleet_step): forcing virtual devices
    again, wider, replaces the list, and the dry run runs over it; with
    the setting undone, the mesh's default devices are the CUDA cards,
    and without a card that raises."""
    UD.force_virtual_devices(12, "cpu")
    assert UD.visible_devices() == [torch.device("cpu")] * 12
    PM.dryrun_fleet_step(12)
    UD.reset_virtual_devices()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            PM.build_mesh()
    assert UD.visible_devices("cpu") == [torch.device("cpu")]


def test_sharded_outputs_sliced_to_input_sizes():
    """Mesh padding must not leak: output shapes equal input P/T even when
    padding occurred (P=33->36, T=5->6 on a 4x2 mesh)."""
    inputs = port_binpack(RM.example_binpack_inputs(P_=33, T=5, K=8, L=8,
                                                    seed=13))
    mesh = PM.build_mesh(n_devices=8)
    out = PM.sharded_binpack(mesh, inputs, buckets=8)
    assert out.assigned.shape == (33,)
    assert out.nodes_needed.shape == (5,)
    ref = TB.binpack(inputs, 8)
    assert int((out.assigned == -1).sum()) == int((ref.assigned == -1).sum())
    d_out = PM.sharded_decide(
        mesh, DecisionInputs.from_numpy(
            RM.example_decision_inputs(N=13, M=3, seed=17), "cpu")
    )
    assert d_out.desired.shape == (13,)


def _with(seed, P_, T, **draws):
    rng = np.random.default_rng(seed)
    extra = {}
    for name, draw in draws.items():
        extra[name] = jax.numpy.asarray(draw(rng, P_, T))
    return dataclasses.replace(
        RM.example_binpack_inputs(P_=P_, T=T, K=8, L=8, seed=seed), **extra
    )


def _weights(rng, p, t):
    return rng.integers(1, 50, p).astype(np.int32)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_weighted_binpack_matches_single_device(n_devices):
    check_binpack(_with(21, 37, 5, pod_weight=_weights),
                  dict(n_devices=n_devices))


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_score_binpack_matches_single_device(n_devices):
    check_binpack(_with(
        29, 37, 5, pod_weight=_weights,
        pod_group_score=lambda rng, p, t: rng.integers(
            0, 100, (p, t)).astype(np.float32),
    ), dict(n_devices=n_devices))


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_forbidden_binpack_matches_single_device(n_devices):
    check_binpack(_with(
        27, 37, 5, pod_weight=_weights,
        pod_group_forbidden=lambda rng, p, t: rng.random((p, t)) < 0.4,
    ), dict(n_devices=n_devices))


def test_sliced_mesh_matches_single_device():
    """3D slice x pods x groups mesh (multi-host): rows split over every
    axis; outputs equal the single-device solve and the decision
    program's fleet axis shards the same way."""
    mesh = PM.build_mesh(n_devices=8, slices=2)
    assert mesh.shape == {"slice": 2, "pods": 2, "groups": 2}
    check_binpack(_with(
        33, 45, 6,
        pod_weight=lambda rng, p, t: rng.integers(1, 20, p).astype(np.int32),
        pod_group_forbidden=lambda rng, p, t: rng.random((p, t)) < 0.3,
    ), dict(n_devices=8, slices=2))
    d_ref = RM.example_decision_inputs(N=19, M=3, seed=5)
    d_in = DecisionInputs.from_numpy(d_ref, "cpu")
    d_out = PM.sharded_decide(mesh, d_in)
    np.testing.assert_array_equal(host(d_out.desired), host(decide(d_in).desired))
    np.testing.assert_array_equal(
        host(d_out.able_to_scale),
        np.asarray(jax.device_get(ref_decide(d_ref)).able_to_scale),
    )


def test_pad_shard_unpad_is_identity_property():
    """For arbitrary non-divisible shapes, pad -> place -> rebuild from
    the shards and slice back is the IDENTITY on every operand, the
    padded axes are mesh-divisible, and the padding equals the
    reference's byte for byte."""
    mesh = PM.build_mesh(n_devices=8)
    ref_mesh = RP.build_mesh(n_devices=8)
    rows, cols = PM.mesh_extents(mesh)
    rng = np.random.default_rng(99)
    for trial in range(6):
        P_ = int(rng.integers(1, 120))
        T = int(rng.integers(1, 15))
        ref_in = _full_operand_inputs(P_, T, seed=100 + trial)
        inputs = port_binpack(ref_in)
        padded = PM.pad_binpack_inputs_for_mesh(inputs, mesh)
        assert padded.pod_requests.shape[0] % rows == 0
        assert padded.group_allocatable.shape[0] % cols == 0
        ref_padded = fields_of(RP.pad_binpack_inputs_for_mesh(ref_in, ref_mesh))
        sharded = PM.shard_binpack_inputs(mesh, inputs)
        for name, orig in fields_of(ref_in).items():
            got = sharded.field(name)
            np.testing.assert_array_equal(got, ref_padded[name],
                                          err_msg=f"trial {trial}: {name}")
            if name in ("pod_group_forbidden", "pod_group_score"):
                got = got[:P_, :T]
            else:
                got = got[:P_ if name.startswith("pod_") else T]
            np.testing.assert_array_equal(got, orig,
                                          err_msg=f"trial {trial}: {name}")


def test_pad_for_mesh_carries_priority_operands():
    """pad_binpack_inputs_for_mesh keeps pod_priority / group_tier (the
    reference's regression), with inert padding."""
    inputs = port_binpack(_full_operand_inputs(33, 5, seed=7))
    padded = PM.pad_binpack_inputs_for_mesh(inputs, PM.build_mesh(n_devices=8))
    assert padded.pod_priority is not None
    assert padded.group_tier is not None
    assert np.all(host(padded.pod_priority)[33:] == 0)
    assert np.all(host(padded.group_tier)[5:] == 0)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_matches_unsharded_matches_numpy(n_devices):
    """The three-way pin on a non-divisible full-operand problem (weight,
    forbidden, score, exclusive, priority and tier): the port bitwise on
    all five outputs, lp_bound included."""
    check_binpack(_full_operand_inputs(77, 9, seed=5),
                  dict(n_devices=n_devices))


def test_build_mesh_shape_override():
    """The --shard-mesh knob: explicit (pods, groups) extents replace
    the pods-major factorization; impossible shapes fail loudly."""
    mesh = PM.build_mesh(shape=(8, 1))
    assert mesh.shape == {"pods": 8, "groups": 1}
    mesh = PM.build_mesh(shape=(2, 4))
    assert mesh.shape == {"pods": 2, "groups": 4}
    with pytest.raises(ValueError):
        PM.build_mesh(shape=(16, 2))  # more devices than exist
    with pytest.raises(ValueError):
        PM.build_mesh(shape=(4, 2), slices=2)  # mutually exclusive
    check_binpack(_full_operand_inputs(45, 7, seed=2), dict(shape=(8, 1)))


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_forecast_matches_single_device_and_numpy(n_devices):
    ref_in = _forecast_problem()
    inputs = TM.ForecastInputs.from_numpy(ref_in, "cpu")
    out = PM.sharded_forecast(PM.build_mesh(n_devices=n_devices), inputs)
    names = ("point", "sigma2", "n_valid")
    same(out, TM.forecast(inputs), "single", names)
    same(out, TM.forecast_numpy(TM.ForecastInputs.from_arrays(ref_in)),
         "numpy", names)
    same(out, jax.device_get(RP.sharded_forecast(
        RP.build_mesh(n_devices=n_devices), ref_in)), "reference", names)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_preempt_matches_single_device_and_numpy(n_devices):
    ref_in = _preempt_problem()
    inputs = TP.PreemptInputs.from_numpy(ref_in, "cpu")
    out = PM.sharded_preempt(PM.build_mesh(n_devices=n_devices), inputs)
    names = ("chosen_node", "evict_count", "evict_mask", "unplaceable")
    same(out, TP.preempt_plan(inputs), "single", names)
    numpy = TP.preempt_numpy(TP.PreemptInputs.from_arrays(ref_in))
    for name in names:
        np.testing.assert_array_equal(
            host(getattr(out, name)), np.asarray(getattr(numpy, name)),
            err_msg=name)
    same(out, jax.device_get(RP.sharded_preempt(
        RP.build_mesh(n_devices=n_devices), ref_in)), "reference", names)


def test_service_routes_forecast_preempt_decide_through_mesh():
    """The production route: a torch-rung CPU service with the threshold
    at 1 routes forecast, preempt and decide through its mesh, each
    bitwise the single-device mirrors'."""
    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.solver import SolverService

    svc = SolverService(registry=GaugeRegistry(), shard_threshold=1,
                        backend="torch", device="cpu")
    try:
        f_in = _forecast_problem(S=29, T=20, seed=3)
        f_out = svc.forecast(f_in, backend="torch")
        f_ref = TM.forecast_numpy(TM.pad_forecast_inputs(
            TM.ForecastInputs.from_arrays(f_in), service_t_bucket(f_in)))
        same(f_out, f_ref, "forecast", ("point", "sigma2", "n_valid"))
        p_in = _preempt_problem(seed=5)
        p_out = svc.preempt(p_in, backend="torch")
        p_ref = TP.preempt_numpy(TP.PreemptInputs.from_arrays(p_in))
        for name in ("chosen_node", "evict_count", "evict_mask", "unplaceable"):
            np.testing.assert_array_equal(
                np.asarray(getattr(p_out, name)),
                np.asarray(getattr(p_ref, name)), err_msg=name)
        d_ref = RM.example_decision_inputs(N=33, M=3, seed=9)
        d_out = svc.decide(d_ref)
        want = jax.device_get(ref_decide(d_ref))
        same(d_out, want, "decide", ("desired", "able_to_scale"))
        assert isinstance(d_out.desired, np.ndarray)  # host in, host out
        assert svc.stats.shard_dispatches == 3, svc.stats
        assert svc.stats.shard_requests == 3
        assert svc.stats.fallbacks == svc.stats.shard_fallbacks == 0
    finally:
        svc.close()


def test_sharded_forecast_failure_walks_the_ladder():
    """A shard-routed forecast whose device path faults retries
    single-device, then (on the CPU) the numpy mirror answers the same
    bits; the failure trips the shard route until reset_caches."""
    from karpenter_tpu_torch.faults import injected_faults
    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.solver import SolverService

    svc = SolverService(registry=GaugeRegistry(), shard_threshold=1,
                        backend="torch", device="cpu")
    try:
        ref_in = _forecast_problem(S=17, T=20, seed=21)
        with injected_faults(seed=3) as reg:
            reg.plan("forecast.predict", mode="error")
            out = svc.forecast(ref_in, backend="torch")
        want = TM.forecast_numpy(TM.pad_forecast_inputs(
            TM.ForecastInputs.from_arrays(ref_in), service_t_bucket(ref_in)))
        same(out, want, "forecast", ("point", "sigma2", "n_valid"))
        assert svc.stats.shard_fallbacks >= 1
        assert svc.stats.fallbacks >= 1  # numpy rung answered
        assert svc._shard_broken
        svc.reset_caches()
        assert not svc._shard_broken
    finally:
        svc.close()


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_constrained_matches_unsharded_matches_numpy(n_devices):
    """With constraint operands (the spread rank is the one row-coupled
    quantity: each slab starts at the slot totals before it), the sharded
    program == the single-device program == the numpy mirror == the
    reference's sharded program."""
    ref_in = _constrained_inputs(seed=42)
    assert RB.has_constraint_operands(ref_in)
    check_binpack(ref_in, dict(n_devices=n_devices))


def test_pad_for_mesh_carries_constraint_operands():
    """All six constraint operands survive padding, inertly, byte for
    byte the reference's."""
    ref_in = _constrained_inputs(seed=43)
    inputs = port_binpack(ref_in)
    P_ = inputs.pod_valid.shape[0]
    T = inputs.group_allocatable.shape[0]
    padded = PM.pad_binpack_inputs_for_mesh(inputs, PM.build_mesh(n_devices=8))
    ref_padded = fields_of(RP.pad_binpack_inputs_for_mesh(
        ref_in, RP.build_mesh(n_devices=8)))
    for name in ("pod_claim", "group_reservation", "pod_pack_class",
                 "pod_spread_slot", "group_domain", "spread_cap"):
        if getattr(inputs, name) is None:
            continue
        assert getattr(padded, name) is not None, name
        np.testing.assert_array_equal(host(getattr(padded, name)),
                                      ref_padded[name], err_msg=name)
    if padded.pod_spread_slot is not None:
        assert np.all(host(padded.pod_spread_slot)[P_:] == 0)
    if padded.group_domain is not None:
        assert np.all(host(padded.group_domain)[T:] == 0)


# ---------------------------------------------------------------------------
# The port's own pins: the merged plain demand, the slab layout, the split
# kernel entry's plain versions, the decision/forecast/preempt padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slabs", [1, 3, 8])
def test_plain_demand_merged_over_slabs_equals_single_call(slabs):
    """The plain route's demand (each slab's f64 sum, added in slab order,
    rounded once) equals one call's weighted_demand bitwise at P = 2,000,
    real-valued requests and weights up to 50."""
    from karpenter_tpu_torch import workloads

    fields = workloads.build_inputs(pods=2000, types=40, taints=8, labels=8,
                                    seed=slabs)
    rng = np.random.default_rng(slabs)
    fields["pod_weight"] = rng.integers(1, 50, 2000).astype(np.int32)
    inputs = TB.inputs_from_numpy(fields, "cpu")
    assigned, bucket, w_row = TB.assign_rows(inputs, 32)
    want = TB.weighted_demand(assigned, w_row, inputs.pod_requests, 40)
    merged = torch.zeros((40, 3), dtype=torch.float64)
    for start, stop in PM.slab_bounds(2000, slabs, TF.ROWS_PER_BLOCK):
        merged = merged + TB.weighted_demand64(
            assigned[start:stop], w_row[start:stop],
            inputs.pod_requests[start:stop], 40)
    assert merged.to(torch.float32).numpy().tobytes() == want.numpy().tobytes()
    mesh = PM.build_mesh(shape=(slabs, 1))
    out = PM.sharded_binpack(mesh, inputs, 32)
    same(out, TB.binpack(inputs, 32), f"{slabs} slabs")


def test_slab_bounds_are_whole_blocks_in_row_order():
    bounds = PM.slab_bounds(100_000, 8, TF.ROWS_PER_BLOCK)
    assert bounds[0] == (0, 12_800) and bounds[-1] == (89_600, 100_000)
    assert all(a % TF.ROWS_PER_BLOCK == 0 for a, _ in bounds)
    assert PM.slab_bounds(33, 8, TF.ROWS_PER_BLOCK) == [(0, 33)] + [(33, 33)] * 7
    assert PM.slab_bounds(0, 3) == [(0, 0)] * 3
    # a 3D mesh's positions take the slabs in mesh order
    mesh = PM.build_mesh(n_devices=8, slices=2)
    assert PM.position_bounds(mesh, PM.Split(PM._row_axes(mesh)), 16) == [
        (2 * k, 2 * k + 2) for k in range(8)]


def test_scan_and_reduce_plain_versions_compose_to_the_fused_stage():
    """The split entry's plain versions: the scan's per-block partials
    reduce to fused_assign_reference's demand and unschedulable, slab by
    slab into views of one buffer (as the card route runs them), and
    the CPU wrappers launch nothing."""
    from karpenter_tpu_torch import workloads

    fields = workloads.build_inputs(pods=1500, types=24, taints=8, labels=8,
                                    seed=4)
    fields["pod_weight"] = np.random.default_rng(4).integers(
        1, 9, 1500).astype(np.int32)
    inputs = TB.inputs_from_numpy(fields, "cpu")
    before = dict(TF.LAUNCHES)
    assigned, hist, demand, unsched = TF.fused_assign_reference(inputs, 16)
    bufs = TF.scan_buffers(1500, 24, 3, 16, torch.device("cpu"))
    hists = []
    for start, stop in PM.slab_bounds(1500, 3, TF.ROWS_PER_BLOCK):
        b0, b1 = start // 512, -(-stop // 512)
        rows = dataclasses.replace(inputs, **{
            name: getattr(inputs, name)[start:stop]
            for name in ("pod_requests", "pod_valid", "pod_intolerant",
                         "pod_required", "pod_weight")})
        out = (bufs[0][start:stop], torch.empty((24, 16), dtype=torch.int32),
               bufs[2][b0:b1], bufs[3][b0:b1])
        hists.append(TF.fused_assign_scan(rows, 16, out=out)[1])
    got_demand, got_unsched = TF.demand_reduce(bufs[2], bufs[3])
    assert TF.LAUNCHES == before
    assert torch.equal(bufs[0], assigned)
    assert torch.equal(sum(hists), hist)
    assert torch.equal(got_unsched, unsched)
    torch.testing.assert_close(got_demand, demand, rtol=1e-6, atol=0)


def test_pad_decision_forecast_preempt_equal_reference():
    """The three row-padding helpers, numpy in and numpy out, byte for
    byte the reference's (fleet, series and candidate axes)."""
    mesh, ref_mesh = PM.build_mesh(n_devices=8), RP.build_mesh(n_devices=8)
    d_ref = RM.example_decision_inputs(N=13, M=3, seed=17)
    d_port = DecisionInputs.from_arrays(d_ref)
    f_ref = _forecast_problem(S=13, T=8)
    p_ref = _preempt_problem(c=13)
    for port_pad, ref_pad, port_in, ref_in in (
        (PM.pad_decision_inputs_for_mesh, RP.pad_decision_inputs_for_mesh,
         d_port, d_ref),
        (PM.pad_forecast_inputs_for_mesh, RP.pad_forecast_inputs_for_mesh,
         TM.ForecastInputs.from_arrays(f_ref), f_ref),
        (PM.pad_preempt_inputs_for_mesh, RP.pad_preempt_inputs_for_mesh,
         TP.PreemptInputs.from_arrays(p_ref), p_ref),
    ):
        got, want = port_pad(port_in, mesh), ref_pad(ref_in, ref_mesh)
        for f in dataclasses.fields(want):
            w = getattr(want, f.name)
            if w is None:
                continue
            g = np.asarray(getattr(got, f.name))
            assert g.dtype == np.asarray(w).dtype, f.name
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f.name)


@pytest.mark.parametrize("mesh_kwargs", [
    dict(n_devices=8), dict(n_devices=8, slices=2), dict(shape=(3, 1)),
])
def test_card_route_on_the_wrappers_plain_versions(mesh_kwargs):
    """The card route's partition (row slabs of whole 512-row blocks
    scanned into views of one buffer, one reduction over every slab's
    partials, group slabs for the shelf) run through the wrappers' plain
    versions on CPU shards: the single-device fused path's bits, and the
    launch plan it states."""
    from karpenter_tpu_torch import workloads

    fields = workloads.build_inputs(pods=5000, types=40, taints=8, labels=8,
                                    seed=9)
    fields["pod_weight"] = np.random.default_rng(9).integers(
        1, 9, 5000).astype(np.int32)
    inputs = TB.inputs_from_numpy(fields, "cpu")
    mesh = PM.build_mesh(**mesh_kwargs)
    sh = PM.shard_binpack_inputs(mesh, inputs)
    full = PM._card_route(sh, 32)  # at the mesh-padded P
    rows = sh.whole.pod_requests.shape[0]
    assert np.all(host(full.assigned)[5000:] == -1)
    out = dataclasses.replace(full, assigned=full.assigned[:5000])
    same(out, TF.binpack_fused(inputs, 32), "fused")
    same(out, TB.binpack(inputs, 32), "plain")
    slab = -(-rows // (TF.ROWS_PER_BLOCK * mesh.size)) * TF.ROWS_PER_BLOCK
    assert PM.launch_plan(sh) == {"fused_assign": -(-rows // slab),
                                  "shelf_bfd": min(mesh.size, 40),
                                  "demand_reduce": 1}
