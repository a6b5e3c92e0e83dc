"""The port's fused stage (karpenter_tpu_torch/ops/fused_assign.py) ==
the reference's Pallas kernel (karpenter_tpu/ops/pallas_binpack.py, run in
interpret mode as its own tests run it on the CPU) and XLA program.

On the CPU the wrappers run their plain PyTorch versions; the cases of
tests/test_pallas_binpack.py are ported one for one. The compiled CUDA
kernels run only on a card: tests/test_torch_kernels_cuda.py holds them
against the plain versions there (and chip_smoke.py at the main path's
shapes).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from karpenter_tpu.ops import binpack as B
from karpenter_tpu.ops import pallas_binpack as PB
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops import fused_assign as TF

from test_binpack import make_inputs
from test_pallas_binpack import random_inputs
from test_torch_binpack import assert_same, to_port, with_fields


def check_fused_stage(inputs, buckets, tile_p=64):
    """Port plain fused_assign vs the Pallas kernel in interpret mode:
    assigned and hist exact, demand to summation order, and the weighted
    unschedulable count exact against the reference's assignment."""
    a_ref, h_ref, d_ref = PB.fused_assign(
        inputs, buckets=buckets, tile_p=tile_p, interpret=True
    )
    a, h, d, u = TF.fused_assign(to_port(inputs), buckets)
    assert a.dtype == torch.int32 and h.dtype == torch.int32
    assert d.dtype == torch.float32
    assert u.dtype == torch.int32 and u.shape == ()
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_ref))
    np.testing.assert_allclose(
        d.numpy(), np.asarray(d_ref), rtol=1e-5, atol=1e-4
    )
    valid = np.asarray(inputs.pod_valid)
    w = (np.ones(valid.shape, np.int64) if inputs.pod_weight is None
         else np.asarray(inputs.pod_weight, np.int64))
    assert int(u) == int(w[(np.asarray(a_ref) < 0) & valid].sum())


def check_full(inputs, buckets, tile_p=64, xla_lp_exact=True):
    """binpack_fused vs binpack_pallas(interpret) and the XLA program.

    xla_lp_exact=False admits an lp_bound that differs from the XLA
    program's by 1 where, and only where, the exact demand/alloc lies
    within 1e-5 relative of an integer: there the ceiling turns on the
    last bits of an f32 sum whose order the two programs do not share."""
    port = TF.binpack_fused(to_port(inputs), buckets)
    assert_same(
        PB.binpack_pallas(
            inputs, buckets=buckets, tile_p=tile_p, interpret=True
        ),
        port,
    )
    xla = B.binpack(inputs, buckets=buckets)
    if xla_lp_exact:
        assert_same(xla, port)
        return port
    assert_same(dataclasses.replace(xla, lp_bound=port.lp_bound), port)
    lp_xla = np.asarray(xla.lp_bound)
    off = np.flatnonzero(port.lp_bound.numpy() != lp_xla)
    assigned = port.assigned.numpy()
    req = np.asarray(inputs.pod_requests, np.float64)
    alloc = np.asarray(inputs.group_allocatable, np.float64)
    w = np.asarray(inputs.pod_weight, np.float64)
    for t in off:
        assert abs(int(port.lp_bound[t]) - int(lp_xla[t])) == 1
        ratio = (w[assigned == t, None] * req[assigned == t]).sum(0) / alloc[t]
        assert np.any(np.abs(ratio - np.round(ratio)) <= 1e-5 * ratio), t
    return port


class TestFusedMatchesReference:
    @pytest.mark.parametrize("seed", range(5))
    def test_random_parity(self, seed):
        rng = np.random.default_rng(seed)
        inputs = random_inputs(rng, pods=203, types=37)
        check_full(inputs, 16)
        check_fused_stage(inputs, 16)

    def test_padding_invisible(self):
        rng = np.random.default_rng(99)
        inputs = random_inputs(rng, pods=65, types=5, taints=3, labels=2)
        check_full(inputs, 8)
        check_fused_stage(inputs, 8)

    @pytest.mark.parametrize("seed", range(3))
    def test_score_parity(self, seed):
        rng = np.random.default_rng(200 + seed)
        inputs = with_fields(
            random_inputs(rng, pods=203, types=37),
            pod_group_score=rng.integers(0, 100, (203, 37)).astype(np.float32),
            pod_weight=rng.integers(1, 2000, 203).astype(np.int32),
        )
        port = check_full(inputs, 16)
        check_fused_stage(inputs, 16)
        total = int(port.assigned_count.sum()) + int(port.unschedulable)
        valid = np.asarray(inputs.pod_valid)
        assert total == int(np.asarray(inputs.pod_weight)[valid].sum())

    def test_score_tiebreak_is_lowest_index(self):
        rng = np.random.default_rng(42)
        base = random_inputs(rng, pods=90, types=11)
        uniform = with_fields(
            base, pod_group_score=np.full((90, 11), 7.0, np.float32)
        )
        assert_same(
            B.binpack(base, buckets=8), TF.binpack_fused(to_port(uniform), 8)
        )

    @pytest.mark.parametrize("seed", range(3))
    def test_forbidden_parity(self, seed):
        rng = np.random.default_rng(100 + seed)
        inputs = with_fields(
            random_inputs(rng, pods=203, types=37),
            pod_group_forbidden=rng.random((203, 37)) < 0.4,
            pod_weight=rng.integers(1, 2000, 203).astype(np.int32),
        )
        port = check_full(inputs, 16)
        assigned = port.assigned.numpy()
        forbidden = np.asarray(inputs.pod_group_forbidden)
        rows = np.flatnonzero(assigned >= 0)
        assert not forbidden[rows, assigned[rows]].any()

    @pytest.mark.parametrize("seed", range(3))
    def test_exclusive_parity(self, seed):
        rng = np.random.default_rng(300 + seed)
        inputs = with_fields(
            random_inputs(rng, pods=203, types=37),
            pod_exclusive=rng.random(203) < 0.3,
            pod_weight=rng.integers(1, 40, 203).astype(np.int32),
        )
        port = check_full(inputs, 16)
        assigned = port.assigned.numpy()
        excl = np.asarray(inputs.pod_exclusive)
        w = np.asarray(inputs.pod_weight)
        for t in range(37):
            assert int(port.nodes_needed[t]) >= int(
                w[(assigned == t) & excl].sum()
            )

    @pytest.mark.parametrize(
        "operand", ["none", "score", "forbidden", "exclusive"]
    )
    def test_heavy_weights(self, operand):
        """The reference's compiled-Mosaic cases at 512 x 24 with weights
        in [1000, 5000): past bf16's mantissa, so a rounding accumulator
        would miscount. Demands reach ~1e6 node-widths, where f32 holds
        no 1e-5 guard: the XLA program's f32 sum of seed 6 rounds one
        group across an integer that the Pallas kernel and the port (f64,
        rounded once) agree on, so lp_bound is held to the boundary rule
        there (check_full)."""
        rng = np.random.default_rng(6)
        extra = {"pod_weight": rng.integers(1000, 5000, 512).astype(np.int32)}
        if operand == "score":
            extra["pod_group_score"] = rng.integers(0, 100, (512, 24)).astype(
                np.float32
            )
        elif operand == "forbidden":
            extra["pod_group_forbidden"] = rng.random((512, 24)) < 0.3
        elif operand == "exclusive":
            extra["pod_exclusive"] = rng.random(512) < 0.3
        inputs = with_fields(random_inputs(rng, pods=512, types=24), **extra)
        check_full(inputs, 16, tile_p=128, xla_lp_exact=False)
        check_fused_stage(inputs, 16, tile_p=128)

    def test_multi_word_taints_and_labels(self):
        """K and L past one 64-bit word: the packed layout's word
        boundaries are invisible."""
        rng = np.random.default_rng(21)
        inputs = random_inputs(rng, pods=150, types=19, taints=70, labels=130)
        check_full(inputs, 16)
        check_fused_stage(inputs, 16)

    def test_semantics_taints_and_labels(self):
        inputs = make_inputs(
            pod_requests=[[1, 1], [1, 1]],
            group_allocatable=[[4, 4], [4, 4]],
            pod_intolerant=[[True, False], [False, False]],
            group_taints=[[True, False], [False, False]],
            pod_required=[[False, False], [False, True]],
            group_labels=[[True, True], [True, False]],
            n_taints=2,
            n_labels=2,
        )
        out = TF.binpack_fused(to_port(inputs), 8)
        assert out.assigned.tolist() == [1, 0]

    def test_all_unschedulable(self):
        inputs = make_inputs(pod_requests=[[9, 9]], group_allocatable=[[1, 1]])
        out = TF.binpack_fused(to_port(inputs), 8)
        assert out.assigned.tolist() == [-1]
        assert int(out.unschedulable) == 1
        assert out.nodes_needed.tolist() == [0]

    def test_fused_stage_outputs(self):
        """Histogram and demand match a NumPy recomputation."""
        rng = np.random.default_rng(7)
        inputs = random_inputs(rng, pods=130, types=9)
        buckets = 12
        assigned, hist, demand, unsched = TF.fused_assign(
            to_port(inputs), buckets
        )
        assigned = assigned.numpy()
        valid = np.asarray(inputs.pod_valid)
        assert int(unsched) == int(((assigned < 0) & valid).sum())
        req = np.asarray(inputs.pod_requests)
        alloc = np.asarray(inputs.group_allocatable)
        want_hist = np.zeros((alloc.shape[0], buckets), np.int64)
        want_demand = np.zeros_like(alloc, dtype=np.float64)
        for p, t in enumerate(assigned):
            if t < 0:
                continue
            shares = [
                (req[p, r] / alloc[t, r]) if alloc[t, r] > 0 else
                (0.0 if req[p, r] <= 0 else np.inf)
                for r in range(req.shape[1])
            ]
            b = int(np.clip(np.ceil(max(shares) * buckets), 1, buckets))
            want_hist[t, b - 1] += 1
            want_demand[t] += req[p]
        np.testing.assert_array_equal(hist.numpy(), want_hist)
        np.testing.assert_allclose(
            demand.numpy(), want_demand, rtol=1e-5, atol=1e-4
        )

    def test_weighted_matches_xla(self):
        rng = np.random.default_rng(9)
        inputs = with_fields(
            random_inputs(rng, pods=90, types=7),
            pod_weight=rng.integers(0, 9, 90).astype(np.int32),
        )
        check_full(inputs, 12)


class TestWrappers:
    def test_cpu_path_counts_no_launch(self):
        before = dict(TF.LAUNCHES)
        rng = np.random.default_rng(1)
        port = to_port(random_inputs(rng, pods=40, types=6))
        TF.binpack_fused(port, 8)
        assert TF.LAUNCHES == before

    def test_reset_launch_counts(self):
        TF.LAUNCHES["fused_assign"] += 3
        TF.LAUNCHES["demand_reduce"] += 1
        TF.LAUNCHES["pack_bits"] += 2
        TF.reset_launch_counts()
        assert TF.LAUNCHES == {"fused_assign": 0, "shelf_bfd": 0,
                               "demand_reduce": 0, "pack_bits": 0}

    def test_rejects_operands_it_cannot_take(self):
        rng = np.random.default_rng(2)
        base = random_inputs(rng, pods=10, types=3)
        for extra in (
            {"pod_claim": np.zeros(10, np.int32)},
            {"pod_priority": np.ones(10, np.int32),
             "group_tier": np.ones(3, np.int32)},
        ):
            with pytest.raises(ValueError):
                TF.fused_assign(to_port(with_fields(base, **extra)), 8)

    @pytest.mark.parametrize("k", [0, 1, 15, 16, 63, 64, 65, 130, 512])
    def test_pack_bits(self, k):
        rng = np.random.default_rng(k)
        bits = rng.random((7, k)) < 0.5
        words = TF.pack_bits(torch.from_numpy(bits))
        assert words.dtype == torch.int64
        assert words.shape == (7, max(1, -(-k // 64)))
        unpacked = (
            (words.numpy().view(np.uint64)[:, :, None]
             >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
        ).reshape(7, -1)
        np.testing.assert_array_equal(unpacked[:, :k].astype(bool), bits)
        assert not unpacked[:, k:].any()
        # the kernel's wrapper runs this plain version on CPU tensors
        (plain,) = TF.pack_masks([torch.from_numpy(bits)], [False])
        assert torch.equal(plain, words)
        (inverted,) = TF.pack_masks([torch.from_numpy(bits)], [True])
        assert torch.equal(inverted, TF.pack_bits(torch.from_numpy(~bits)))

    def test_pack_masks_on_cpu_packs_each_mask_and_counts_no_launch(self):
        rng = np.random.default_rng(11)
        shapes = ((9, 64), (9, 130), (3, 0), (0, 16))
        masks = [torch.from_numpy(rng.random(shape) < 0.3)
                 for shape in shapes]
        invert = (False, True, True, False)
        before = dict(TF.LAUNCHES)
        got = TF.pack_masks(masks, invert)
        assert TF.LAUNCHES == before
        assert len(got) == len(masks)
        for words, mask, inv in zip(got, masks, invert):
            assert torch.equal(words, TF.pack_bits(~mask if inv else mask))
        with pytest.raises(ValueError):
            TF.pack_masks(masks, invert[:3])
        with pytest.raises(ValueError):
            TF.pack_masks([], [])

    def test_packed_words_are_the_plain_words_of_the_four_masks(self):
        port = to_port(random_inputs(np.random.default_rng(4), 20, 5))
        words = TF.pack_operands(port)
        want = (TF.pack_bits(port.pod_intolerant),
                TF.pack_bits(port.pod_required),
                TF.pack_bits(port.group_taints),
                TF.pack_bits(~port.group_labels))
        assert all(torch.equal(a, b) for a, b in zip(words, want))

    def test_each_fused_solve_packs_once_and_the_cost_adds_no_pack(
        self, monkeypatch
    ):
        calls = []
        pack_masks = TF.pack_masks

        def counted(masks, invert):
            calls.append(len(tuple(masks)))
            return pack_masks(masks, invert)

        monkeypatch.setattr(TF, "pack_masks", counted)
        port = to_port(random_inputs(np.random.default_rng(3), 12, 4))
        TF.binpack_fused(port, 8)
        assert calls == [4]
        TF.binpack_fused(port, 8)  # the same object again packs again
        assert calls == [4, 4]
        assigned, hist, _, _ = TF.fused_assign_reference(port, 8)
        del calls[:]
        TF.kernel_cost(port, 8, assigned.numpy(), hist.numpy())
        assert calls == []
        TF.solve_cost(port, 8)  # its host fused_assign_reference alone
        assert calls == [4]

    @pytest.mark.parametrize("seed,buckets", [(0, 32), (1, 16), (2, 8)])
    def test_shelf_wrapper_on_cpu(self, seed, buckets):
        hist = np.random.default_rng(seed).integers(0, 60, (11, buckets))
        hist = hist.astype(np.int32)
        nodes, count = TF.shelf_bfd(torch.from_numpy(hist), buckets)
        np.testing.assert_array_equal(
            nodes.numpy(), B.oracle_shelf_bfd(hist, buckets)
        )
        np.testing.assert_array_equal(count.numpy(), hist.sum(axis=1))

    @pytest.mark.parametrize("buckets", [1, 8, 33])
    def test_shelf_reference_count_is_row_sum(self, buckets):
        """The plain shelf version's assigned_count is hist.sum(dim=1) in
        int32, and its node count is the plain program's _shelf_bfd."""
        hist = np.random.default_rng(buckets).integers(
            0, 300, (17, buckets)
        ).astype(np.int32)
        hist[3] = 0  # an empty group counts 0 and needs 0 nodes
        t = torch.from_numpy(hist)
        nodes, count = TF.shelf_bfd_reference(t, buckets)
        assert count.dtype == torch.int32 and nodes.dtype == torch.int32
        assert torch.equal(count, t.sum(dim=1, dtype=torch.int32))
        assert torch.equal(nodes, TB._shelf_bfd(t, buckets))
        assert int(count[3]) == 0 and int(nodes[3]) == 0

    def test_build_raises_without_nvcc(self, monkeypatch, tmp_path):
        monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
        monkeypatch.setattr(kernels.os, "access", lambda *a: False)
        monkeypatch.setattr(kernels, "BUILD", tmp_path / "_build")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernels.build(["shelf_bfd"])
        with pytest.raises(ValueError, match="unknown kernel"):
            kernels.build(["nope"])

    def test_sources_and_signatures_agree(self):
        """Every C entry the loader declares is defined in its source,
        with as many parameters as the loader passes."""
        for name in kernels.SOURCES:
            source = (kernels.CSRC / f"{name}.cu").read_text()
            for fn, (argtypes, _) in kernels._SIGNATURES[name].items():
                match = re.search(
                    rf"^\w[\w\s\*]* {fn}\(([^)]*)\)", source, re.MULTILINE
                )
                assert match, f"{fn} missing from {name}.cu"
                params = [p for p in match.group(1).split(",") if p.strip()]
                assert len(params) == len(argtypes), fn

    def test_plan_constants_match_sources(self):
        """The Python launch plans use the kernels' own constants."""
        fused = (kernels.CSRC / "fused_assign.cu").read_text()
        assert f"kThreads = {TF.THREADS};" in fused
        assert (f"kItems = {TF.ROWS_PER_BLOCK // TF.THREADS};") in fused
        assert f"kMaxResources = {TF.MAX_RESOURCES};" in fused
        assert f"kMaxWords = {TF.MAX_WORDS};" in fused
        assert f"kPackMaxMasks = {TF.PACK_MAX_MASKS};" in fused
        assert "launch_assign<%d, %d, true>" % TF._NARROW in fused
        assert f"sizeof(GroupRecord) == {TF._RECORD_BYTES}" in fused
        shelf = (kernels.CSRC / "shelf_bfd.cu").read_text()
        assert f"kMaxSharedBytes = {TF._MAX_SHARED_BYTES};" in shelf
        assert TF.SHELF_MAX_BUCKETS * 12 <= TF._MAX_SHARED_BYTES


def _raise(*_args, **_kwargs):
    raise AssertionError("the launch plan read a device property")


class TestLaunchPlan:
    @pytest.mark.parametrize("taints", [64, 512])
    @pytest.mark.parametrize("groups", [300, 1448, 4096])
    def test_plan_takes_the_shape(self, monkeypatch, groups, taints):
        """T past 1,447 groups (where a per-block [T, B] shared histogram
        would no longer fit) plans without a raise, and the
        plan reads the shape only: rows per block are fixed, so the blocks'
        row chunks (and the order of every float sum) are the same on any
        card."""
        monkeypatch.setattr(torch.cuda, "get_device_properties", _raise)
        monkeypatch.setattr(torch.cuda, "device_count", _raise)
        words = taints // 64
        plan = TF.fused_assign_plan(100_000, groups, 3, words, words, 32)
        assert plan.n_blocks == -(-100_000 // TF.ROWS_PER_BLOCK) == 196
        # one word each and 32-byte records within the budget: the narrow
        # instance (T = 300, 1,448), its records in shared memory; else the
        # generic one (T = 4,096 or K = L = 512), which reads the group
        # side from global memory and takes no dynamic shared memory
        narrow = taints == 64 and groups <= 2048
        assert plan.narrow == narrow
        assert plan.shared_bytes == (32 * groups if narrow else 0)
        assert plan.shared_bytes <= TF.GROUP_SHARED_BUDGET <= TF._MAX_SHARED_BYTES
        assert 2 ** plan.key_bits > groups * 32
        assert plan.partial_bytes == 8 * 196 * groups * 3
        assert plan == TF.fused_assign_plan(100_000, groups, 3, words, words, 32)

    def test_scratch_bytes_at_main_path_and_wide_fleet(self):
        """Scratch of the main path (T = 300) and of T = 4,096 at 100k
        rows, as PERF.md states them."""
        small = TF.fused_assign_plan(100_000, 300, 3, 1, 1, 32)
        wide = TF.fused_assign_plan(100_000, 4096, 3, 1, 1, 32)
        assert small.scratch_bytes == 1_411_200 + 784
        assert wide.scratch_bytes == 19_267_584 + 784
        assert small.narrow and small.shared_bytes == 300 * 32
        assert not wide.narrow and wide.shared_bytes == 0

    @pytest.mark.parametrize(
        "shape",
        [(10, 5, 9, 1, 1, 8), (10, 5, 3, 9, 1, 8), (10, 5, 3, 1, 1, 0),
         (10, 2**26, 3, 1, 1, 32)],
        ids=["resources", "words", "buckets", "keys"],
    )
    def test_plan_refuses_what_the_kernel_cannot_take(self, shape):
        with pytest.raises(ValueError):
            TF.fused_assign_plan(*shape)

    def test_empty_problem_plans_no_block(self):
        plan = TF.fused_assign_plan(0, 7, 3, 1, 1, 8)
        assert plan.n_blocks == 0 and plan.scratch_bytes == 0


class TestWideFleets:
    def test_plain_matches_pallas_past_the_old_group_limit(self):
        """The plain fused stage against the Pallas kernel in interpret
        mode at T = 2,000 (past 1,447 groups, which the CUDA path must take):
        assigned and hist exact, demand as check_full's stage holds it."""
        rng = np.random.default_rng(2000)
        inputs = with_fields(
            random_inputs(rng, pods=300, types=2000, taints=64, labels=64),
            pod_weight=rng.integers(1, 50, 300).astype(np.int32),
        )
        check_fused_stage(inputs, 32, tile_p=128)
