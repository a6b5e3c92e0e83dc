"""The port's bin-pack program (karpenter_tpu_torch/ops/binpack.py) ==
the reference's XLA program (karpenter_tpu/ops/binpack.py), output for
output, on the CPU.

Inputs are drawn with numpy from a seed, built as the reference's
BinPackInputs, and handed to the port field by field as numpy arrays
(inputs_from_numpy), so both packages solve the same data. All five
outputs are integers and must match exactly.
"""

import ast
import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.ops import binpack as B
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.ops import binpack as TB

from test_binpack import make_inputs
from test_pallas_binpack import random_inputs

REPO = pathlib.Path(__file__).resolve().parents[1]
OUTPUT_FIELDS = (
    "assigned", "assigned_count", "nodes_needed", "lp_bound", "unschedulable"
)


def to_fields(inputs):
    """The reference's BinPackInputs as one numpy array per set field."""
    return {
        f.name: np.asarray(getattr(inputs, f.name))
        for f in dataclasses.fields(inputs)
        if getattr(inputs, f.name) is not None
    }


def to_port(inputs):
    return TB.inputs_from_numpy(to_fields(inputs), device="cpu")


def assert_same(ref, port):
    """Reference outputs (jax) == port outputs (torch), exactly."""
    for name in OUTPUT_FIELDS:
        want = np.asarray(getattr(ref, name))
        got = getattr(port, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def check_program(inputs, buckets):
    """The port's binpack against the reference's, on the same data."""
    ref = B.binpack(inputs, buckets=buckets)
    assert_same(ref, TB.binpack(to_port(inputs), buckets=buckets))
    return ref


def with_fields(inputs, **arrays):
    return dataclasses.replace(
        inputs, **{k: jnp.asarray(v) for k, v in arrays.items()}
    )


def constraint_fields(rng, pods, types, which):
    """Random constraint-plane operands (the six optional fields), for the
    subset named in `which`."""
    n_slots, n_domains = 2, 4
    caps = rng.integers(5, 60, (n_slots, n_domains)).astype(np.int32)
    caps[:, -1] = 0  # the no-zone sink domain
    out = {
        "pod_claim": rng.integers(0, 3, pods).astype(np.int32),
        "group_reservation": (
            rng.integers(0, 3, types) * (rng.random(types) < 0.4)
        ).astype(np.int32),
        "pod_pack_class": np.eye(3, dtype=bool)[rng.integers(0, 3, pods)]
        & (rng.random((pods, 1)) < 0.8),
        "pod_spread_slot": rng.integers(0, n_slots + 1, pods).astype(np.int32),
        "group_domain": rng.integers(0, n_domains, types).astype(np.int32),
        "spread_cap": caps,
    }
    return {k: out[k] for k in which}


class TestProgramMatchesReference:
    @pytest.mark.parametrize("seed", range(5))
    def test_random_parity(self, seed):
        rng = np.random.default_rng(seed)
        check_program(random_inputs(rng, pods=203, types=37), 16)

    def test_padding_shapes(self):
        rng = np.random.default_rng(99)
        check_program(
            random_inputs(rng, pods=65, types=5, taints=3, labels=2), 8
        )

    @pytest.mark.parametrize("seed", range(3))
    def test_score_parity(self, seed):
        rng = np.random.default_rng(200 + seed)
        inputs = with_fields(
            random_inputs(rng, pods=203, types=37),
            pod_group_score=rng.integers(0, 100, (203, 37)).astype(np.float32),
            pod_weight=rng.integers(1, 2000, 203).astype(np.int32),
        )
        ref = check_program(inputs, 16)
        free = B.binpack(
            dataclasses.replace(inputs, pod_group_score=None), buckets=16
        )
        assert not np.array_equal(
            np.asarray(free.assigned), np.asarray(ref.assigned)
        )

    def test_score_tiebreak_is_lowest_index(self):
        rng = np.random.default_rng(42)
        base = random_inputs(rng, pods=90, types=11)
        uniform = with_fields(
            base, pod_group_score=np.full((90, 11), 7.0, np.float32)
        )
        port_uniform = TB.binpack(to_port(uniform), buckets=8)
        assert_same(B.binpack(base, buckets=8), port_uniform)
        assert_same(B.binpack(uniform, buckets=8), port_uniform)

    @pytest.mark.parametrize("seed", range(3))
    def test_forbidden_parity(self, seed):
        rng = np.random.default_rng(100 + seed)
        inputs = with_fields(
            random_inputs(rng, pods=203, types=37),
            pod_group_forbidden=rng.random((203, 37)) < 0.4,
            pod_weight=rng.integers(1, 2000, 203).astype(np.int32),
        )
        check_program(inputs, 16)

    @pytest.mark.parametrize("seed", range(3))
    def test_exclusive_parity(self, seed):
        rng = np.random.default_rng(300 + seed)
        inputs = with_fields(
            random_inputs(rng, pods=203, types=37),
            pod_exclusive=rng.random(203) < 0.3,
            pod_weight=rng.integers(1, 40, 203).astype(np.int32),
        )
        check_program(inputs, 16)

    @pytest.mark.parametrize("low,high", [(0, 9), (1000, 5000)])
    def test_weighted_parity(self, low, high):
        """Weights in [1000, 5000) are the bench's dedup multiplicities:
        past bf16's mantissa, so an accumulator that rounds would show."""
        rng = np.random.default_rng(9)
        inputs = with_fields(
            random_inputs(rng, pods=512, types=24),
            pod_weight=rng.integers(low, high, 512).astype(np.int32),
        )
        check_program(inputs, 16)

    @pytest.mark.parametrize("with_score", [False, True])
    def test_priority_steer_parity(self, with_score):
        rng = np.random.default_rng(17)
        tier = rng.integers(0, 2, 37).astype(np.int32)
        tier[:2] = 1  # the usual first-feasible groups are preemptible
        extra = dict(
            pod_priority=(
                rng.integers(0, 3, 203) * (rng.random(203) < 0.5)
            ).astype(np.int32),
            group_tier=tier,
        )
        if with_score:
            extra["pod_group_score"] = rng.integers(0, 4, (203, 37)).astype(
                np.float32
            )
        inputs = with_fields(random_inputs(rng, pods=203, types=37), **extra)
        ref = check_program(inputs, 16)
        plain = B.binpack(
            dataclasses.replace(inputs, pod_priority=None, group_tier=None),
            buckets=16,
        )
        assert not np.array_equal(
            np.asarray(plain.assigned), np.asarray(ref.assigned)
        )

    @pytest.mark.parametrize(
        "which",
        [
            ("pod_claim",),
            ("group_reservation",),
            ("pod_claim", "group_reservation"),
            ("pod_pack_class",),
            ("pod_spread_slot", "group_domain", "spread_cap"),
            (
                "pod_claim", "group_reservation", "pod_pack_class",
                "pod_spread_slot", "group_domain", "spread_cap",
            ),
        ],
        ids=["claim", "reservation", "claim+reservation", "pack_class",
             "spread", "all_six"],
    )
    def test_constraint_operand_parity(self, which):
        rng = np.random.default_rng(400 + len(which))
        inputs = with_fields(
            random_inputs(rng, pods=203, types=37),
            pod_weight=rng.integers(1, 6, 203).astype(np.int32),
            **constraint_fields(rng, 203, 37, which),
        )
        ref = check_program(inputs, 16)
        free = B.binpack(
            dataclasses.replace(inputs, **{k: None for k in which}),
            buckets=16,
        )
        changed = any(
            not np.array_equal(np.asarray(getattr(free, f)),
                               np.asarray(getattr(ref, f)))
            for f in OUTPUT_FIELDS
        )
        assert changed, "the constraint operands changed nothing"

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
        check_program(inputs, 8)
        assert TB.binpack(to_port(inputs), 8).assigned.tolist() == [1, 0]

    def test_all_unschedulable(self):
        inputs = make_inputs(pod_requests=[[9, 9]], group_allocatable=[[1, 1]])
        check_program(inputs, 8)
        out = TB.binpack(to_port(inputs), 8)
        assert out.assigned.tolist() == [-1]
        assert int(out.unschedulable) == 1

    def test_zero_allocatable_resource_with_zero_request(self):
        """A resource the group lacks but the pod does not request adds 0
        to the share; one it requests rules the group out."""
        inputs = make_inputs(
            pod_requests=[[1, 0], [1, 1]],
            group_allocatable=[[2, 0], [4, 4]],
        )
        check_program(inputs, 8)

    def test_bench_shaped_parity(self):
        """A cut of the bench's own problem (workloads.build_inputs)."""
        fields = workloads.build_inputs(2000, 60, 16, 16, seed=0)
        ref_inputs = B.BinPackInputs(
            **{k: jnp.asarray(v) for k, v in fields.items()}
        )
        ref = B.binpack(ref_inputs, buckets=32)
        assert_same(
            ref, TB.binpack(TB.inputs_from_numpy(fields, "cpu"), buckets=32)
        )


class TestShelfBFD:
    @pytest.mark.parametrize(
        "seed,buckets,high",
        [(0, 32, 40), (1, 32, 40), (2, 16, 400), (3, 8, 5000), (4, 32, 3)],
    )
    def test_matches_reference_and_oracle(self, seed, buckets, high):
        rng = np.random.default_rng(seed)
        hist = rng.integers(0, high, (9, buckets)).astype(np.int32)
        want = np.asarray(B._shelf_bfd(jnp.asarray(hist), buckets))
        got = TB._shelf_bfd(torch.from_numpy(hist), buckets)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            want, B.oracle_shelf_bfd(hist, buckets)
        )
        np.testing.assert_array_equal(
            TB.oracle_shelf_bfd(hist, buckets),
            B.oracle_shelf_bfd(hist, buckets),
        )

    def test_sparse_single_sizes(self):
        """One item size per group: every fill-pass count floor(B/k) is
        reached exactly when a group holds only small items."""
        buckets = 32
        hist = np.zeros((buckets, buckets), np.int32)
        for k in range(1, buckets + 1):
            hist[k - 1, k - 1] = 97
            hist[k - 1, buckets - 1] = 3  # full nodes first, no remnant
            hist[k - 1, (k * 7) % buckets] += 5
        np.testing.assert_array_equal(
            TB._shelf_bfd(torch.from_numpy(hist), buckets).numpy(),
            B.oracle_shelf_bfd(hist, buckets),
        )

    def test_oracle_ffd_copy(self):
        sizes = np.random.default_rng(5).uniform(0.01, 1.0, 60)
        assert TB.oracle_ffd(sizes) == B.oracle_ffd(sizes)


LANES = 32


def _warp_inclusive_scan(v):
    """The kernel's five __shfl_up_sync steps: lane l adds lane l - o's
    value when l >= o, for o = 1, 2, 4, 8, 16."""
    lane = np.arange(LANES)
    for o in (1, 2, 4, 8, 16):
        v = np.where(lane >= o, v + np.roll(v, o), v)
    return v


def _shfl_down(v, k):
    """__shfl_down_sync(v, k): lane l reads lane l + k, or keeps its own
    value when l + k is past the warp."""
    src = np.arange(LANES) + k
    return np.where(src < LANES, v[np.minimum(src, LANES - 1)], v)


def _open_bins(c, k, buckets):
    """The kernel's bin opening after the fill passes: (new nodes, remnant
    of the full bins, remnant of the partial bin or 0)."""
    per_bin = buckets // k
    full, leftover = divmod(c, per_bin)
    return (full + (leftover > 0), full, buckets - per_bin * k,
            buckets - leftover * k if leftover > 0 else 0)


def warp_shelf_row(row, buckets):
    """Lane-by-lane numpy emulation of csrc/shelf_bfd.cu for one group:
    (nodes, count, fill passes). B <= 32 follows shelf_bfd_warp_kernel (lane
    j holds the open bins of remnant j + 1); B > 32 follows
    shelf_bfd_wide_kernel (lane j owns the contiguous slots [j S, j S + S)
    of remnants s + 1). Early exits as in the kernels."""
    lane = np.arange(LANES)
    row = np.asarray(row, np.int64)
    passes = 0
    nodes = 0
    if buckets <= LANES:
        reg_row = np.zeros(LANES, np.int64)
        reg_row[:buckets] = row
        count = int(reg_row.sum())
        bins = np.zeros(LANES, np.int64)
        for k in range(buckets, 0, -1):
            c = int(reg_row[k - 1])  # __shfl_sync(row, k - 1)
            if c == 0:
                continue
            usable = lane + 1 >= k
            while True:
                avail = np.where(usable, bins, 0)
                incl = _warp_inclusive_scan(avail)
                total = int(incl[LANES - 1])
                if total == 0:
                    break
                passes += 1
                place = np.minimum(np.maximum(c - (incl - avail), 0), avail)
                moved = _shfl_down(place, k)
                bins = bins + np.where(lane + k < LANES, moved, 0) - place
                c -= min(c, total)
                if c == 0:
                    break
            if c > 0:
                new, full, full_rem, part_rem = _open_bins(c, k, buckets)
                nodes += new
                bins[lane + 1 == full_rem] += full
                bins[lane + 1 == part_rem] += 1
        return nodes, count, passes

    per_lane = -(-buckets // LANES)
    lo = np.minimum(lane * per_lane, buckets)
    hi = np.minimum(lo + per_lane, buckets)
    count = int(row.sum())
    bins = np.zeros(buckets, np.int64)  # slot s: remnant s + 1
    for k in range(buckets, 0, -1):
        c = int(row[k - 1])
        if c == 0:
            continue
        while True:
            mine = np.array([
                bins[max(lo[j], k - 1):hi[j]].sum() for j in range(LANES)
            ])
            incl = _warp_inclusive_scan(mine)
            total = int(incl[LANES - 1])
            if total == 0:
                break
            passes += 1
            place = np.zeros(buckets, np.int64)
            for j in range(LANES):  # each lane walks its own slots
                before = int(incl[j] - mine[j])
                for slot in range(lo[j], hi[j]):
                    avail = bins[slot] if slot + 1 >= k else 0
                    place[slot] = min(max(c - before, 0), avail)
                    before += avail
            # __syncwarp, then each slot takes what moved down k remnants
            shifted = np.zeros(buckets, np.int64)
            shifted[: buckets - k] = place[k:]
            bins = bins + shifted - place
            c -= min(c, total)
            if c == 0:
                break
        if c > 0:
            new, full, full_rem, part_rem = _open_bins(c, k, buckets)
            nodes += new
            if full_rem >= 1:
                bins[full_rem - 1] += full
            if part_rem >= 1:
                bins[part_rem - 1] += 1
    return nodes, count, passes


def main_path_histogram():
    """The main path's [300, 32] histogram (build_inputs(100000, 300, 64,
    64, seed=0)), by the plain fused stage over row chunks: integer sums,
    so chunking changes nothing and keeps the CPU's memory small."""
    from karpenter_tpu_torch.ops.fused_assign import fused_assign_reference

    fields = workloads.build_inputs(100_000, 300, 64, 64, seed=0)
    hist = torch.zeros((300, 32), dtype=torch.int32)
    for lo in range(0, 100_000, 10_000):
        chunk = {
            k: (v[lo: lo + 10_000] if k.startswith("pod_") else v)
            for k, v in fields.items()
        }
        hist += fused_assign_reference(TB.inputs_from_numpy(chunk, "cpu"), 32)[1]
    return hist.numpy()


class TestWarpShelfEmulation:
    """The warp algorithm of csrc/shelf_bfd.cu, emulated lane by lane,
    against the reference's scalar oracle."""

    @pytest.mark.parametrize("buckets", [1, 8, 16, 32, 33, 64])
    def test_matches_oracle(self, buckets):
        rng = np.random.default_rng(500 + buckets)
        hist = np.concatenate([
            rng.integers(0, 40, (6, buckets)),
            rng.integers(0, 4000, (3, buckets)),
            (rng.random((3, buckets)) < 0.2) * rng.integers(0, 90, (3, buckets)),
            np.zeros((1, buckets), np.int64),
        ]).astype(np.int32)
        want = B.oracle_shelf_bfd(hist, buckets)
        for t, row in enumerate(hist):
            nodes, count, passes = warp_shelf_row(row, buckets)
            assert nodes == want[t], (t, nodes, want[t])
            assert count == int(row.sum())
            # at most floor(B/k) placing passes per size
            assert passes <= sum(buckets // k for k in range(1, buckets + 1))

    def test_main_path_histogram(self):
        hist = main_path_histogram()
        assert int(hist.sum()) == 100_000
        want = B.oracle_shelf_bfd(hist, 32)
        assert int(want.sum()) == 20262  # the smoke's node total
        most = 0
        for t, row in enumerate(hist):
            nodes, count, passes = warp_shelf_row(row, 32)
            assert (nodes, count) == (want[t], int(row.sum())), t
            most = max(most, passes)
        assert most <= 47  # the heaviest group's fill passes


class TestSolveRouting:
    def test_cpu_torch_and_auto_match_reference(self):
        rng = np.random.default_rng(11)
        inputs = random_inputs(rng, pods=120, types=13)
        ref = B.binpack(inputs, buckets=16)
        port = to_port(inputs)
        assert_same(ref, TB.solve(port, 16, backend="torch", device="cpu"))
        assert_same(ref, TB.solve(port, 16, backend="auto", device="cpu"))

    def test_numpy_fields_accepted(self):
        rng = np.random.default_rng(12)
        inputs = random_inputs(rng, pods=50, types=6)
        numpy_inputs = TB.BinPackInputs(**to_fields(inputs))
        assert_same(
            B.binpack(inputs, buckets=8),
            TB.solve(numpy_inputs, 8, backend="torch", device="cpu"),
        )

    def test_cuda_backend_on_cpu_and_unknown_backend_raise(self):
        port = to_port(random_inputs(np.random.default_rng(1), 20, 4))
        with pytest.raises(ValueError, match="needs a CUDA device"):
            TB.solve(port, 8, backend="cuda", device="cpu")
        with pytest.raises(ValueError, match="unknown binpack backend"):
            TB.solve(port, 8, backend="pallas", device="cpu")

    def test_default_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        port = to_port(random_inputs(np.random.default_rng(2), 20, 4))
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            TB.solve(port)
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            TB.inputs_from_numpy(to_fields(
                random_inputs(np.random.default_rng(2), 5, 2)))

    def test_constraint_operands_reroute_and_count(self):
        rng = np.random.default_rng(13)
        inputs = with_fields(
            random_inputs(rng, pods=40, types=6),
            **constraint_fields(rng, 40, 6, ("pod_claim",)),
        )
        before = dict(TB.REROUTES)
        folded, backend = TB._fold_for_fused(to_port(inputs))
        assert backend == "torch"
        assert folded.pod_claim is not None
        assert TB.REROUTES["constraints"] == before["constraints"] + 1
        assert TB.REROUTES["score_and_steer"] == before["score_and_steer"]

    def test_score_plus_steer_reroutes_and_counts(self):
        rng = np.random.default_rng(14)
        inputs = with_fields(
            random_inputs(rng, pods=40, types=6),
            pod_priority=np.ones(40, np.int32),
            group_tier=np.arange(6, dtype=np.int32) % 2,
            pod_group_score=np.ones((40, 6), np.float32),
        )
        before = TB.REROUTES["score_and_steer"]
        _, backend = TB._fold_for_fused(to_port(inputs))
        assert backend == "torch"
        assert TB.REROUTES["score_and_steer"] == before + 1

    def test_priority_fold_keeps_the_assignment(self):
        """A score-free priority fleet folds steer into the score; the
        fused path on the folded inputs equals the reference's program on
        the priority inputs."""
        from karpenter_tpu_torch.ops.fused_assign import binpack_fused

        rng = np.random.default_rng(15)
        inputs = with_fields(
            random_inputs(rng, pods=203, types=37),
            pod_priority=rng.integers(0, 2, 203).astype(np.int32),
            group_tier=rng.integers(0, 2, 37).astype(np.int32),
        )
        before = dict(TB.REROUTES)
        folded, backend = TB._fold_for_fused(to_port(inputs))
        assert backend == "cuda" and TB.REROUTES == before
        assert folded.pod_priority is None and folded.group_tier is None
        np.testing.assert_array_equal(
            folded.pod_group_score.numpy(),
            B.steer_matrix(
                np.asarray(inputs.pod_priority), np.asarray(inputs.group_tier)
            ),
        )
        assert_same(B.binpack(inputs, buckets=16), binpack_fused(folded, 16))

    def test_plain_inputs_pass_through(self):
        port = to_port(random_inputs(np.random.default_rng(3), 20, 4))
        folded, backend = TB._fold_for_fused(port)
        assert folded is port and backend == "cuda"

    def test_device_resident_memo_is_identity_keyed(self):
        port = to_port(random_inputs(np.random.default_rng(4), 20, 4))
        cpu = torch.device("cpu")
        first = TB._device_resident(port, cpu)
        assert TB._device_resident(port, cpu) is first
        assert first.pod_requests is port.pod_requests  # already resident
        other = dataclasses.replace(port)
        assert TB._device_resident(other, cpu) is not first


class TestInputsFromNumpy:
    def test_dtypes_and_optional_fields(self):
        rng = np.random.default_rng(6)
        inputs = with_fields(
            random_inputs(rng, pods=30, types=5),
            pod_weight=np.arange(30, dtype=np.int32),
            pod_group_score=np.ones((30, 5), np.float32),
        )
        port = to_port(inputs)
        assert port.pod_requests.dtype == torch.float32
        assert port.pod_valid.dtype == torch.bool
        assert port.pod_intolerant.dtype == torch.bool
        assert port.pod_weight.dtype == torch.int32
        assert port.pod_group_score.dtype == torch.float32
        assert port.pod_exclusive is None and port.spread_cap is None
        for name, value in to_fields(inputs).items():
            np.testing.assert_array_equal(getattr(port, name).numpy(), value)

    def test_copies_and_rejects_unknown_fields(self):
        fields = to_fields(random_inputs(np.random.default_rng(7), 10, 3))
        fields["pod_requests"] = np.array(fields["pod_requests"])
        port = TB.inputs_from_numpy(fields, "cpu")
        fields["pod_requests"][0, 0] = -1.0
        assert float(port.pod_requests[0, 0]) != -1.0
        with pytest.raises(ValueError, match="unknown BinPackInputs"):
            TB.inputs_from_numpy({"pod_mass": np.zeros(3)}, "cpu")


class TestWorkloads:
    @pytest.mark.parametrize(
        "kwargs", [{}, {"affinity": 0.3}, {"anti": 0.2},
                   {"affinity": 0.5, "anti": 0.1}],
        ids=["plain", "affinity", "anti", "both"],
    )
    def test_matches_bench_array_for_array(self, kwargs):
        import bench

        ref = to_fields(bench.build_inputs(700, 40, 12, 9, seed=5, **kwargs))
        mine = workloads.build_inputs(700, 40, 12, 9, seed=5, **kwargs)
        assert set(mine) == set(ref)
        for name, value in ref.items():
            assert mine[name].dtype == value.dtype, name
            np.testing.assert_array_equal(mine[name], value, err_msg=name)


class TestPortIsStandalone:
    def test_no_jax_and_no_reference_imports(self):
        """The port and chip_smoke.py import neither jax nor anything of
        karpenter_tpu (the reference), at any depth of the code."""
        sources = sorted((REPO / "karpenter_tpu_torch").rglob("*.py"))
        sources.append(REPO / "chip_smoke.py")
        assert len(sources) > 5
        banned = re.compile(r"^(jax|jaxlib|karpenter_tpu)(\.|$)")
        for path in sources:
            tree = ast.parse(path.read_text(), filename=str(path))
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [alias.name for alias in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                for name in names:
                    assert not banned.match(name), f"{path}: imports {name}"
            text = path.read_text()
            assert "import_module(" not in text and "__import__(" not in text
