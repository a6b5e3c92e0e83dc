"""The port's numpy rung (karpenter_tpu_torch/ops/numpy_binpack.py) against
the reference's (karpenter_tpu/ops/numpy_binpack.py), on the CPU.

The same seeded inputs (tests/test_numpy_binpack.py's draws, plus the
constraint plane and the priority pair) go through both packages'
`binpack_numpy`, with the C helper (each package's own build of the same
binpack_kernel.c) and with the pure-numpy stages forced, single-thread
and threaded. All five outputs must be EQUAL: the two are the same
arithmetic on the same bytes.

Against the port's plain torch program (ops/binpack.binpack on CPU
tensors) the rule is the reference's own numpy-vs-XLA contract:
assigned, assigned_count, nodes_needed and unschedulable exact;
lp_bound exact except where one f32 ulp of demand/allocatable exceeds
the shared 1e-5 ceil guard (ROADMAP Queue 3's f32 boundary), where it
may differ by one — and only at a group whose ratio lies within 1e-5
(relative) of an integer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu import native as ref_native
from karpenter_tpu.ops import numpy_binpack as ref_nb
from karpenter_tpu_torch import native as port_native
from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops import numpy_binpack as port_nb
from test_numpy_binpack import random_inputs
from test_torch_binpack import constraint_fields

OUTPUT_FIELDS = (
    "assigned", "assigned_count", "nodes_needed", "lp_bound", "unschedulable"
)


def port_inputs(ref_inputs, **extra):
    """The port's BinPackInputs holding the reference's numpy arrays (as
    the port's encoder hands them over), plus `extra` fields."""
    fields = {
        f.name: (None if getattr(ref_inputs, f.name) is None
                 else np.asarray(getattr(ref_inputs, f.name)))
        for f in dataclasses.fields(ref_inputs)
    }
    fields.update(extra)
    return TB.BinPackInputs(**fields)


def ref_inputs_of(port):
    from karpenter_tpu.ops.binpack import BinPackInputs

    return BinPackInputs(**{
        f.name: getattr(port, f.name) for f in dataclasses.fields(port)
    })


def assert_equal(got, want, what=""):
    """All five outputs equal, dtype included."""
    for name in OUTPUT_FIELDS:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, f"{what}{name}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}{name}")


def assert_plain_contract(got, inputs, buckets):
    """numpy rung vs the port's plain program on CPU tensors: integers
    exact, lp_bound exact but at the documented f32 boundary."""
    fields = {
        f.name: getattr(inputs, f.name) for f in dataclasses.fields(inputs)
        if getattr(inputs, f.name) is not None
    }
    plain = TB.binpack(TB.inputs_from_numpy(fields, "cpu"), buckets=buckets)
    for name in ("assigned", "assigned_count", "nodes_needed", "unschedulable"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), getattr(plain, name).numpy(),
            err_msg=name,
        )
    lp_got, lp_want = np.asarray(got.lp_bound), plain.lp_bound.numpy()
    for t in np.nonzero(lp_got != lp_want)[0]:
        assert abs(int(lp_got[t]) - int(lp_want[t])) == 1, t
        rows = np.asarray(got.assigned) == t
        w = (np.ones(rows.sum()) if inputs.pod_weight is None
             else np.asarray(inputs.pod_weight)[rows])
        demand = (np.asarray(inputs.pod_requests, np.float64)[rows]
                  * w[:, None]).sum(axis=0)
        alloc = np.asarray(inputs.group_allocatable, np.float64)[t]
        ratio = demand[alloc > 0] / alloc[alloc > 0]
        near = np.abs(ratio - np.round(ratio)) <= 1e-5 * np.maximum(1, ratio)
        assert near.any(), f"lp_bound differs away from an integer at {t}"


@pytest.fixture(scope="module", autouse=True)
def _helpers_loaded():
    """Both packages' C helpers built and loaded up front, so use_native
    runs the C pass (it never waits for a build mid-solve)."""
    ref_native.load_kbinpack()
    port_native.load_kbinpack()


def both(ref, port, buckets, native):
    got = port_nb.binpack_numpy(port, buckets=buckets, use_native=native)
    want = ref_nb.binpack_numpy(ref, buckets=buckets, use_native=native)
    assert_equal(got, want, f"native={native} ")
    return got


NATIVE = pytest.mark.parametrize("native", [True, False],
                                 ids=["c_helper", "numpy"])


class TestEquality:
    @NATIVE
    @pytest.mark.parametrize("seed", range(6))
    def test_weighted_random_fleets(self, seed, native):
        ref = random_inputs(seed)
        got = both(ref, port_inputs(ref), 16, native)
        assert_plain_contract(got, ref, 16)

    @NATIVE
    @pytest.mark.parametrize("seed", range(4))
    def test_affinity_masks_and_scores(self, seed, native):
        ref = random_inputs(seed + 100, with_forbidden=True, with_score=True)
        got = both(ref, port_inputs(ref), 16, native)
        assert_plain_contract(got, ref, 16)

    @NATIVE
    @pytest.mark.parametrize("seed", range(4))
    def test_exclusive_rows(self, seed, native):
        ref = random_inputs(
            seed + 400, with_exclusive=True,
            with_forbidden=(seed % 2 == 0), with_score=(seed % 3 == 0),
        )
        got = both(ref, port_inputs(ref), 16, native)
        assert_plain_contract(got, ref, 16)

    @NATIVE
    @pytest.mark.parametrize("seed", range(3))
    def test_unweighted_and_forbidden_only(self, seed, native):
        ref = random_inputs(seed + 200, with_weight=False, with_forbidden=True)
        got = both(ref, port_inputs(ref), 32, native)
        assert_plain_contract(got, ref, 32)

    @NATIVE
    def test_empty_fleet(self, native):
        ref = random_inputs(0, pods=0)
        got = both(ref, port_inputs(ref), 8, native)
        assert got.assigned.shape == (0,) and int(got.unschedulable) == 0

    @NATIVE
    def test_everything_unschedulable(self, native):
        ref = random_inputs(3)
        ref = dataclasses.replace(
            ref, pod_group_forbidden=np.ones(
                (ref.pod_requests.shape[0], ref.group_allocatable.shape[0]),
                bool,
            ),
        )
        got = both(ref, port_inputs(ref), 8, native)
        assert (np.asarray(got.assigned) == -1).all()

    @NATIVE
    @pytest.mark.parametrize("with_score", [False, True])
    def test_priority_steer(self, native, with_score):
        """The priority pair: score-free steering folds into the score
        (the C pass takes it); score plus steer is the two-stage choice,
        numpy stages only — in both packages."""
        rng = np.random.default_rng(17)
        ref = random_inputs(17, pods=203, groups=37, with_score=with_score)
        tier = rng.integers(0, 2, 37).astype(np.int32)
        tier[:2] = 1
        extra = dict(
            pod_priority=(rng.integers(0, 3, 203)
                          * (rng.random(203) < 0.5)).astype(np.int32),
            group_tier=tier,
        )
        ref = dataclasses.replace(ref, **extra)
        got = both(ref, port_inputs(ref), 16, native)
        assert_plain_contract(got, ref, 16)

    @NATIVE
    @pytest.mark.parametrize(
        "which",
        [("pod_claim", "group_reservation"), ("pod_pack_class",),
         ("pod_spread_slot", "group_domain", "spread_cap"),
         ("pod_claim", "group_reservation", "pod_pack_class",
          "pod_spread_slot", "group_domain", "spread_cap")],
        ids=["reservation", "pack_class", "spread", "all_six"],
    )
    def test_constraint_operands(self, native, which):
        """The constraint plane routes around the C pass in both
        packages; the port's mask is its ops/binpack.constraint_mask on
        CPU tensors."""
        rng = np.random.default_rng(400 + len(which))
        ref = random_inputs(400 + len(which), pods=240, groups=19)
        ref = dataclasses.replace(
            ref, **constraint_fields(rng, 240, 19, which)
        )
        got = both(ref, port_inputs(ref), 16, native)
        assert_plain_contract(got, ref, 16)

    def test_fit_boundary_shares(self):
        rng = np.random.default_rng(7)
        groups, buckets = 5, 16
        alloc = rng.uniform(4.0, 16.0, (groups, 3)).astype(np.float32)
        fractions = np.array(
            [1.0, 0.5, 1.0 / 16, 3.0 / 16, 0.999, 1.001], np.float32
        )
        n = len(fractions)
        port = TB.BinPackInputs(
            pod_requests=np.outer(fractions, alloc[0]).astype(np.float32),
            pod_valid=np.ones(n, bool),
            pod_intolerant=np.zeros((n, 4), bool),
            pod_required=np.zeros((n, 4), bool),
            group_allocatable=alloc,
            group_taints=np.zeros((groups, 4), bool),
            group_labels=np.ones((groups, 4), bool),
        )
        for native in (True, False):
            both(ref_inputs_of(port), port, buckets, native)

    def test_tensor_operands_read_on_the_host(self):
        """CPU tensors (inputs_from_numpy) give the same answer as the
        numpy arrays they came from."""
        ref = random_inputs(9, with_forbidden=True, with_exclusive=True)
        fields = {
            f.name: np.asarray(getattr(ref, f.name))
            for f in dataclasses.fields(ref)
            if getattr(ref, f.name) is not None
        }
        tensors = TB.inputs_from_numpy(fields, "cpu")
        assert_equal(
            port_nb.binpack_numpy(tensors, buckets=16),
            ref_nb.binpack_numpy(ref, buckets=16),
        )


class TestDispatcher:
    def test_numpy_backend_touches_no_device(self, monkeypatch):
        """solve(backend='numpy') runs the host program by name: no
        device is resolved (here, where the default device would raise),
        and the outputs are numpy arrays equal to the reference's."""
        ref = random_inputs(5)
        port = port_inputs(ref)

        def no_device(*args, **kwargs):
            raise AssertionError("the numpy backend resolved a device")

        monkeypatch.setattr(TB, "resolve_device", no_device)
        out = TB.solve(port, buckets=8, backend="numpy")
        assert all(isinstance(getattr(out, name), (np.ndarray, np.generic))
                   for name in OUTPUT_FIELDS)
        assert_equal(out, ref_nb.binpack_numpy(ref, buckets=8))

    def test_default_device_still_needs_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device resolves")
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            TB.solve(port_inputs(random_inputs(5)), buckets=8)


class TestLpBoundContract:
    def test_numpy_rungs_equal_at_f32_boundaries(self):
        """At demand/allocatable ratios where one f32 ulp exceeds the
        -1e-5 ceil guard, the two numpy rungs stay EQUAL (same f64
        accumulation, same f32 tail); against the plain program the
        documented +-1 rule holds."""
        rng = np.random.default_rng(11)
        pods, groups = 8192, 3
        port = TB.BinPackInputs(
            pod_requests=rng.uniform(0.4, 0.6, (pods, 3)).astype(np.float32),
            pod_valid=np.ones(pods, bool),
            pod_intolerant=np.zeros((pods, 4), bool),
            pod_required=np.zeros((pods, 4), bool),
            group_allocatable=np.full((groups, 3), 1000.0, np.float32),
            group_taints=np.zeros((groups, 4), bool),
            group_labels=np.ones((groups, 4), bool),
        )
        for native in (True, False):
            got = both(ref_inputs_of(port), port, 16, native)
            assert_plain_contract(got, port, 16)


class TestNativeKernel:
    """The port's C helper and its pure-numpy stages are interchangeable,
    and the helper equals the reference's build of the same source."""

    def test_sources_identical_but_comments(self):
        """The port's binpack_kernel.c is the reference's, token for
        token; only comments may differ."""
        import pathlib
        import re

        def code(path):
            text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
            text = re.sub(r"//[^\n]*", "", text)
            return text.split()

        ref = pathlib.Path(ref_native.__file__).parent / "binpack_kernel.c"
        port = pathlib.Path(port_native.__file__).parent / "binpack_kernel.c"
        assert code(port) == code(ref)
        assert len(code(port)) > 1000

    @pytest.mark.parametrize("seed", range(4))
    def test_native_equals_fallback(self, seed):
        if port_native.load_kbinpack() is None:
            pytest.skip("no C toolchain")
        port = port_inputs(random_inputs(
            seed + 300, with_forbidden=(seed % 2 == 0),
            with_score=(seed % 3 == 0), with_exclusive=(seed % 2 == 1),
        ))
        assert_equal(
            port_nb.binpack_numpy(port, buckets=16, use_native=True),
            port_nb.binpack_numpy(port, buckets=16, use_native=False),
        )

    def test_native_equals_reference_with_all_operands(self):
        if port_native.load_kbinpack() is None:
            pytest.skip("no C toolchain")
        ref = random_inputs(
            7, pods=997, taints=70, labels=70,  # >64: multi-word bitsets
            with_forbidden=True, with_score=True, with_exclusive=True,
        )
        got = both(ref, port_inputs(ref), 32, True)
        assert_plain_contract(got, ref, 32)


class TestThreadedAssign:
    """karpenter_assign_mt: the choice phase fans out over threads, every
    aggregate accumulates in pod order — bitwise equal to the single pass
    and to the reference's helper, for any thread count and operand mix."""

    @pytest.mark.parametrize("threads", [2, 3, 8])
    def test_bitwise_equal_to_single_pass(self, monkeypatch, threads):
        lib = port_native.load_kbinpack()
        ref_lib = ref_native.load_kbinpack()
        if lib is None or not hasattr(lib, "karpenter_assign_mt"):
            pytest.skip("native mt kernel unavailable")
        rng = np.random.default_rng(23)
        for case in range(8):
            P, T = int(rng.integers(1, 400)), int(rng.integers(1, 24))
            K, L = int(rng.integers(1, 100)), int(rng.integers(1, 100))
            args = dict(
                requests=rng.uniform(0, 2, (P, 4)).astype(np.float32),
                valid=rng.random(P) < 0.9,
                intolerant=rng.random((P, K)) < 0.1,
                required=rng.random((P, L)) < 0.1,
                alloc=rng.uniform(0, 4, (T, 4)).astype(np.float32),
                taints=rng.random((T, K)) < 0.2,
                labels=rng.random((T, L)) < 0.8,
                forbidden=(
                    rng.random((P, T)) < 0.2 if rng.random() < 0.5 else None
                ),
                score=(
                    rng.normal(size=(P, T)).astype(np.float32)
                    if rng.random() < 0.5 else None
                ),
                weight=(
                    rng.integers(1, 9, P).astype(np.int64)
                    if rng.random() < 0.5 else None
                ),
                exclusive=(rng.random(P) < 0.1 if rng.random() < 0.5
                           else None),
                buckets=int(rng.integers(2, 33)),
            )
            monkeypatch.setenv("KARPENTER_SOLVER_THREADS", "1")
            single = port_nb._assign_native(lib, **args)
            want = ref_nb._assign_native(ref_lib, **args)
            monkeypatch.setenv("KARPENTER_SOLVER_THREADS", str(threads))
            multi = port_nb._assign_native(lib, **args)
            for s, m, w in zip(single[:4], multi[:4], want[:4]):
                np.testing.assert_array_equal(np.asarray(s), np.asarray(m))
                np.testing.assert_array_equal(np.asarray(s), np.asarray(w))
            assert single[4] == multi[4] == want[4], case


class TestPackBits:
    """The C octet-gather packer vs the np.packbits fallback and vs the
    reference's packer, at every adversarial width."""

    def test_c_pack_equals_numpy_pack(self):
        lib = port_native.load_kbinpack()
        if lib is None:
            pytest.skip("native packer unavailable")
        rng = np.random.default_rng(5)
        for k in [1, 2, 7, 8, 9, 63, 64, 65, 127, 128, 129, 200]:
            for n in (0, 1, 3, 257):
                matrix = rng.random((n, k)) < 0.4
                got = port_nb._pack_bits(matrix, lib)
                np.testing.assert_array_equal(
                    got, port_nb._pack_bits(matrix, None),
                    err_msg=f"n={n} k={k}",
                )
                np.testing.assert_array_equal(
                    got, ref_nb._pack_bits(matrix, None),
                    err_msg=f"n={n} k={k} vs reference",
                )
        big = rng.random((64, 70)) < 0.5
        view = big[::2]
        assert not view.flags.c_contiguous
        np.testing.assert_array_equal(
            port_nb._pack_bits(view, lib),
            port_nb._pack_bits(np.ascontiguousarray(view), None),
        )
        ints = (rng.random((5, 66)) < 0.5).astype(np.int64)
        np.testing.assert_array_equal(
            port_nb._pack_bits(ints, lib), port_nb._pack_bits(ints != 0, None)
        )
