"""The plain reference equals the port's own CPU paths on tiny draws of
the configuration, traffic included (with and without dedicated types,
and with a dense forbidden operand); it refuses operands it has no
semantics for; the vectorized shelf count equals the item-by-item one."""

import numpy as np
import pytest

from portbench.reference import binpack as RB
from portbench.tests import support

VARIANTS = {
    "late-fit": {},
    "no dedicated types": {"dedicated": []},  # every pod fits early
    "forbidden rows": {"affinity": 0.3},
    "two dedicated groups": {"dedicated": [
        {"name": "gpu", "share": 0.2, "types": 5, "taint": 63, "label": 63},
        {"name": "licensed", "share": 0.1, "types": 4, "taint": 62,
         "label": 62}]},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("seed", [3, 2**40 + 11])
def test_binpack_reference_equals_the_port_on_cpu(variant, seed):
    from karpenter_tpu_torch.ops import binpack as B
    from karpenter_tpu_torch.solver.service import SolverService

    cell = support.cell("binpack-100k-300.late-fit")
    cell.mix.update(VARIANTS[variant])
    gen = cell.traffic(seed)
    svc = SolverService(device="cpu")
    try:
        for c in range(2):
            for k, ops in gen.replay(c, [0, 3]).items():
                want = RB.binpack_reference(ops, 32)
                plain = B.binpack(B.inputs_from_numpy(ops, "cpu"), 32)
                served = svc.solve(B.BinPackInputs(**ops), buckets=32)
                for field in RB.OUTPUTS:
                    np.testing.assert_array_equal(
                        getattr(plain, field).numpy(), want[field])
                    np.testing.assert_array_equal(
                        np.asarray(getattr(served, field)), want[field])
    finally:
        svc.close()


def test_reference_refuses_operands_it_has_no_semantics_for():
    cell = support.cell("binpack-100k-300.late-fit")
    ops = dict(cell.traffic(1).operands(0))
    ops["pod_exclusive"] = np.zeros(len(ops["pod_valid"]), bool)
    with pytest.raises(ValueError, match="pod_exclusive"):
        RB.answer(cell.config, ops)


def test_late_fit_rows_scan_past_the_general_types():
    cell = support.cell("binpack-100k-300.late-fit")
    ops = cell.traffic(5).operands(0)
    acc = cell.mix["dedicated"][0]
    first = cell.config["types"] - acc["types"]
    want = RB.binpack_reference(ops, 32)
    gpu = ops["pod_required"][:, acc["label"]]
    assert 0.15 < gpu.mean() < 0.35
    assigned = want["assigned"]
    assert np.all(assigned[gpu & (assigned >= 0)] >= first)
    assert np.all(assigned[~gpu & (assigned >= 0)] < first)


def test_shelf_nodes_equals_item_by_item():
    rng = np.random.default_rng(0)
    for buckets in (1, 4, 7, 32):
        hist = rng.integers(0, 40, (25, buckets)) * (
            rng.random((25, buckets)) < 0.5)
        np.testing.assert_array_equal(
            RB.shelf_nodes(hist, buckets), RB.shelf_nodes_scalar(hist, buckets))


def test_shelf_nodes_hand_counted():
    # B = 4: three items of size 2 -> two items per bin: 2 bins; one item
    # of size 3 and one of size 1 share a bin: 1 bin
    assert RB.shelf_nodes(np.array([[0, 3, 0, 0]]), 4).tolist() == [2]
    assert RB.shelf_nodes(np.array([[1, 0, 1, 0]]), 4).tolist() == [1]


def test_bf16_rounding():
    # ties to even: 1 + 2**-8 -> 1; 1 + 3 * 2**-8 -> 1 + 2**-6; past
    # bfloat16's largest finite value -> inf
    x = np.array([1.0, 1.00390625, 1.01171875, 3.4e38, -2.5], np.float32)
    np.testing.assert_array_equal(
        RB.to_bf16(x), np.array([1.0, 1.0, 1.015625, np.inf, -2.5],
                                np.float32))
