"""The roofline's counts against hand-counted small cases."""

import numpy as np

from portbench.reference import roofline


def _fields(pods, groups, taints=64, labels=64, valid=None):
    return {
        "pod_requests": np.ones((pods, 3), np.float32),
        "pod_valid": np.ones(pods, bool) if valid is None else valid,
        "pod_intolerant": np.zeros((pods, taints), bool),
        "pod_required": np.zeros((pods, labels), bool),
        "group_allocatable": np.ones((groups, 3), np.float32),
    }


def test_fused_assign_counts():
    # 2 valid rows, 3 groups, R = 3, one word each of taints and labels:
    # row 0 fits group 1 (2 visits), row 1 fits none (3 visits): 5 visits
    # of R + 2 words = 25 operations, plus one assigned row's 3 R + 6 = 15
    fields = _fields(2, 3)
    hist = np.zeros((3, 4), np.int32)
    cost = roofline.kernel_cost(fields, 4, np.array([1, -1]), hist)
    ops, nbytes = cost["fused_assign"]
    assert ops == 40
    # rows: 2 x (12 + 1 + 16 + 4); groups in: 3 x (12 + 16); out: 3 x (16 + 12)
    assert nbytes == 66 + 84 + 84


def test_invalid_rows_visit_nothing_and_words_round_up():
    fields = _fields(2, 3, taints=65, labels=1, valid=np.array([True, False]))
    cost = roofline.kernel_cost(fields, 4, np.array([0, -1]),
                                np.zeros((3, 4), np.int32))
    # K = 65 packs into 2 words, L = 1 into 1: one visit of R + 3 words,
    # plus one assigned row's 15
    assert cost["fused_assign"][0] == 6 + 15


def test_shelf_counts():
    # B = 4, one item of size 4: one visit of the full-bin slot (5), then
    # one bin opening (10)
    assert roofline.shelf_ops(np.array([[0, 0, 0, 1]]), 4) == 15
    # two items of size 2: no open bin (visits of slots 2, 3, 4: 15), one
    # opening (10)
    assert roofline.shelf_ops(np.array([[0, 2, 0, 0]]), 4) == 25
    cost = roofline.kernel_cost(_fields(1, 2), 4, np.array([0]),
                                np.array([[0, 0, 0, 1], [0, 0, 0, 0]]))
    assert cost["shelf_bfd"] == (15, 2 * (16 + 4))


def test_least_seconds_takes_the_larger_bound():
    assert roofline.least_seconds(0, 3.35e12) == 1.0
    assert roofline.least_seconds(67e12, 1) == 1.0
    assert roofline.least_seconds(67e12, 6.7e12) == 2.0
