"""The comparison that decides `correct`, on hand-made answers."""

import numpy as np
import pytest

from portbench import judge

LIMITS = {"int_mismatches": 0, "unanswered": 0}
WANT = {"assigned": np.array([0, 2, -1], np.int32),
        "unschedulable": np.int32(1)}


def _answer(**changes):
    out = {k: np.array(v, copy=True) for k, v in WANT.items()}
    out.update(changes)
    return out


@pytest.mark.parametrize("answer,mismatches", [
    (_answer(), 0),
    (_answer(assigned=np.array([0, 1, -1])), 1),
    (_answer(unschedulable=np.int32(0)), 1),
    (_answer(assigned=np.array([0, 2])), 3),  # another shape: every element
    ({"unschedulable": np.int32(1)}, 3),  # a leaf left out: every element
])
def test_mismatches_are_counted_element_by_element(answer, mismatches):
    correct, checks = judge.judge([(answer, WANT)], 0, LIMITS)
    assert checks["int_mismatches"]["value"] == mismatches
    assert correct is (mismatches == 0)


def test_unanswered_and_nothing_judged_are_not_correct():
    assert judge.judge([(_answer(), WANT)], 1, LIMITS)[0] is False
    assert judge.judge([], 0, LIMITS)[0] is False


def test_float_leaves_are_refused():
    with pytest.raises(ValueError, match="float"):
        judge.judge([({"x": np.ones(2)}, {"x": np.ones(2)})], 0, LIMITS)
