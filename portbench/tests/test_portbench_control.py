"""The control of `correct` (the reference one precision down, in the
program's place) comes out as not correct, on three seeds of each cell,
at a size a test holds; the program's own answers come out correct."""

import pytest

from portbench import control
from portbench.tests import support


@pytest.mark.parametrize("name", support.CELLS)
@pytest.mark.parametrize("seed", [7, 2**31 + 9, 2**45 + 1])
def test_control_is_not_correct(name, seed):
    checks = control.readings(support.cell(name), seed, 20)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


@pytest.mark.parametrize("name", support.CELLS)
def test_the_program_is_correct(name):
    out = support.cpu_run(support.cell(name))
    assert out.result["correct"] is True, out.result["checks"]
    assert out.result["failed"] == 0
    assert list(out.result)[-1] == "checks"
