"""On a card: each cell runs end to end through the command the check
calls, and comes out correct. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import support


@pytest.mark.cuda
@pytest.mark.parametrize("name", support.CELLS)
def test_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name,
         "--seed", str(2**31 + 77), "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    reported = {m["name"] for m in harness.find_cell(name).end_to_end}
    assert reported == set(result["metrics"]), result["metrics"]
