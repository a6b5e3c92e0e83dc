"""The HA fleet cell (`ha-fleet-10000.forecast`) at a size a CPU test
holds: its modules are found by name, a run is correct, a flipped low bit
of one float leaf is caught, the control is not correct, the traced run's
span readers read the program's spans, the generator's replay equals what
was sent, and a run loads no forbidden module."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import control, harness, judge
from portbench.tests import support

CELL = "ha-fleet-10000.forecast"


def fleet_cell():
    """The cell shrunk: 256 HAs, 96 series of 16 samples, 8 pool groups
    of 4, two clients ticking fast enough for a few ticks a run."""
    cell = harness.find_cell(CELL)
    cell.config.update(has=256, series=96, history=16, groups=8)
    cell.mix.update(clients=2, rate_per_s=20)
    return cell


def test_modules_found_by_name():
    cell = harness.find_cell(CELL)
    assert cell.module("entry").__file__.endswith(
        "entries/service_fused_tick.py")
    assert cell.module("generator").__file__.endswith(
        "generators/fleet_tick.py")
    assert cell.module("reference").__file__.endswith(
        "reference/fleet_tick.py")
    names = {m["name"] for m in cell.per_layer}
    assert {"fused_tick_upload_ms.fleet", "fused_tick_replay_ms.fleet",
            "fused_tick_fetch_ms.fleet", "fused_tick_device_ms.fleet",
            "fused_tick_roofline.fleet", "fused_tick_captures.fleet"} == names
    assert [m["name"] for m in cell.end_to_end] == ["kernel_ms_per_solve",
                                                    "setup_s"]
    assert cell.config["reduced"] == [] and cell.chips == 1


def test_shrunk_run_is_correct():
    out = support.cpu_run(fleet_cell())
    assert out.result["correct"] is True, out.result["checks"]
    assert out.result["failed"] == 0 and out.result["attempted"] >= 4
    assert out.result["checks"]["int_mismatches"]["value"] == 0


def test_traced_run_reads_the_program_spans():
    out = support.cpu_run(fleet_cell(), trace=True)
    metrics = out.result["metrics"]
    for stage in ("upload", "replay", "fetch"):
        assert metrics[f"fused_tick_{stage}_ms.fleet"]["value"] > 0, stage
    # the CPU has no graph and no device events
    assert metrics["fused_tick_captures.fleet"]["value"] == 0
    assert "fused_tick_device_ms.fleet" not in metrics
    assert "fused_tick_roofline.fleet" not in metrics


@pytest.mark.parametrize("stage,leaf", [("forecast", "point"),
                                        ("cost", "expected_hourly"),
                                        ("decision", "able_at")])
def test_one_flipped_low_bit_is_caught(stage, leaf):
    cell = fleet_cell()
    gen = cell.traffic(2**33 + 7)
    reference = cell.module("reference")
    ops = gen.replay(0, [1])[1]
    want = reference.answer(cell.config, ops)
    got = {s: {n: np.array(x, copy=True) for n, x in leaves.items()}
           for s, leaves in want.items()}
    assert judge.int_mismatches(got, want) == 0
    assert got[stage][leaf].dtype == np.int32  # a float leaf, as its bits
    got[stage][leaf].flat[0] ^= 1
    assert judge.int_mismatches(got, want) == 1


@pytest.mark.parametrize("seed", [7, 2**31 + 9, 2**45 + 1])
def test_control_is_not_correct(seed):
    checks = control.readings(fleet_cell(), seed, 20)
    assert checks["int_mismatches"]["value"] > 0, checks


@pytest.mark.parametrize("seed", [3, 2**40 + 11])
def test_replay_equals_what_was_sent(seed):
    gen = fleet_cell().traffic(seed)
    sent = {}
    for k in range(4):
        gen.update(1, k)
        sent[k] = json.dumps(_listed(gen.operands(1)), sort_keys=True)
    replayed = gen.replay(1, [0, 2, 3])
    assert sorted(replayed) == [0, 2, 3]
    for k, ops in replayed.items():
        assert json.dumps(_listed(ops), sort_keys=True) == sent[k], k
    # each tick moves time on by tick_s and slides every window by one
    first, last = replayed[0], replayed[3]
    assert last["decision"]["now"] - first["decision"]["now"] == 30.0
    np.testing.assert_array_equal(last["forecast"]["values"][:, :-3],
                                  first["forecast"]["values"][:, 3:])


def _listed(tree):
    if isinstance(tree, dict):
        return {k: _listed(v) for k, v in tree.items()}
    if tree is None:
        return None
    a = np.asarray(tree)
    return [str(a.dtype), a.tolist()]


_CHILD = """
import json
from portbench import run
from portbench.tests import support, test_portbench_fleet as F
support.cpu_run(F.fleet_cell(), seconds=0.3, trace=True)
print(json.dumps(run.forbidden_modules()))
"""


def test_a_run_loads_no_forbidden_module():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
