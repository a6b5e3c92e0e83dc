"""Everything a cell uses is found by name, and a new configuration, mix,
behaviour of traffic, reference, cell and metric are new files plus new
entries, with no edit to a file that is there."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests import support

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(name):
    cell = harness.find_cell(name)
    assert hasattr(cell.module("entry"), "Entry")
    assert hasattr(cell.module("generator"), "Traffic")
    reference = cell.module("reference")
    assert callable(reference.answer) and callable(reference.control)
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize(
    "kind,name",
    [("end_to_end", m["name"]) for m in BENCH["end_to_end"]]
    + [("layer_metrics", m["name"]) for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(kind, name):
    reader = harness.load_module(harness.PKG / kind / f"{name}.py")
    assert callable(reader.read)


def test_config_files_and_reduced_keys():
    for config in BENCH["configs"]:
        data = json.loads((ROOT / config["file"]).read_text())
        assert config["file"].startswith("portbench/")
        assert data["source"] == config["source"]
        assert data["reduced"] == config["reduced"]
        assert "limits" in data and "guarantees" in data


def test_per_layer_cells_report_the_metric_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for metric in BENCH["per_layer"]:
        moved = e2e[metric["moves"]]
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", [cell])


_ADDED = """
import json, sys, time
from portbench import harness
cell = harness.find_cell(sys.argv[1])
out = harness.run(cell, 77, 0.5, False, device="cpu",
                  started=time.perf_counter(),
                  platform={"platform": "cpu", "kind": "cpu", "count": 1})
print(json.dumps(out.result))
"""

# a generator of new behaviour: the tiny configuration's draw, with a
# third of each snapshot's rows invalid (pods already bound)
_GENERATOR = """
import numpy as np
from portbench import traffic
from portbench.generators import binpack_churn


class Traffic(binpack_churn.Traffic):
    def _draw(self, pods, seq, stream):
        fields = super()._draw(pods, seq, stream)
        rng = np.random.default_rng(traffic.seed_sequence(self.seed, 9, stream))
        fields["pod_valid"] = rng.random(pods) >= 1 / 3
        return fields
"""

# a reference of its own: the bin-pack reference, which leaves a note of
# each request it answered, and refuses a snapshot with no bound rows
_REFERENCE = """
from pathlib import Path

from portbench.reference import binpack
from portbench.reference.binpack import NOT_COMPARED, control, work


def answer(config, ops):
    bound = int((~ops["pod_valid"]).sum())
    assert bound > 0, "the mix's own generator did not run"
    with open(Path(__file__).with_suffix(".seen"), "a") as f:
        f.write(f"{bound}\\n")
    return binpack.answer(config, ops)
"""


def _copy_with(tmp_path, files, configs=(), cells=(), end_to_end=()):
    """A checkout of the benchmark with `files` ({path: text}) added and
    the entries appended to BENCHMARK.json; asserts that no file that was
    there changed once the test is done, via the returned check."""
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copytree(harness.PKG, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(copy): p.read_bytes()
              for p in (copy / "portbench").rglob("*") if p.is_file()}
    for path, text in files.items():
        assert not (copy / path).exists(), path
        (copy / path).write_text(text)
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + list(configs)
    bench["workloads"] = BENCH["workloads"] + list(cells)
    bench["end_to_end"] = BENCH["end_to_end"] + list(end_to_end)
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    def unchanged():
        after = {p.relative_to(copy): p.read_bytes()
                 for p in (copy / "portbench").rglob("*")
                 if p.is_file() and "__pycache__" not in p.parts}
        return all(after[path] == data for path, data in before.items()
                   if "__pycache__" not in path.parts)
    return copy, unchanged


def _run_in(copy, cell):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _ADDED, cell], cwd=copy,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _tiny_config():
    config = json.loads(
        (harness.PKG / "configs" / "binpack-100k-300.json").read_text())
    config.update(pods=2000, types=30)
    return json.dumps(config)


_TINY_CONFIG = {"name": "tiny-binpack", "source": "https://example.org/tiny",
                "file": "portbench/configs/tiny-binpack.json",
                "reduced": [], "why": "a test"}


def test_added_config_mix_cell_and_metric_run_without_edits(tmp_path):
    """A copy of the benchmark gains a configuration, a mix of new
    behaviour given as data alone (a dense forbidden operand, two groups
    of dedicated types), a cell and an end-to-end metric as new files and
    entries in BENCHMARK.json; the copy's harness runs the new cell
    correct with no other edit."""
    mix = {"clients": 2, "rate_per_s": 1000, "churn_rows": 20,
           "pool_rows": 500, "sample_per_client": 1, "affinity": 0.3,
           "dedicated": [
               {"name": "gpu", "share": 0.2, "types": 4, "taint": 63,
                "label": 63},
               {"name": "licensed", "share": 0.1, "types": 3, "taint": 62,
                "label": 62}]}
    copy, unchanged = _copy_with(
        tmp_path,
        {"portbench/configs/tiny-binpack.json": _tiny_config(),
         "portbench/mixes/tiny-mix.json": json.dumps(mix),
         "portbench/end_to_end/tiny_count.py":
             "def read(record):\n    return float(len(record['calls']))\n"},
        configs=[_TINY_CONFIG],
        cells=[{"name": "tiny-binpack.tiny-mix", "config": "tiny-binpack",
                "traffic": "tiny-mix", "chips": 1, "why": "a test"}],
        end_to_end=[{"name": "tiny_count", "unit": "calls",
                     "better": "higher", "bound": 0.1,
                     "source": "host_clock",
                     "workloads": ["tiny-binpack.tiny-mix"]}])
    result = _run_in(copy, "tiny-binpack.tiny-mix")
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["tiny_count"]["value"] > 0
    assert "setup_s" in result["metrics"]
    assert unchanged()


def test_added_mix_with_its_own_generator_and_reference(tmp_path):
    """A mix whose traffic needs new code names a generator and a
    reference of its own, new files beside the others; the harness loads
    them by the mix's names and the cell runs correct with no edit."""
    mix = {"clients": 2, "rate_per_s": 1000, "churn_rows": 20,
           "pool_rows": 500, "sample_per_client": 1,
           "generator": "tiny_bound_rows", "reference": "tiny_counting"}
    copy, unchanged = _copy_with(
        tmp_path,
        {"portbench/configs/tiny-binpack.json": _tiny_config(),
         "portbench/mixes/bound-rows.json": json.dumps(mix),
         "portbench/generators/tiny_bound_rows.py": _GENERATOR,
         "portbench/reference/tiny_counting.py": _REFERENCE},
        configs=[_TINY_CONFIG],
        cells=[{"name": "tiny-binpack.bound-rows", "config": "tiny-binpack",
                "traffic": "bound-rows", "chips": 1, "why": "a test"}])
    result = _run_in(copy, "tiny-binpack.bound-rows")
    assert result["correct"] is True, result["checks"]
    assert unchanged()
    # the mix's reference judged the checked answers, and each snapshot
    # had about a third of its 2,000 rows bound, as its generator draws
    seen = (copy / "portbench/reference/tiny_counting.seen").read_text()
    bound = [int(n) for n in seen.split()]
    assert len(bound) == 2 and all(550 < n < 780 for n in bound), bound


def test_run_without_card_exits_nonzero_and_prints_no_result():
    """The measuring path never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         support.CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_without_the_program_exits_nonzero(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files:
    no result, a non-zero exit."""
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         support.CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
