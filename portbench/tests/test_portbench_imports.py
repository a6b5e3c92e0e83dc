"""No module a run imports has the top-level name jax, jaxlib, flax or
karpenter_tpu (compared whole: karpenter_tpu_torch is the port)."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import harness, run

_CHILD = """
import json, sys, time
from portbench import harness, run
from portbench.tests import support
for name in support.CELLS:
    support.cpu_run(support.cell(name), seconds=0.3, trace=True)
print(json.dumps(run.forbidden_modules()))
"""


def test_a_run_loads_no_forbidden_module():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_the_top_level_whole(monkeypatch):
    for name in ("karpenter_tpu_torch.fake", "karpenter_tpu_like", "jaxlike",
                 "karpenter_tpu.fake", "jax.numpy"):
        monkeypatch.setitem(sys.modules, name, object())
    found = set(run.forbidden_modules())
    assert {"karpenter_tpu.fake", "jax.numpy"} <= found
    assert not {"karpenter_tpu_torch.fake", "karpenter_tpu_like",
                "jaxlike"} & found


@pytest.mark.parametrize("path", sorted(
    p for p in harness.PKG.rglob("*.py") if "__pycache__" not in p.parts))
def test_no_source_imports_a_forbidden_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in run.FORBIDDEN, (path, name)


@pytest.mark.parametrize("path", sorted(
    p for p in (harness.PKG / "reference").glob("*.py")))
def test_references_import_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            for name in names:
                assert not name.startswith("karpenter_tpu"), (path, name)
                assert name.split(".")[0] != "torch", (path, name)
