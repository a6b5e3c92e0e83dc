#!/usr/bin/env python3
"""A capture's cost with every thread's ranges against the capturing
thread's only, on the card.

Usage (from the repo root, on a machine with a CUDA card):
    python3 hack/capture_threads_ab.py [TURNS]

Runs chip_smoke.py's phase 13 (c), the controller binary twice over a
10,000-pod data dir with `--profiler-port`, each run captured over its
first tick (GET /profile, then /debug/profile after the restart), in
turns: the capturing thread only, every thread, every thread, the
capturing thread only, and so on for TURNS turns (default 4). The
capturing-thread-only arm sets observability/profiler.py's probe to
False in every process of the turn, through a sitecustomize module
written into a temporary directory that leads PYTHONPATH. Each turn
prints the binary runs' report lines: a capture's seconds, bytes and
`solver.*` ranges, the profiler server's start and the manager tick
under the capture, with the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SITECUSTOMIZE = """\
import os
if os.environ.get("KARPENTER_CAPTURE_ONE_THREAD"):
    from karpenter_tpu_torch.observability import profiler
    profiler._ALL_THREADS = False
"""

CHILD = (
    "import time, chip_smoke as S; from karpenter_tpu_torch import workloads; "
    "from karpenter_tpu_torch.utils.device import card_info; "
    "S.CARD['line'] = card_info()['line']; t0 = time.perf_counter(); "
    "S._runtime_binary(workloads); "
    "print('binary runs', time.perf_counter() - t0, 's')"
)


def _turn(turn: int, path: str) -> int:
    """One turn's binary runs; prints their report lines, returns the
    child's exit code."""
    one = turn % 4 in (0, 3)
    env = dict(os.environ, PYTHONPATH=path)
    env.pop("KARPENTER_CAPTURE_ONE_THREAD", None)
    if one:
        env["KARPENTER_CAPTURE_ONE_THREAD"] = "1"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    arm = "capturing thread only" if one else "all threads"
    print(f"=== turn {turn} {arm}: rc {proc.returncode}, "
          f"{time.perf_counter() - t0} s", flush=True)
    for line in proc.stdout.splitlines():
        if "profile" in line or "binary runs" in line:
            print(line, flush=True)
    if proc.returncode:
        print(proc.stderr[-3000:], flush=True)
    return proc.returncode


def main(argv) -> int:
    turns = int(argv[0]) if argv else 4
    with tempfile.TemporaryDirectory(prefix="capture-ab-") as site:
        with open(os.path.join(site, "sitecustomize.py"), "w") as fh:
            fh.write(SITECUSTOMIZE)
        path = os.pathsep.join(
            p for p in (site, REPO, os.environ.get("PYTHONPATH")) if p)
        failed = sum(_turn(turn, path) != 0 for turn in range(turns))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
