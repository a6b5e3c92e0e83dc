#!/usr/bin/env python3
"""Captures beside a busy solve worker, in many processes, on the card.

Usage (from the repo root, on a machine with a CUDA card):
    python3 hack/capture_stress.py [ROUNDS]

Each round starts two processes in turn, one whose captures record every
thread's ranges and one whose captures record the capturing thread's
only (observability/profiler.py's probe set to False). Each process
builds a `SolverService()` on the card, solves the 20,000-pod x 300-group
draw four times, warms the profiler, then has a client thread solve in a
loop while the main thread takes a 2 s `capture_chrome_trace`, and closes
the service. The script prints each process's exit code, its solves and
the `solver.*` ranges in its capture, and any crash line (glibc's heap
checks, an abort, a segfault), and exits 1 unless every process exited 0
and only the every-thread captures held ranges.
"""

from __future__ import annotations

import collections
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, sys, threading, time
import torch
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.observability import profiler as P
from karpenter_tpu_torch.ops.binpack import inputs_from_numpy
from karpenter_tpu_torch.solver import SolverService

if sys.argv[1] == "one":
    P._ALL_THREADS = False
inputs = inputs_from_numpy(workloads.build_inputs(20_000, 300, 64, 64, 0))
service = SolverService()
for _ in range(4):
    service.solve(inputs)
torch.cuda.synchronize()
stop = threading.Event()
solves = []

def client():
    while not stop.is_set():
        service.solve(inputs)
        solves.append(1)

P._warm_up()
thread = threading.Thread(target=client)
thread.start()
time.sleep(0.3)
body = P.capture_chrome_trace(2000)
stop.set()
thread.join()
service.close()
events = json.loads(body)["traceEvents"]
ranges = sum(str(e.get("name", "")).startswith("solver.") for e in events)
print("RESULT", len(solves), ranges, flush=True)
"""

CRASH = ("double free", "corruption", "Abort", "Segmentation", "core dumped")


def _process(mode: str):
    """(exit code, solves, solver.* ranges, crash lines) of one process."""
    proc = subprocess.run([sys.executable, "-c", CHILD, mode], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    result = [line.split()[1:] for line in proc.stdout.splitlines()
              if line.startswith("RESULT")]
    crash = [line for line in (proc.stdout + proc.stderr).splitlines()
             if any(word in line for word in CRASH)]
    solves, ranges = (int(x) for x in result[0]) if result else (-1, -1)
    return proc.returncode, solves, ranges, crash


def main(argv) -> int:
    rounds = int(argv[0]) if argv else 8
    outcomes = collections.Counter()
    bad = 0
    for i in range(rounds):
        for mode in ("all", "one"):
            t0 = time.perf_counter()
            rc, solves, ranges, crash = _process(mode)
            ok = (rc == 0 and solves >= 0 and not crash
                  and (ranges > 0) == (mode == "all"))
            bad += not ok
            outcomes[(mode, rc)] += 1
            print(f"round {i} {mode}: rc {rc}, {time.perf_counter() - t0} s, "
                  f"{solves} solves, {ranges} solver.* ranges, crash lines "
                  f"{crash}", flush=True)
    print(f"exit codes by arm: {dict(outcomes)}; {bad} bad", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
