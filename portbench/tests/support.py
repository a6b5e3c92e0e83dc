"""Helpers of the benchmark's own tests: cells shrunk to a size a CPU
test holds, and one harness run with the program on the CPU."""

import time

from portbench import harness

CELLS = ("binpack-100k-300.late-fit", "binpack-100k-300.early-fit")


def cell(name):
    return shrink(harness.find_cell(name))


def shrink(cell):
    """The cell at a size a CPU test holds: the same modules, mix and
    limits, fewer rows and types."""
    cell.config.update(pods=3000, types=40)
    cell.mix.update(pool_rows=1000, churn_rows=30)
    cell.mix["dedicated"] = [dict(g, types=6)
                             for g in cell.mix.get("dedicated", ())]
    return cell


def cpu_run(cell, seed=2**33 + 5, seconds=0.6, trace=False):
    """One run of the harness with the program on the CPU."""
    return harness.run(cell, seed, seconds, trace, device="cpu",
                       started=time.perf_counter(),
                       platform={"platform": "cpu", "kind": "cpu",
                                 "count": 1})
