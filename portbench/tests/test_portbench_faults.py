"""Each fault a cell can have, planted under the timed path, makes the
run's `correct` come out false. The harness's look for a card is skipped
(the program runs on the CPU); the rest of the run is the benchmark's.
One card: no exchange between chips to leave out."""

import dataclasses

import numpy as np
import pytest

from portbench.tests import support


def _stale_solve(solve):
    """A step that returns its state unchanged: every request of a shape
    answered with the service's first answer for it."""
    first = {}

    def broken(self, inputs, *args, **kwargs):
        key = inputs.pod_requests.shape
        if key not in first:
            first[key] = solve(self, inputs, *args, **kwargs)
        return first[key]
    return broken


def _half_solve(solve):
    """Half of the batch left out: the second half of the rows is never
    looked at (solved as if invalid)."""
    def broken(self, inputs, *args, **kwargs):
        valid = np.array(inputs.pod_valid, copy=True)
        valid[len(valid) // 2:] = False
        return solve(self, dataclasses.replace(inputs, pod_valid=valid),
                      *args, **kwargs)
    return broken


def _altered_solve(solve):
    """An answer altered where it is produced: one row moved to another
    group."""
    def broken(self, inputs, *args, **kwargs):
        out = solve(self, inputs, *args, **kwargs)
        assigned = np.array(out.assigned, copy=True)
        assigned[0] = assigned[0] + 1
        return dataclasses.replace(out, assigned=assigned)
    return broken


FAULTS = {"state unchanged": _stale_solve, "half left out": _half_solve,
          "answer altered": _altered_solve}


@pytest.mark.parametrize("name", support.CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_not_correct(name, fault, monkeypatch):
    from karpenter_tpu_torch.solver.service import SolverService

    cell = support.cell(name)
    monkeypatch.setattr(SolverService, "solve",
                        FAULTS[fault](SolverService.solve))
    out = support.cpu_run(cell)
    assert out.result["correct"] is False, (fault, out.result["checks"])
