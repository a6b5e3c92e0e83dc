"""Median ms the cuda rung's worker waits in the stream synchronize after
the last launch (SolverService.stage_percentiles()["sync"], its last 256),
read from requests sent after the profiler's span."""

from portbench import readers


def read(record):
    return readers.stage_p50_ms(record, "sync")
