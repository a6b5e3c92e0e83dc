"""Median ms of the cuda rung's upload: the C-order host copy and the
pageable host-to-device copy of every operand, up to the operands on the
card (SolverService.stage_percentiles()["upload"], its last 256), read
from requests sent after the profiler's span."""

from portbench import readers


def read(record):
    return readers.stage_p50_ms(record, "upload")
