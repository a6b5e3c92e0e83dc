"""Median ms of the cuda rung's launch: from the operands on the card to
the last op enqueued (the fold, the bit packing and operand checks, both
kernels' launches and the lp_bound tail; SolverService.stage_percentiles()
["launch"], its last 256), read from requests sent after the profiler's
span."""

from portbench import readers


def read(record):
    return readers.stage_p50_ms(record, "launch")
