"""Median ms of the solve service's cuda-rung dispatch: the host copy and
upload of the operands, the bit packing, both kernels and the stream sync
(SolverService.stage_percentiles()["dispatch"], its last 256), read from
requests sent after the profiler's span, so the profiler's cost is not
in it."""

from portbench import readers


def read(record):
    return readers.stage_p50_ms(record, "dispatch")
