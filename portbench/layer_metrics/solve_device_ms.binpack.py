"""Median ms of a Solve's span on the card's timeline: two CUDA events on
the worker's stream, one after the upload and one after the last op, read
after the sync (SolverService.stage_percentiles()["device"], its last
256), so the launch gaps between the kernels count; read from requests
sent after the profiler's span."""

from portbench import readers


def read(record):
    return readers.stage_p50_ms(record, "device")
