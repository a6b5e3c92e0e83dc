"""Median ms of the fused tick's `solver.fused.replay` span in the traced
run (ops/fusedtick.FusedTickProgram): the captured CUDA graph's replay: the host's launch of the whole tick, which returns before the card has run it. Read from the
trace's ranges over the whole window (portbench/host_spans.py); a
program without the span reads nothing."""

from portbench import host_spans


def read(record):
    return host_spans.p50_ms(record, "solver.fused.replay")
