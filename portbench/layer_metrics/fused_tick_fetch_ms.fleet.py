"""Median ms of the fused tick's `solver.fused.fetch` span in the traced
run (ops/fusedtick.FusedTickProgram): the one device-to-host copy of every output leaf, which waits for the card to finish the tick. Read from the
trace's ranges over the whole window (portbench/host_spans.py); a
program without the span reads nothing."""

from portbench import host_spans


def read(record):
    return host_spans.p50_ms(record, "solver.fused.fetch")
