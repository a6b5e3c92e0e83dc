"""Median ms of the fused tick's `solver.fused.upload` span in the traced
run (ops/fusedtick.FusedTickProgram): the operands copied from the host into the shape class's static buffers on the card (and a capture on a shape's first call: none in the window, whose shapes the warm-up captured). Read from the
trace's ranges over the whole window (portbench/host_spans.py); a
program without the span reads nothing."""

from portbench import host_spans


def read(record):
    return host_spans.p50_ms(record, "solver.fused.upload")
