"""Milliseconds of the card's kernels and memsets per bin-pack Solve
answered: every Solve sent in the window, from the whole-window trace of
an untraced run. What a Solve costs the card the sidecar shares; the
host's part of a Solve, its copies included, is the solve service's
layer (service_solves_per_s, service_dispatch_ms.binpack)."""

from portbench import readers


def read(record):
    return readers.kernel_ms_per_answer(record)
