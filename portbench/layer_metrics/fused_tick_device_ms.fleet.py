"""Median ms of a fused tick's span on the card's timeline: the service's
`fused_device` stage, two CUDA events on the program's stream before and
after the graph's replay, read after the fetch has synchronised. Taken
over the window's ticks alone (the newest samples of the stage's ring,
one a tick answered: the warm-up's ticks came first), in the traced run,
so under the profiler. A program without the stage reads nothing."""

import numpy as np


def read(record):
    samples = record["counters"].get("fused_device_ms")
    answered = sum(1 for c in record["calls"] if c.ok)
    if not samples or not answered:
        return None
    return float(np.median(samples[-answered:]))
