"""What the fleet tick's span readers share: the median duration of one
host range, by name, in a traced run's trace (tracing.Trace.host: every
thread's ranges, each a Tracer span of the program while the profiler
records).

Unlike readers.stage_p50_ms, which reads a stage's ring only where every
sample in it came after the profiler, this reads the ranges inside the
traced span itself: a cell whose clients send a few requests a second
fills no ring after its trace, and its traced span is its whole window.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def p50_ms(record, name: str) -> Optional[float]:
    """The median ms of the ranges named `name` that start inside the
    traced window, or None without a trace or such a range."""
    trace = record["trace"]
    if trace is None or trace.window_ns is None:
        return None
    lo, hi = trace.window_ns
    spans = [(b - a) / 1e6 for n, a, b in trace.host
             if n == name and lo <= a < hi]
    return float(np.median(spans)) if spans else None
