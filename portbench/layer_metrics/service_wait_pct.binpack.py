"""Share of the traced window in which the solve service's worker waited
for work: 100 x the union of its `solver.wait` ranges (blocked on an empty
queue or holding the gather window open), clipped to the window, over the
window. None without a trace, or where the program opens no such range:
a worker that publishes its gauges (`solver.gauges`, once a batch) but
never waited reads 0."""

SPAN = "solver.wait"
WORKER_SPANS = (SPAN, "solver.gauges")


def read(record):
    trace = record["trace"]
    if trace is None or trace.window_ns is None:
        return None
    if not any(name in WORKER_SPANS for name, _, _ in trace.host):
        return None
    lo, hi = trace.window_ns
    ranges = sorted((max(a, lo), min(b, hi)) for name, a, b in trace.host
                    if name == SPAN and b > lo and a < hi)
    total, end = 0, lo
    for a, b in ranges:
        if b > end:
            total += b - max(a, end)
            end = b
    return 100.0 * total / (hi - lo)
