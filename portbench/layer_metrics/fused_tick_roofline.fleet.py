"""Share of its roofline that the fused tick reaches on the card: the
tick's least time (reference/roofline.least_seconds on the reference's
operations and bytes of one checked tick, reference/fleet_tick.work)
over the tick's device time, which is every kernel and memset in the
traced window (copies left out, as kernel_ms_per_solve leaves them out)
over the graph replays launched in it (`cudaGraphLaunch` calls, one a
tick)."""

from portbench.reference import roofline

LAUNCH = "cudaGraphLaunch"


def read(record):
    trace, cost = record["trace"], record["kernel_cost"].get("fused_tick")
    if trace is None or cost is None or trace.window_ns is None:
        return None
    lo, hi = trace.window_ns
    ticks = sum(1 for name, a, _ in trace.host
                if name == LAUNCH and lo <= a < hi)
    ns = sum(b - a for name, a, b in trace.events
             if not name.startswith("Memcpy"))
    if not ticks or not ns:
        return None
    return 100.0 * roofline.least_seconds(*cost) / (ns / 1e9 / ticks)
