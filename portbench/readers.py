"""What the metric readers (end_to_end/<name>.py, layer_metrics/<name>.py)
share. A reader's `read(record)` returns a number, or None where the run
left nothing to read (no trace, no call of the path, no stage).

The record (harness.run): "seconds" (the window), "setup_s", "calls"
(harness.Call: due, sent, done in seconds after the window opened, ok),
"counters" (the entry's: the service's stage timings), "trace"
(tracing.Trace or None), "traced_calls" (the calls inside the traced
span, counted by the share of each that lies in it), "quiet_from"
(window seconds from which the profiler has stopped and processed its
trace; 0 without one), "trace_whole" (the trace runs from before the
window to the last answer), "kernel_cost" ({kernel: (operations, bytes)} of
one launch on the checked operands, the reference's counts).
"""

from __future__ import annotations

from typing import Optional, Sequence

from portbench.reference import roofline


def stage_p50_ms(record, stage: str) -> Optional[float]:
    """p50 of a service stage over its ring (one sample a request), read
    only where every sample in the ring was taken once the profiler had
    stopped and processed its trace: at least as many requests were sent
    after that as the ring holds. Else None."""
    stage = record["counters"].get("stages", {}).get(stage)
    if not stage:
        return None
    quiet = sum(1 for c in record["calls"]
                if c.ok and c.sent >= record["quiet_from"])
    return stage["p50_ms"] if quiet >= stage["n"] else None


def idle_pct(record) -> Optional[float]:
    trace = record["trace"]
    if trace is None or not trace.events:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def kernel_roofline_pct(record, cost_name: str, launch: str,
                        names: Sequence[str]) -> Optional[float]:
    """100 x the least time of one launch (reference/roofline.py on the
    checked operands) over the mean device time per launch in the trace.
    A launch is one `launch` kernel; its time is that of every kernel
    named in `names` (the launch's device kernels)."""
    trace, cost = record["trace"], record["kernel_cost"].get(cost_name)
    if trace is None or cost is None:
        return None
    launches = sum(1 for name, _, _ in trace.events if launch in name)
    ns = sum(b - a for name, a, b in trace.events
             if any(n in name for n in names))
    if not launches or not ns:
        return None
    return 100.0 * roofline.least_seconds(*cost) / (ns / 1e9 / launches)



def kernel_ms_per_answer(record) -> Optional[float]:
    """Milliseconds of device work per answered request: every kernel and
    memset on the card over a trace that holds each request of the window
    from before its send to its answer (an untraced run's whole-window
    trace, "trace_whole"), divided by the answered requests. Copies are
    left out: a copy to or from pageable host memory runs at the speed of
    the host's memcpy, which is the host's time, not the card's."""
    trace = record["trace"]
    if trace is None or not record.get("trace_whole"):
        return None
    answered = sum(1 for c in record["calls"] if c.ok)
    ns = sum(b - a for name, a, b in trace.events
             if not name.startswith("Memcpy"))
    return ns / 1e6 / answered if answered and ns else None


def quiet_rate(record) -> Optional[float]:
    """Requests answered in the stretch of the window after the profiler
    has stopped and processed its trace, over that stretch's length; None
    where it is shorter than a second or nothing was answered in it."""
    start, stop = record["quiet_from"], record["seconds"]
    if record["trace"] is None or stop - start < 1.0:
        return None
    done = sum(1 for c in record["calls"]
               if c.ok and start <= c.done <= stop)
    return done / (stop - start) if done else None
