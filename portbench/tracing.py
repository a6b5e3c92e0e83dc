"""The traced window: torch.profiler over the card, reduced to the device's
activity (kernels, copies, memsets) and to the host's ranges, and the
numbers every traced run reports (busy and window seconds, the breakdown).

The profiler asks for every thread's ranges where torch takes
`profile_all_threads`, so the solve service's worker thread shows. The
window is marked by a `portbench.trace` range on the thread that opens
and closes it; device activity is clipped to it.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Tuple

import torch

MARK = "portbench.trace"
_NAME_CHARS = 160
# the profiler's own work on the host's timeline, never the program's
_PROFILER_RANGES = ("Activity Buffer Request", "Buffer Flush")


# torch warns once that a profiler's events end with its cycle: each Trace
# is one cycle, read whole at its stop
warnings.filterwarnings("ignore", message="Warning: Profiler clears events")


def _profile_kwargs() -> dict:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    kwargs = {"activities": activities}
    try:
        kwargs["experimental_config"] = torch.profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):  # a torch without the option
        pass
    return kwargs


def warm() -> None:
    """Start and stop the profiler once: its first start (CUPTI's set-up)
    takes seconds, which belong to set-up, not to the window."""
    with torch.profiler.profile(**_profile_kwargs()):
        if torch.cuda.is_available():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()


class Trace:
    """Profile from start() to stop(); then `events` holds the device
    activity as (name, start_ns, end_ns) clipped to the window,
    `host` the host ranges as (name, start_ns, end_ns), and `window_ns`
    the window's own range."""

    def __init__(self):
        self._prof = torch.profiler.profile(**_profile_kwargs())
        self._mark = None
        self.events: List[Tuple[str, int, int]] = []
        self.host: List[Tuple[str, int, int]] = []
        self.window_ns: Optional[Tuple[int, int]] = None
        self.started = self.stopped = None

    def start(self) -> None:
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()
        self.started = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.stopped = time.perf_counter()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        device, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns()
            span = (e.name(), start, start + e.duration_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append(span)
            elif e.name() == MARK:
                self.window_ns = span[1:]
            elif e.name() not in _PROFILER_RANGES:
                host.append(span)
        if self.window_ns is None:
            raise RuntimeError("the profiler lost the window's range")
        lo, hi = self.window_ns
        self.events = [(n, max(a, lo), min(b, hi)) for n, a, b in device
                       if b > lo and a < hi]
        self.host = host

    @property
    def window_s(self) -> float:
        lo, hi = self.window_ns
        return (hi - lo) / 1e9

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the card
        (the union of the device intervals)."""
        total, end = 0, None
        for _, a, b in sorted(self.events, key=lambda e: e[1]):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """The window's idle intervals on the card, as (start_ns, end_ns)."""
        lo, hi = self.window_ns
        out, cursor = [], lo
        for _, a, b in sorted(self.events, key=lambda e: e[1]):
            if a > cursor:
                out.append((cursor, a))
            cursor = max(cursor, b)
        if hi > cursor:
            out.append((cursor, hi))
        return out

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost host range that covers its
        middle ("no host range" where none does)."""
        by_name: Dict[str, int] = {}
        for name, a, b in self.events:
            key = name[:_NAME_CHARS]
            by_name[key] = by_name.get(key, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        named = []
        for a, b in longest:
            mid = (a + b) // 2
            covering = [h for h in self.host if h[1] <= mid <= h[2]]
            label = (min(covering, key=lambda h: h[2] - h[1])[0][:_NAME_CHARS]
                     if covering else "no host range")
            named.append([label, (b - a) / 1e9])
        return {"device_ops": [[k, v / 1e9] for k, v in ops],
                "idle_gaps": named}
