"""Device-timeline annotation and the on-demand profiler capture
(counterpart of karpenter_tpu/observability/profiler.py).

The reference wraps solver dispatches in jax.profiler.TraceAnnotation so
they show as named ranges on an xprof timeline. Here the range is
torch.profiler.record_function: inside a torch.profiler window it shows
as a named range over the kernels it launched, and outside one it costs
a few microseconds of host time.

`capture_profile` is /debug/profile's bounded, single-flight capture:
the reference's jax.profiler trace becomes a torch.profiler window (CPU
activity, plus CUDA activity when a card is visible) written as a
Chrome trace. The reference's remote xprof server
(`start_profiler_server`, `--profiler-port`) has no torch counterpart
and is not ported.
"""

from __future__ import annotations

import json
import os
import threading
import time as _time

import torch


def solver_trace(name: str):
    """A context manager naming a solver section on the profiler's
    timeline."""
    return torch.profiler.record_function(name)


# the capture window's bounds: a typo'd ?ms= must not leave the
# profiler (and its overhead) on a production plane for minutes
MIN_CAPTURE_MS = 1
MAX_CAPTURE_MS = 30_000

PROFILE_PREFIX = "profile-"
TRACE_FILE = "trace.json"

# single-flight: the kineto profiler is a process-global singleton — two
# concurrent windows corrupt each other's sessions
_capture_lock = threading.Lock()
_capture_seq = 0


class ProfileBusy(RuntimeError):
    """A capture is already in flight (single-flight contract)."""


class ProfileUnavailable(RuntimeError):
    """torch.profiler could not start — no capture possible."""


def _activities():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


def capture_profile(
    ms: int, out_dir: str, trace_id=None, sleep=_time.sleep
) -> dict:
    """One bounded on-demand torch.profiler capture (/debug/profile?ms=N):
    profile the process for `ms` milliseconds (clamped to
    [MIN_CAPTURE_MS, MAX_CAPTURE_MS]) into
    `out_dir/profile-<seq>-<stamp>/trace.json` — the runtime passes
    --journal-dir, so captures land next to the flight-recorder dumps an
    incident already wrote. The capture directory is written under a
    tmp name and renamed into place ATOMICALLY (a crash mid-capture
    leaves a .tmp orphan, never a half-readable capture), with a
    manifest.json stamping the active trace id, window, and wall time.

    Raises ProfileUnavailable when the profiler cannot start and
    ProfileBusy when a capture is already in flight (single-flight) —
    the HTTP surface maps both to 503."""
    global _capture_seq
    ms = max(MIN_CAPTURE_MS, min(MAX_CAPTURE_MS, int(ms)))
    if not _capture_lock.acquire(blocking=False):
        raise ProfileBusy("a profiler capture is already in flight")
    try:
        _capture_seq += 1
        stamp = _time.strftime("%Y%m%d-%H%M%S")
        final = os.path.join(
            out_dir, f"{PROFILE_PREFIX}{_capture_seq:04d}-{stamp}"
        )
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        t0 = _time.perf_counter()
        try:
            prof = torch.profiler.profile(activities=_activities())
            prof.__enter__()
        except Exception as error:  # noqa: BLE001 — reported as 503
            raise ProfileUnavailable(
                f"torch.profiler unavailable ({type(error).__name__}: "
                f"{error})"
            ) from error
        try:
            sleep(ms / 1e3)
        finally:
            prof.__exit__(None, None, None)
        elapsed_ms = (_time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(os.path.join(tmp, TRACE_FILE))
        manifest = {
            "ms_requested": ms,
            "ms_captured": round(elapsed_ms, 3),
            "trace_id": trace_id,
            "captured_at": _time.time(),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, sort_keys=True)
        os.rename(tmp, final)
        return {"path": final, **manifest}
    finally:
        _capture_lock.release()
