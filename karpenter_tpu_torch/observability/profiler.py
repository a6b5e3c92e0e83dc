"""Device-timeline annotation, the profiler server and the on-demand
capture (counterpart of karpenter_tpu/observability/profiler.py).

The reference wraps solver dispatches in jax.profiler.TraceAnnotation so
they show as named ranges on an xprof timeline. Here the range is
torch.profiler.record_function: inside a torch.profiler window it shows
as a named range over the kernels it launched, and outside one it costs
a few microseconds of host time. The port's call sites do not open it
themselves: they open a span (observability/tracing.py), which opens
this range, `solver_trace`, only while a profiler records.

Hot-path discipline, as in the reference: the profiler is probed ONCE
per process and cached. When the probe fails, `solver_trace` returns the
shared no-op context manager (observability/tracing.py's `_NOOP_SPAN`):
no allocation, one module-global read. A range that fails to open or
close is swallowed; an exception raised by the traced block propagates
unchanged.

Captures. A capture is one torch.profiler window of CPU activity, plus
CUDA activity when a card is visible, exported as a Chrome trace (the
JSON that Perfetto and chrome://tracing read). Two surfaces take one,
through the same clamp ([MIN_CAPTURE_MS, MAX_CAPTURE_MS]) and the same
single-flight lock, so they never overlap:

  * `capture_profile` is /debug/profile's capture (observability/
    server.py): written atomically under --journal-dir with a manifest.
  * `start_profiler_server(port)` (--profiler-port) is the counterpart
    of jax.profiler.start_server: it serves `GET /profile?ms=N` over
    HTTP on every interface, and answers the Chrome trace itself, so a
    tool outside the process can capture a running controller without
    --journal-dir. torch has no xprof gRPC service: the protocol is
    HTTP and the format a Chrome trace, not xprof's gRPC and XSpace, so
    TensorBoard's capture button cannot attach; any HTTP client can
    (`curl -o trace.json 'http://HOST:PORT/profile?ms=500'`).

Threads. A capture holds the CUDA kernels of the whole process (CUPTI
records every launch). kineto's CPU-side callbacks are thread-local, so
by default it records the record_function ranges of the capturing
thread only: a capture taken on a server's thread would hold the kernels
that the solve service's worker thread launched and none of the
worker's `solver.*` ranges, where the reference's xprof trace holds
every thread's annotations. A capture therefore asks kineto for every
thread (`_ExperimentalConfig(profile_all_threads=True)`) where the
installed torch takes that option, probed once as `_probe` does
(`capture_threads()` says which). Where it does not, a capture keeps
the capturing thread's ranges only, and its log line says so.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time as _time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import torch

from karpenter_tpu_torch.observability.tracing import _NOOP_SPAN as _NOOP_TRACE

# probe cache: None = unprobed; False = unavailable; otherwise the
# torch.profiler.record_function class itself
_ANNOTATION_CLS = None


class _GuardedAnnotation:
    """One record_function range whose SETUP/TEARDOWN failures are
    swallowed — tracing must never break the solve — while exceptions
    raised by the traced block itself propagate unchanged."""

    __slots__ = ("_cls", "_name", "_annotation")

    def __init__(self, cls, name: str):
        self._cls = cls
        self._name = name
        self._annotation = None

    def __enter__(self):
        try:
            self._annotation = self._cls(self._name)
            self._annotation.__enter__()
        except Exception:  # noqa: BLE001 — tracing must never break the solve
            self._annotation = None
        return None

    def __exit__(self, *exc):
        if self._annotation is not None:
            try:
                self._annotation.__exit__(None, None, None)
            except Exception:  # noqa: BLE001
                pass
        return False


def _probe():
    """One-time torch.profiler availability probe (cached)."""
    global _ANNOTATION_CLS
    if _ANNOTATION_CLS is None:
        try:
            from torch.profiler import record_function

            _ANNOTATION_CLS = record_function
        except Exception:  # noqa: BLE001 — a torch without the profiler
            _ANNOTATION_CLS = False
    return _ANNOTATION_CLS


def reset_probe() -> None:
    """Forget the cached probes (test isolation)."""
    global _ANNOTATION_CLS, _ALL_THREADS
    _ANNOTATION_CLS = None
    _ALL_THREADS = None


def solver_trace(name: str):
    """Name a solver section on the profiler's timeline. With no profiler
    available this is the SHARED no-op context manager — allocation-free,
    probed once per process."""
    cls = _ANNOTATION_CLS if _ANNOTATION_CLS is not None else _probe()
    if cls is False:
        return _NOOP_TRACE
    return _GuardedAnnotation(cls, name)


# -- captures -----------------------------------------------------------------

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
    """The torch.profiler probe failed or the profiler could not start —
    no capture possible."""


# probe cache: None = unprobed; otherwise whether this torch's kineto
# takes the all-threads option
_ALL_THREADS = None


def _all_threads() -> bool:
    """One-time probe: does torch.profiler take
    `_ExperimentalConfig(profile_all_threads=True)`? (cached)"""
    global _ALL_THREADS
    if _ALL_THREADS is None:
        try:
            torch.profiler._ExperimentalConfig(profile_all_threads=True)
            _ALL_THREADS = True
        except (AttributeError, TypeError):  # an older kineto binding
            _ALL_THREADS = False
    return _ALL_THREADS


def capture_threads() -> str:
    """Whose record_function ranges a capture holds, as its log line
    says it."""
    if _all_threads():
        return "all threads"
    return (f"the capturing thread only (torch {torch.__version__} has no "
            "profile_all_threads)")


def _profile_kwargs() -> dict:
    if not _all_threads():
        return {"activities": _activities()}
    return {
        "activities": _activities(),
        "experimental_config": torch.profiler._ExperimentalConfig(
            profile_all_threads=True
        ),
    }


def _activities():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


def _capture(ms: int, sleep, write):
    """Profile the process for `ms` milliseconds (clamped), holding the
    single-flight lock, then `write(prof, ms, elapsed_ms)` under the same
    lock and return what it returns."""
    if _probe() is False:
        raise ProfileUnavailable("torch.profiler unavailable")
    ms = max(MIN_CAPTURE_MS, min(MAX_CAPTURE_MS, int(ms)))
    if not _capture_lock.acquire(blocking=False):
        raise ProfileBusy("a profiler capture is already in flight")
    try:
        t0 = _time.perf_counter()
        try:
            prof = torch.profiler.profile(**_profile_kwargs())
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
        from karpenter_tpu_torch.utils.log import logger

        logger().info("torch profiler capture of %d ms: ranges of %s", ms,
                      capture_threads())
        return write(prof, ms, (_time.perf_counter() - t0) * 1e3)
    finally:
        _capture_lock.release()


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

    Raises ProfileUnavailable when the profiler probe failed or the
    profiler cannot start and ProfileBusy when a capture is already in
    flight (single-flight) — the HTTP surface maps both to 503."""

    def write(prof, ms, elapsed_ms):
        global _capture_seq
        _capture_seq += 1
        stamp = _time.strftime("%Y%m%d-%H%M%S")
        final = os.path.join(
            out_dir, f"{PROFILE_PREFIX}{_capture_seq:04d}-{stamp}"
        )
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
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

    return _capture(ms, sleep, write)


def capture_chrome_trace(ms: int, sleep=_time.sleep) -> bytes:
    """One bounded capture answered as the Chrome trace's bytes (the
    profiler server's GET /profile); the same clamp, lock and errors as
    capture_profile."""

    def write(prof, ms, elapsed_ms):
        with tempfile.TemporaryDirectory(prefix="karpenter-profile-") as tmp:
            path = os.path.join(tmp, TRACE_FILE)
            prof.export_chrome_trace(path)
            with open(path, "rb") as fh:
                return fh.read()

    return _capture(ms, sleep, write)


class _ProfileHandler(BaseHTTPRequestHandler):
    """GET /profile?ms=N -> 200 with the Chrome trace; 400 for a
    malformed ms; 503 when a capture is in flight or the profiler is
    unavailable (the reasons /debug/profile gives); 404 elsewhere."""

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        url = urlsplit(self.path)
        if url.path != "/profile":
            return self._send(404, b"try /profile?ms=N", "text/plain")
        try:
            ms = int(parse_qs(url.query).get("ms", ["100"])[0])
        except (ValueError, IndexError):
            return self._send(400, b"?ms=N must be an integer", "text/plain")
        try:
            body = capture_chrome_trace(ms)
        except (ProfileUnavailable, ProfileBusy) as error:
            return self._send(503, str(error).encode(), "text/plain")
        except Exception as error:  # noqa: BLE001 — never 500-loop
            return self._send(
                503, f"profiler capture failed: {error}".encode(),
                "text/plain",
            )
        self._send(200, body, "application/json")

    def _send(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet: captures are logged by caller
        pass


# the one profiler server of the process (jax.profiler keeps one too)
_server = None
_server_lock = threading.Lock()


def _warm_up() -> None:
    """Start and stop one empty profiler window: the process's first start
    initializes kineto (and CUPTI on the card), 1.8 s on the CPU of the
    test machine against 1 ms for every later one, so a capture asked of
    a warm server opens its window when asked. A capture already in
    flight has started the profiler itself."""
    try:
        _capture(MIN_CAPTURE_MS, lambda seconds: None, lambda *args: None)
    except ProfileBusy:
        pass


def start_profiler_server(port: int = 9999) -> bool:
    """Serve GET /profile?ms=N on `port`, on every interface (as the
    reference's jax.profiler.start_server binds every interface), from a
    daemon thread, so a tool outside the process can capture a running
    controller's device timeline. The profiler is started once before
    the server serves (_warm_up). Returns False if unavailable — a port
    that cannot be bound, a profiler that cannot start, a server already
    running — with the reason LOGGED."""
    global _server
    from karpenter_tpu_torch.utils.log import logger

    with _server_lock:
        server = None
        try:
            if _server is not None:
                raise RuntimeError(
                    "a profiler server is already running on "
                    f":{_server.server_address[1]}"
                )
            server = ThreadingHTTPServer(("", port), _ProfileHandler)
            _warm_up()
        except Exception as error:  # noqa: BLE001
            if server is not None:
                server.server_close()
            logger().warning(
                "torch profiler server failed to start on :%d (%s: %s); "
                "device-timeline capture unavailable",
                port, type(error).__name__, error,
            )
            return False
        server.daemon_threads = True
        threading.Thread(
            target=server.serve_forever, name="profiler-server", daemon=True
        ).start()
        _server = server
        return True


def stop_profiler_server() -> None:
    """Stop the server start_profiler_server started (no-op without one);
    the counterpart of jax.profiler.stop_server."""
    global _server
    with _server_lock:
        server, _server = _server, None
    if server is not None:
        server.shutdown()
        server.server_close()
