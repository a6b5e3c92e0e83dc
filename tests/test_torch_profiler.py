"""The port's profiler server (`start_profiler_server`, `--profiler-port`)
over HTTP on the CPU: GET /profile?ms=N answers a Chrome trace, shares
/debug/profile's clamp and single-flight lock, reports a port it cannot
bind, and starts and stops with the binary. The reference's own
tests/test_profiler.py and TestSolverTraceProbe run on the port through
tests/test_torch_ref_{profiler,observability}.py.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.observability import MetricsServer
from karpenter_tpu_torch.observability import profiler as P


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("", 0))
        return sock.getsockname()[1]


def get(port: int, path: str):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=120
        ) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as error:
        return error.code, error.read()


def names(body: bytes) -> list:
    return [event.get("name") for event in json.loads(body)["traceEvents"]]


def _capture_beside_a_worker(capture) -> bytes:
    """`capture()` -> (status, body), taken while another thread opens
    solver.other_thread ranges; the body, which must be a Chrome trace."""
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            with P.solver_trace("solver.other_thread"):
                torch.ones(16) + 1
            time.sleep(0.001)

    thread = threading.Thread(target=worker)
    thread.start()
    try:
        status, body = capture()
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert status == 200, body
    assert "traceEvents" in json.loads(body)
    return body


def _capture_in_a_range() -> bytes:
    def sleep_in_a_range(seconds):
        with P.solver_trace("solver.capturing_thread"):
            time.sleep(seconds)

    return P.capture_chrome_trace(20, sleep=sleep_in_a_range)


@pytest.fixture
def server():
    P.reset_probe()
    port = free_port()
    assert P.start_profiler_server(port)
    yield port
    P.stop_profiler_server()
    P.reset_probe()


class TestProfileRoute:
    def test_capture_is_a_chrome_trace_of_the_capturing_thread(self, server):
        """The answer parses as the Chrome trace export_chrome_trace
        writes. A range another thread opens during the window is in it
        as well: the capture asks kineto for every thread's ranges
        (profile_all_threads, which this torch takes), so a capture taken
        on the server's thread holds the solve worker's `solver.*`
        ranges, as the reference's xprof trace does. A range the
        capturing thread opens is in it too."""
        assert P._all_threads(), torch.__version__
        body = _capture_beside_a_worker(lambda: get(server, "/profile?ms=100"))
        assert "solver.other_thread" in names(body)
        assert "solver.capturing_thread" in names(_capture_in_a_range())

    def test_without_the_option_a_capture_holds_its_own_thread(
        self, server, monkeypatch, caplog
    ):
        """A torch without profile_all_threads keeps kineto's default:
        the capturing thread's ranges only, and the capture's log line
        names the limit."""
        monkeypatch.setattr(P, "_ALL_THREADS", False)
        caplog.set_level(logging.INFO, logger="karpenter_tpu_torch")
        body = _capture_beside_a_worker(lambda: get(server, "/profile?ms=100"))
        assert "solver.other_thread" not in names(body)
        assert "solver.capturing_thread" in names(_capture_in_a_range())
        assert "the capturing thread only" in caplog.text
        assert "has no profile_all_threads" in P.capture_threads()

    def test_ms_is_clamped_to_the_bounds(self, server):
        slept = []
        P.capture_chrome_trace(10**9, sleep=slept.append)
        P.capture_chrome_trace(-5, sleep=slept.append)
        assert slept == [P.MAX_CAPTURE_MS / 1e3, P.MIN_CAPTURE_MS / 1e3]
        status, body = get(server, "/profile?ms=-5")  # clamped to 1 ms
        assert status == 200 and "traceEvents" in json.loads(body)

    def test_malformed_ms_and_unknown_path(self, server):
        assert get(server, "/profile?ms=soon")[0] == 400
        assert get(server, "/debug/profile?ms=5")[0] == 404

    def test_failed_probe_is_503(self, server):
        P._ANNOTATION_CLS = False
        status, body = get(server, "/profile?ms=5")
        assert status == 503 and b"unavailable" in body

    def test_capture_during_debug_profile_is_503(self, server, tmp_path):
        """/debug/profile and /profile share one single-flight lock: while
        one captures, the other answers 503 (and the reverse)."""
        metrics = MetricsServer(GaugeRegistry(), port=0, host="127.0.0.1",
                                profile_dir=str(tmp_path))
        metrics_port = metrics.start()
        try:
            answers = []
            debug = threading.Thread(target=lambda: answers.append(
                get(metrics_port, "/debug/profile?ms=1500")))
            debug.start()
            deadline = time.monotonic() + 60
            while not P._capture_lock.locked():
                assert time.monotonic() < deadline, "no capture started"
                time.sleep(0.005)
            status, body = get(server, "/profile?ms=10")
            debug.join()
            assert status == 503 and b"in flight" in body
            assert answers[0][0] == 200, answers
            assert P._capture_lock.acquire(blocking=False)
            try:
                status, body = get(metrics_port, "/debug/profile?ms=10")
            finally:
                P._capture_lock.release()
            assert status == 503 and b"in flight" in body
        finally:
            metrics.stop()


class TestServerLifecycle:
    def test_bound_port_returns_false_and_logs(self, caplog):
        with socket.socket() as taken:
            taken.bind(("", 0))
            taken.listen()
            port = taken.getsockname()[1]
            with caplog.at_level(logging.WARNING):
                assert P.start_profiler_server(port) is False
        assert f"failed to start on :{port}" in caplog.text
        assert "OSError" in caplog.text
        assert P._server is None

    def test_second_server_returns_false(self, server, caplog):
        with caplog.at_level(logging.WARNING):
            assert P.start_profiler_server(free_port()) is False
        assert f"already running on :{server}" in caplog.text
        assert get(server, "/profile?ms=1")[0] == 200  # the first serves on

    def test_binary_serves_and_stops(self, capsys):
        from karpenter_tpu_torch.__main__ import main

        port = free_port()
        result = {}
        binary = threading.Thread(target=lambda: result.setdefault(
            "rc", main(["--profiler-port", str(port), "--device", "cpu",
                        "--duration", "4", "--tick", "0.05",
                        "--metrics-port", "0", "--no-leader-elect"])))
        binary.start()
        try:
            deadline = time.monotonic() + 60
            while True:
                try:
                    status, body = get(port, "/profile?ms=20")
                    break
                except urllib.error.URLError:
                    assert time.monotonic() < deadline, "never served"
                    time.sleep(0.05)
            assert status == 200 and "traceEvents" in json.loads(body)
        finally:
            binary.join()
        assert result["rc"] == 0
        assert f"torch profiler listening on :{port}" in capsys.readouterr().err
        assert P._server is None
        with pytest.raises(urllib.error.URLError):
            get(port, "/profile?ms=1")
