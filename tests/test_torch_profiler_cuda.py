"""The profiler server on a CUDA card. Every test carries the `cuda`
marker and skips without a card (the capture's device rows come from
CUPTI); on the CPU, tests/test_torch_profiler.py holds the server.

  * GET /profile (2 s), taken on the server's thread while the solve service's
    worker thread launches both CUDA kernels, holds both kernels and,
    where the card's torch takes profile_all_threads, the worker's
    solver.* ranges (without it kineto records the capturing thread's
    ranges only, and the capture holds none of them; the counts are
    printed with -s).

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_profiler_cuda.py -q -s
"""

import json
import socket
import threading
import urllib.request

import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.observability import profiler as P
from karpenter_tpu_torch.ops.binpack import inputs_from_numpy
from karpenter_tpu_torch.solver import SolverService

pytestmark = pytest.mark.cuda

# device kernels of each wrapper, by the names the profiler shows
KERNELS = {
    "fused_assign": ("assign_kernel", "demand_reduce_kernel"),
    "shelf_bfd": ("shelf_bfd_warp_kernel", "shelf_bfd_wide_kernel"),
}


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the capture's device rows come from "
                    "CUPTI, and the service launches CUDA C++ kernels")


def test_capture_holds_the_worker_threads_kernels():
    with socket.socket() as sock:
        sock.bind(("", 0))
        port = sock.getsockname()[1]
    inputs = inputs_from_numpy(workloads.build_inputs(20_000, 300, 64, 64, 0))
    service = SolverService()
    # the first solve's one-time costs stay out of the window: a range
    # opened before the window starts is not recorded, though the kernels
    # it launches inside the window are
    service.solve(inputs)
    stop = threading.Event()
    solves = []

    def client():
        while not stop.is_set():
            service.solve(inputs)
            solves.append(1)

    assert P.start_profiler_server(port)
    thread = threading.Thread(target=client)
    thread.start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/profile?ms=2000", timeout=120
        ) as resp:
            events = json.loads(resp.read())["traceEvents"]
    finally:
        stop.set()
        thread.join()
        P.stop_profiler_server()
        service.close()
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {w: sum(any(n in k for n in names) for k in kernels)
             for w, names in KERNELS.items()}
    ranges = [e for e in events if str(e.get("name", "")).startswith("solver.")]
    print(f"\nprofile: {len(solves)} solves, kernels {found} of "
          f"{len(kernels)}, solver.* ranges {len(ranges)} "
          f"{sorted({str(e.get('cat')) for e in ranges})}; torch "
          f"{torch.__version__}, ranges of {P.capture_threads()}")
    assert solves
    assert all(found.values()), found
    # the worker's ranges are recorded where kineto takes every thread
    # (profiler.py)
    assert bool(ranges) == P._all_threads(), P.capture_threads()
