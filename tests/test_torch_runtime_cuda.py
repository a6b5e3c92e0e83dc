"""The port's controller runtime on a CUDA card. Every test carries the
`cuda` marker and skips without a card (the runtime's service launches
CUDA C++ kernels with no interpret mode); on the CPU,
tests/test_torch_runtime.py and tests/test_torch_cli.py hold the runtime
and the binary against the reference.

  * the small runtime world on a card runtime equals a CPU runtime tick
    by tick, with event-driven passes, and both CUDA kernels launch from
    the MetricsProducer controller's batched solve;
  * a failed kernel build at boot raises out of the runtime's
    construction;
  * the binary on the card answers /readyz "ok" and exits 0 on SIGTERM.

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_runtime_cuda.py -q
"""

import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from karpenter_tpu_torch import kernels, workloads
from karpenter_tpu_torch.api.serialization import to_dict
from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.runtime import KarpenterRuntime, Options

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = dict(pods=2000, types=8, n_has=40, metrics=3, seed=0, groups=8)
TICKS = 6
OPTIONS = dict(fused_tick=True, poolgroups=True, consolidate=True,
               preempt=True, event_driven=True, event_thread=False,
               prewarm_compile=True)


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runtime's service launches "
                    "CUDA C++ kernels with no interpret mode")


class FakeClock:
    def __init__(self, start=1_000_000.0):
        self.now = start

    def __call__(self):
        return self.now


def run_world(device):
    clock = FakeClock()
    provider = FakeFactory()
    runtime = KarpenterRuntime(
        Options(device=device, **OPTIONS), cloud_provider_factory=provider,
        clock=clock,
    )
    snaps, launches = [], []
    try:
        world = workloads.build_runtime_world(runtime.store, provider, **WORLD)
        for t in range(TICKS):
            if t:
                clock.now += 5.0
                workloads.churn_reconcile(world.cluster, 20)()
                world.step_queues()
                runtime.manager.run_event_pass()
            TF.reset_launch_counts()
            runtime.manager.reconcile_all()
            launches.append(dict(TF.LAUNCHES))
            snaps.append(workloads.runtime_snapshot(
                runtime.store, runtime.registry, provider, to_dict,
                skip=workloads.RUNG_SKIP,
            ))
        stats = runtime.solver_service.stats
        return snaps, launches, stats.fallbacks
    finally:
        runtime.close()


def test_card_runtime_equals_the_cpu_runtime():
    card, launches, fallbacks = run_world(None)
    cpu, _, _ = run_world("cpu")
    assert fallbacks == 0
    assert launches[0]["fused_assign"] >= 1 and launches[0]["shelf_bfd"] >= 1
    for t, (got, want) in enumerate(zip(card, cpu)):
        assert got == want, f"tick {t}"


def test_failed_kernel_build_raises_at_boot(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("CUDA kernel build failed: injected")

    monkeypatch.setattr(kernels, "build", broken)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        KarpenterRuntime(Options(), cloud_provider_factory=FakeFactory())


def test_binary_on_the_card_is_ready_and_exits_0_on_sigterm(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch", "--profile",
         "production", "--cloud-provider", "fake", "--metrics-port", "0",
         "--no-leader-elect", "--tick", "0.1", "--duration", "120",
         "--journal-dir", str(tmp_path / "j")],
        cwd=REPO, stderr=subprocess.PIPE, text=True,
    )
    try:
        port = None
        deadline = time.time() + 300
        while port is None and time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            if "serving /metrics and /healthz on :" in line:
                port = int(line.rsplit(":", 1)[1])
        assert port is not None, "the binary did not start serving"
        body = b""
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=5
                ) as response:
                    body = response.read()
                    break
            except urllib.error.HTTPError:
                time.sleep(0.2)
        assert body == b"ok"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
