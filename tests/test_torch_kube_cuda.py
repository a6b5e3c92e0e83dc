"""Real-cluster mode on a CUDA card. Every test carries the `cuda` marker
and skips without a card (the runtime's service launches CUDA C++ kernels
with no interpret mode); on the CPU, tests/test_torch_kube_store.py holds
the port's KubeStore runtime against the reference's.

  * the small parity world of tests/test_torch_kube_store.py, served by
    two fake kube-apiservers: a card runtime with --profile production's
    options and a CPU runtime write the same MetricsProducer,
    ScalableNodeGroup and HorizontalAutoscaler documents after the first
    tick and after each of 4 churned ticks, and each CUDA kernel launches
    exactly once per churned tick.

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_kube_cuda.py -q
"""

import importlib.util
import pathlib

import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
from karpenter_tpu_torch.store.kube import KubeClient, KubeStore


def _fake_apiserver():
    """tests/fake_apiserver.py's FakeApiServer, loaded from its file (a
    `tests` package installed elsewhere may shadow the repo's)."""
    path = pathlib.Path(__file__).with_name("fake_apiserver.py")
    spec = importlib.util.spec_from_file_location("fake_apiserver", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FakeApiServer

pytestmark = pytest.mark.cuda

WORLD = dict(pods=2000, types=16, seed=0, node_groups=2)
CHURN = 20
TICKS = 4
OPTIONS = dict(fused_tick=True, event_driven=True, event_thread=False,
               prewarm_compile=True)
PLURALS = ("metricsproducers", "scalablenodegroups", "horizontalautoscalers")
MIRRORED = ("MetricsProducer", "ScalableNodeGroup", "HorizontalAutoscaler")


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runtime's service launches "
                    "CUDA C++ kernels with no interpret mode")


def test_card_runtime_over_the_apiserver_equals_the_cpu():
    FakeApiServer = _fake_apiserver()
    servers = [FakeApiServer(), FakeApiServer()]
    stores, runtimes = [], []
    for server in servers:
        server.start()
    try:
        cluster = workloads.build_kube_world(servers, **WORLD)
        clock = {"t": 1000.0}
        for server, device in zip(servers, (None, "cpu")):
            store = KubeStore(KubeClient(server.url, timeout=10.0),
                              resync_backoff=0.05)
            stores.append(store)
            provider = FakeFactory()
            provider.node_replicas.update(cluster.node_replicas)
            runtimes.append(KarpenterRuntime(
                Options(device=device, **OPTIONS), store=store,
                cloud_provider_factory=provider, clock=lambda: clock["t"]))
        card, cpu = runtimes
        assert card.solver_service.device.type == "cuda"
        for t in range(TICKS + 1):
            if t:
                rvs = workloads.churn_apiserver(servers, cluster, CHURN)()
                for server, store, rv in zip(servers, stores, rvs):
                    workloads.wait_mirrored(server, store, rv)
            for server, store in zip(servers, stores):
                for kind in MIRRORED:
                    workloads.wait_mirrored(server, store, kind=kind)
            clock["t"] += 10.0
            torch.cuda.synchronize()
            TF.reset_launch_counts()
            card.manager.reconcile_all()
            torch.cuda.synchronize()
            assert TF.LAUNCHES == {"fused_assign": 1, "shelf_bfd": 1,
                                   "demand_reduce": 0, "pack_bits": 1}, t
            cpu.manager.reconcile_all()
            for plural in PLURALS:
                want = workloads.server_documents(servers[1], plural)
                assert workloads.server_documents(servers[0], plural) == want
                assert want
        assert card.solver_service.stats.fallbacks == 0
    finally:
        for runtime in runtimes:
            runtime.close()
        for store in stores:
            store.close()
        for server in servers:
            server.stop()
