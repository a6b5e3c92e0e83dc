"""The solver sidecar on a CUDA card. Every test carries the `cuda` marker
and skips without a card (the sidecar's service launches CUDA C++ kernels
with no interpret mode); on the CPU, tests/test_torch_sidecar.py holds
the port's sidecar against the reference's.

  * each CUDA kernel launches exactly once per Solve RPC, and the card's
    answers equal the torch CPU rung's;
  * Decide on the card equals decide on the CPU, bitwise on every leaf;
  * the shipped Deployment's world (workloads.build_deployment_world)
    through a CPU controller with solver_uri to the card's sidecar equals
    an in-process CPU runtime after every tick, each kernel launching
    once per churned tick, all of them in the sidecar's service.

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_sidecar_cuda.py -q
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops import decision as TD
from karpenter_tpu_torch.ops import fused_assign as TF

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sidecar's service launches "
                    "CUDA C++ kernels with no interpret mode")


@pytest.fixture()
def card_sidecar():
    from karpenter_tpu_torch.sidecar import SolverClient, SolverServer
    from karpenter_tpu_torch.solver import reset_default_service

    server = SolverServer(port=0, host="127.0.0.1")
    port = server.start()
    client = SolverClient(f"127.0.0.1:{port}")
    try:
        yield server, client
    finally:
        client.close()
        server.stop()
        reset_default_service()


def _inputs(seed, pods=2000, types_=40):
    fields = workloads.build_inputs(pods, types_, 8, 8, seed=seed)
    names = {f.name for f in dataclasses.fields(TB.BinPackInputs)}
    return TB.BinPackInputs(**{k: v for k, v in fields.items() if k in names})


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def test_one_launch_of_each_kernel_per_solve_rpc(card_sidecar):
    server, client = card_sidecar
    assert client.health() == (True, {"backend": "cuda",
                                      "device_count": torch.cuda.device_count()})
    for seed in range(3):
        inputs = _inputs(seed)
        torch.cuda.synchronize()
        TF.reset_launch_counts()
        got = client.solve(inputs)
        assert dict(TF.LAUNCHES) == {"fused_assign": 1, "shelf_bfd": 1,
                                     "demand_reduce": 0, "pack_bits": 1}
        want = TB.solve(inputs, backend="torch", device="cpu")
        for name, value in _leaves(got).items():
            np.testing.assert_array_equal(
                value, getattr(want, name).numpy(), err_msg=name)
    assert server.reset_rpcs()["Solve"][0] == 3


def test_decide_on_the_card_equals_the_cpu(card_sidecar):
    _, client = card_sidecar
    for forecast in (False, True):
        fields = workloads.build_decision_inputs(5, 4096, 3,
                                                 forecast=forecast)
        names = {f.name for f in dataclasses.fields(TD.DecisionInputs)}
        got = client.decide(TD.DecisionInputs(
            **{k: v for k, v in fields.items() if k in names}))
        want = TD.decide(TD.DecisionInputs.from_numpy(fields, "cpu"))
        for name, value in _leaves(got).items():
            expect = getattr(want, name).numpy()
            assert value.dtype == expect.dtype, name
            assert value.tobytes() == expect.tobytes(), name


def test_deployment_world_through_the_card_sidecar(card_sidecar):
    from karpenter_tpu_torch.api.serialization import to_dict
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
    from karpenter_tpu_torch.store import Store

    server, _ = card_sidecar
    api = workloads.deployment_api()
    runs = []
    for uri in (f"127.0.0.1:{server.port}", None):
        store = Store()
        manager = workloads.FakeClusterManager()
        cluster = workloads.build_deployment_world(store, 2000, 24, 0,
                                                   tpu_pods=4)
        now = [1000.0]
        options = Options(solver_uri=uri, device="cuda" if uri else "cpu")
        runtime = KarpenterRuntime(
            options, store=store, clock=lambda now=now: now[0],
            cloud_provider_factory=workloads.tpu_factory(api, manager, store))
        runs.append((store, manager, cluster, now, runtime))
    try:
        assert runs[0][4].solver_service.device.type == "cpu"
        assert not runs[0][4].solver_service._numpy_ladder
        for tick in range(4):
            snaps = []
            torch.cuda.synchronize()
            TF.reset_launch_counts()
            for store, manager, cluster, now, runtime in runs:
                if tick:
                    now[0] += 5.0
                    workloads.churn_reconcile(cluster, 20)()
                runtime.manager.reconcile_all()
                snap = workloads.runtime_snapshot(
                    store, runtime.registry,
                    types.SimpleNamespace(node_replicas={}), to_dict,
                    skip=workloads.RUNG_SKIP, pods="fields")
                snap["resizes"] = manager.take_resizes()
                snaps.append(snap)
            assert dict(TF.LAUNCHES) == {"fused_assign": 1, "shelf_bfd": 1,
                                         "demand_reduce": 0, "pack_bits": 1}
            assert snaps[0] == snaps[1], tick
        assert runs[0][4].solver_service.stats.fallbacks == 0
    finally:
        for *_, runtime in runs:
            runtime.close()
