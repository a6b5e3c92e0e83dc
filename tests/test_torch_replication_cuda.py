"""The port's replicated control plane with its replicas on a CUDA card.
Every test carries the `cuda` marker and skips without a card (each
replica's MetricsProducer solve launches CUDA C++ kernels with no
interpret mode); on the CPU, tests/test_torch_replication.py holds the
plane, the failover world and replicated runtimes against the reference.

  * three card runtimes with partitions and a tenant config over one
    store (workloads.ReplicaFleet), the biggest owner killed: both
    kernels launch on every live replica's tick, the survivors take
    every partition and adopt the victim's tenants at a fence
    generation of 2 or more, and every tick equals a CPU fleet's;
  * a replicated runtime on the default device runs the cuda rung;
  * `--simulate --failover` passes the card's device check and prints
    the CPU's report.

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_replication_cuda.py -q
"""

import contextlib
import io
import json

import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.api.serialization import to_dict
from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
from karpenter_tpu_torch.store import Store

pytestmark = pytest.mark.cuda

WORLD = dict(pods=2000, types=40, n_has=24, metrics=2, seed=0, groups=2)


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the replicas' solves launch CUDA "
                    "C++ kernels with no interpret mode")


class Clock:
    def __init__(self):
        self.now = 1_000_000.0

    def __call__(self):
        return self.now


def run(device, root, launches=None):
    store, provider = Store(), FakeFactory()
    world = workloads.build_runtime_world(store, provider, **WORLD)
    root.mkdir()
    config = root / "tenants.json"
    config.write_text(json.dumps([{"id": f"tenant-{i}"} for i in range(8)]))
    options = dict(partitions=8, lease_duration_s=5.0,
                   tenant_config=str(config), journal_dir=str(root / "j"),
                   device=device)
    fleet = workloads.ReplicaFleet(store, provider, ["r0", "r1", "r2"],
                                   Clock(), options)
    trail = []

    def each(rid, tick):
        TF.reset_launch_counts()
        try:
            tick()
        finally:
            launches.append((rid, dict(TF.LAUNCHES)))

    try:
        victim = fleet.failover(
            world, before=3, after=3, churn=50, tick_s=5.0,
            record=lambda tick, died: trail.append(
                (died, fleet.snapshot(to_dict))),
            each=each if launches is not None else None)
    finally:
        fleet.close()
    return victim, trail


def test_replicas_on_the_card_equal_the_cpu(tmp_path):
    launches = []
    victim, card = run(None, tmp_path / "card", launches)
    cpu_victim, cpu = run("cpu", tmp_path / "cpu")
    assert victim == cpu_victim
    assert len(launches) == 3 * 4 + 2 * 3
    assert all(n == {"fused_assign": 1, "shelf_bfd": 1, "demand_reduce": 0,
                     "pack_bits": 1}
               for _, n in launches), launches
    for tick, (got, want) in enumerate(zip(card, cpu)):
        assert got == want, f"tick {tick}"
    state = card[-1][1]["state"]
    assert sorted(p for s in state.values() for p in s["owned"]) == list(
        range(8))
    adopted = card[2][1]["state"][victim]["tenants"]
    assert adopted
    for tenant in adopted:
        (owner,) = [s for s in state.values() if tenant in s["tenants"]]
        status, generation, _ = owner["tenants"][tenant]
        assert status == "serving" and generation >= 2


def test_default_device_replica_runs_the_cuda_rung():
    clock, store, provider = Clock(), Store(), FakeFactory()
    workloads.build_runtime_world(store, provider, 500, 6, 8, 2, 0)
    rt = KarpenterRuntime(
        Options(partitions=2, replica_id="r0", lease_duration_s=5.0),
        store=store, cloud_provider_factory=provider, clock=clock,
    )
    try:
        TF.reset_launch_counts()
        for _ in range(2):
            clock.now += 5.0
            rt.manager.reconcile_all()
        assert TF.LAUNCHES["fused_assign"] >= 1
        assert rt.replication.leases.owned == {0, 1}
        assert rt.solver_service.stats.fallbacks == 0
    finally:
        rt.close()


def test_failover_world_on_the_card():
    from karpenter_tpu_torch import __main__ as main_module

    outs = []
    for argv in (["--simulate", "--failover"],
                 ["--simulate", "--failover", "--device", "cpu"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main_module.main(argv) == 0
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert json.loads(outs[0])["converged"]
