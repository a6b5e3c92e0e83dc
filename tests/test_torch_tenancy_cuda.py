"""The port's multi-tenant control plane and introspection plane on a CUDA
card. Every test carries the `cuda` marker and skips without a card (the
cuda rung launches CUDA C++ kernels with no interpret mode); on the CPU,
tests/test_torch_tenancy.py, tests/test_torch_introspect.py and
tests/test_torch_simulate_multitenant.py hold both planes against the
reference.

  * solve_all on SolverService() launches each CUDA kernel once per
    tenant, and every tenant's outputs equal its direct
    solve(backend="cuda") and the plain program on the CPU;
  * fused_tick_all takes one FusedTickProgram (CUDA-graph) dispatch for
    the round, each tenant's slice equal to fused_tick_numpy;
  * the card rule: a degraded tenant is served by its own device
    dispatch, never a numpy mirror;
  * a runtime with a tenant config and the introspection plane reports
    the card's memory and ledgers the kernels' build.

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_tenancy_cuda.py -q
"""

import json

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import faults, workloads
from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.ops import binpack as B
from karpenter_tpu_torch.ops import cost as CK
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.ops import fusedtick as FT
from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
from karpenter_tpu_torch.simulate import simulate_multitenant
from karpenter_tpu_torch.solver import SolverService
from karpenter_tpu_torch.tenancy import (
    MultiTenantScheduler,
    TenantRegistry,
    TenantSpec,
)

pytestmark = pytest.mark.cuda

TENANTS = 8


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cuda rung launches CUDA C++ "
                    "kernels with no interpret mode")


def world(n=TENANTS, **kw):
    service = SolverService(registry=GaugeRegistry())
    registry = TenantRegistry(
        service=service, registry=GaugeRegistry(),
        specs=[TenantSpec(id=f"t{i}", weight=1.0 + i % 3) for i in range(n)],
    )
    return service, MultiTenantScheduler(registry, service, **kw)


def fields_of(i):
    return workloads.build_inputs(200 + 13 * i, 30 + i, 8, 8, seed=700 + i)


def host(out):
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
            for k, v in vars(out).items()}


def test_solve_all_launches_each_kernel_once_per_tenant():
    service, sched = world()
    batch = {f"t{i}": B.inputs_from_numpy(fields_of(i), device="cpu")
             for i in range(TENANTS)}
    try:
        TF.reset_launch_counts()
        out = sched.solve_all(batch)
        assert TF.LAUNCHES == {"fused_assign": TENANTS, "shelf_bfd": TENANTS,
                               "demand_reduce": 0, "pack_bits": TENANTS}
        for tenant, inputs in batch.items():
            direct = host(B.solve(inputs, backend="cuda"))
            plain = host(B.solve(inputs, backend="torch", device="cpu"))
            got = host(out[tenant])
            for name in direct:
                np.testing.assert_array_equal(got[name], direct[name])
                np.testing.assert_array_equal(got[name], plain[name])
        assert sched.stats.mirror_served == 0
    finally:
        service.close()


def test_fused_tick_all_is_one_graph_dispatch():
    service, sched = world()
    batch = {
        f"t{i}": FT.FusedTickInputs.from_arrays(
            workloads.build_fused_tick_inputs(800 + i, 16, 2, 12, 24))
        for i in range(TENANTS)
    }
    try:
        out = sched.fused_tick_all(batch)
        assert sched.stats.fused_dispatches == 1
        assert service.stats.fused_dispatches == 1
        assert service.fused_program().captures == 1
        for tenant, inputs in batch.items():
            want = FT.fused_tick_numpy(inputs)
            for name in ("desired", "recommendation", "limited"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(out[tenant].decision, name)),
                    np.asarray(getattr(want.decision, name)))
    finally:
        service.close()


def cost_draw(seed, n=12, m=2):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 100, n).astype(np.int32)
    return CK.CostInputs.from_arrays({
        "base_desired": base,
        "min_replicas": rng.randint(0, 5, n).astype(np.int32),
        "max_replicas": (base + rng.randint(0, 300, n)).astype(np.int32),
        "unit_cost": rng.choice([0.0, 0.07, 1.7], n).astype(np.float32),
        "slo_weight": rng.choice([0.0, 1.0, 333.3], n).astype(np.float32),
        "max_hourly_cost": rng.choice([0.0, 55.5], n).astype(np.float32),
        "slo_valid": rng.rand(n) > 0.3,
        "slo_target": rng.uniform(0.5, 10, (n, m)).astype(np.float32),
        "demand_mu": rng.uniform(0, 500, (n, m)).astype(np.float32),
        "demand_sigma": rng.choice([0.0, 25.0], (n, m)).astype(np.float32),
        "demand_valid": rng.rand(n, m) > 0.2,
    })


def test_card_rule_serves_a_degraded_tenant_on_the_device():
    service, sched = world(4, breaker_threshold=1, breaker_reset_s=3600.0)
    batch = {f"t{i}": cost_draw(30 + i) for i in range(4)}
    try:
        assert sched.card_rule
        with faults.injected_faults(seed=1) as reg:
            reg.plan("tenancy.gather.t2", mode="error")
            out = sched.cost_all(batch)
            out = sched.cost_all(batch)
        for tenant, inputs in batch.items():
            want = CK.cost_numpy(inputs)
            np.testing.assert_array_equal(np.asarray(out[tenant].desired),
                                          np.asarray(want.desired))
        assert sched.breakers.is_open("t2")
        assert sched.stats.mirror_served == 0
        assert sched.stats.isolated_dispatches == 2
    finally:
        service.close()


def test_replay_on_the_card_equals_the_cpu():
    card = simulate_multitenant(tenants=32, ticks=4)
    cpu = simulate_multitenant(tenants=32, ticks=4, device="cpu")
    assert card["aggregate_replicas"] == cpu["aggregate_replicas"]
    assert card["mirror_served"] == 0


def test_runtime_with_tenants_and_introspection(tmp_path):
    config = tmp_path / "tenants.json"
    config.write_text(json.dumps([{"id": "a"}, {"id": "b", "weight": 2.0}]))
    provider = FakeFactory()
    rt = KarpenterRuntime(
        Options(tenant_config=str(config), introspect=True),
        cloud_provider_factory=provider,
    )
    try:
        workloads.build_runtime_world(rt.store, provider, 500, 6, 8, 2, 0)
        rt.manager.reconcile_all()
        doc = rt.solver_introspection.snapshot()
        assert doc["enabled"] is True
        families = doc["compile"]["by_family"]
        assert families.get("kernels") == 1 and families.get("solve", 0) >= 1
        devices = doc["device_memory"]["devices"]
        assert devices and devices[0]["bytes_limit"] > devices[0]["bytes_in_use"] > 0
        assert rt.solver_introspection.memory_source() is False
        assert rt.tenancy.tenants() == ["a", "b"]
        assert "karpenter_tenant_active" in rt.registry.expose_text()
    finally:
        rt.close()
