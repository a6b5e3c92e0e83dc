"""The `--simulate` entry point and SimLab's sim families on a CUDA card.
Every test carries the `cuda` marker and skips without a card (the dry
run's solve launches CUDA C++ kernels with no interpret mode); on the
CPU, tests/test_torch_simstep.py, test_torch_simlab.py and
test_torch_simulate*.py hold the same paths against the reference.

  * sim_step and sim_rollout on the card == the numpy mirror, bitwise,
    batched and unbatched, through SolverService() with no mirror serve;
  * the card's sim family raises under a simlab.step error plan, then
    SolverDeviceError once degraded, and serves no mirror;
  * simulate() on a card runtime launches each CUDA kernel once (twice
    for simulate_delta) and equals the CPU's report; the consolidation
    report launches each kernel once per candidate with pods;
  * `python -m karpenter_tpu_torch --simulate` on the card prints the
    CPU's report.

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_simulate_cuda.py -q
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import faults, workloads
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.ops import simstep as SK
from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
from karpenter_tpu_torch.solver.service import SolverDeviceError, SolverService

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("replicas", "streak", "violation", "cost", "backlog", "target")
DRY = dict(pods=2000, types=16, seed=0)
DISRUPTION = dict(nodes=40, pods=400, pending_critical=6, seed=0)


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dry run's solve launches CUDA "
                    "C++ kernels with no interpret mode")


def _equal(got, want, index=None):
    for name in FIELDS:
        a = np.asarray(getattr(got, name))
        if index is not None:
            a = a[index]
        assert a.tobytes() == np.asarray(getattr(want, name)).tobytes(), name


def test_sim_rollout_on_the_card_equals_the_mirror():
    svc = SolverService(registry=GaugeRegistry())
    try:
        host = SK.SimRolloutInputs(
            **workloads.build_sim_rollout_inputs(64, 96, 8, 3))
        out = svc.sim_rollout(host)
        _equal(out, SK.sim_rollout_numpy(host))
        for b in (0, 63):
            _equal(out, svc.sim_rollout(SK._cluster_slice(host, b)), index=b)
        step = SK.SimStepInputs(
            replicas=host.replicas0, target=host.forecast[:, 5],
            demand=host.demand[:, 5], price=host.price[:, 5],
            fault=host.fault[:, 5], cap=host.cap, hourly=host.hourly,
            step_limit=host.step_limit, min_replicas=host.min_replicas,
            max_replicas=host.max_replicas,
        )
        got, want = svc.sim_step(step), SK.sim_step_numpy(step)
        for name in ("replicas", "violation", "cost", "backlog"):
            assert np.asarray(getattr(got, name)).tobytes() == \
                np.asarray(getattr(want, name)).tobytes()
        assert svc.stats.sim_mirror_serves == 0
        assert svc.stats.sim_dispatches == 4
    finally:
        svc.close()


def test_the_card_raises_under_a_fault_plan():
    svc = SolverService(registry=GaugeRegistry(), health_failure_threshold=1)
    try:
        host = SK.SimRolloutInputs(
            **workloads.build_sim_rollout_inputs(4, 8, 8, 1))
        with faults.injected_faults(seed=2) as reg:
            reg.plan("simlab.step", mode="error")
            with pytest.raises(faults.FaultInjected):
                svc.sim_rollout(host)
            with pytest.raises(SolverDeviceError):
                svc.sim_rollout(host)
        assert svc.stats.sim_mirror_serves == 0
    finally:
        svc.close()


def _runtime_over(path, device=None):
    return KarpenterRuntime(Options(data_dir=path, device=device))


def test_dry_run_launches_each_kernel_once_and_equals_the_cpu(tmp_path):
    from karpenter_tpu_torch import simulate as SIM

    workloads.write_reconcile_dir(str(tmp_path / "card"), **DRY)
    workloads.write_reconcile_dir(str(tmp_path / "cpu"), **DRY)
    reports = {}
    for device in (None, "cpu"):
        runtime = _runtime_over(str(tmp_path / (device or "card")), device)
        try:
            kwargs = dict(
                solver=runtime.solver_service.solve,
                template_resolver=runtime.producer_factory.template_resolver(),
                cost_model=runtime.cost_model,
            )
            TF.reset_launch_counts()
            plain = SIM.simulate(runtime.store, **kwargs)
            once = dict(TF.LAUNCHES)
            TF.reset_launch_counts()
            delta = SIM.simulate_delta(runtime.store,
                                       workloads.what_if_specs(), **kwargs)
            twice = dict(TF.LAUNCHES)
            reports[device] = (plain, delta, once, twice)
        finally:
            runtime.close()
    card, cpu = reports[None], reports["cpu"]
    assert card[:2] == cpu[:2]
    assert card[2] == {"fused_assign": 1, "shelf_bfd": 1, "demand_reduce": 0,
                       "pack_bits": 1}
    assert card[3] == {"fused_assign": 2, "shelf_bfd": 2, "demand_reduce": 0,
                       "pack_bits": 2}
    assert cpu[2] == cpu[3] == {"fused_assign": 0, "shelf_bfd": 0,
                                "demand_reduce": 0, "pack_bits": 0}


def test_consolidation_launches_once_per_candidate_with_pods(tmp_path):
    from karpenter_tpu_torch import simulate as SIM

    workloads.write_disruption_dir(str(tmp_path / "card"), **DISRUPTION)
    workloads.write_disruption_dir(str(tmp_path / "cpu"), **DISRUPTION)
    reports = {}
    for device in (None, "cpu"):
        runtime = _runtime_over(str(tmp_path / (device or "card")), device)
        try:
            TF.reset_launch_counts()
            reports[device] = (SIM.simulate_consolidation(
                runtime.store, service=runtime.solver_service),
                dict(TF.LAUNCHES))
        finally:
            runtime.close()
    (card, launches), (cpu, _) = reports[None], reports["cpu"]
    assert card == cpu
    with_pods = sum(1 for e in card["nodes"].values()
                    if "ineligible" not in e and e["pods"] > 0)
    assert launches == {"fused_assign": with_pods, "shelf_bfd": with_pods,
                        "demand_reduce": 0, "pack_bits": with_pods}


def test_the_binary_on_the_card_prints_the_cpus_report(tmp_path):
    out = {}
    for device in ("card", "cpu"):
        path = str(tmp_path / device)
        workloads.write_reconcile_dir(path, **DRY)
        argv = [sys.executable, "-m", "karpenter_tpu_torch", "--simulate",
                "--data-dir", path, "--no-leader-elect"]
        if device == "cpu":
            argv += ["--device", "cpu"]
        proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out[device] = json.loads(proc.stdout)
        assert ("cuda" in proc.stderr) == (device == "card")
    assert out["card"] == out["cpu"]
