"""The HorizontalAutoscaler tick's fleet-tick families on a CUDA card: the
service's fused tick (a captured CUDA graph) and its chained wire equal
the CPU's numpy rung, the graph capture tolerates concurrent bin-pack
traffic on the service's worker, each family answers host numpy in one
fetch, and a failure on the card raises. Every test carries the `cuda`
marker and skips without a card; on the CPU the same paths are held
against the JAX reference by tests/test_torch_fleet_families.py and
tests/test_torch_ha_tick.py.

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_ha_tick_cuda.py -q
"""

import threading

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import faults, workloads
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops import fusedtick as FT
from karpenter_tpu_torch.solver import SolverService
from karpenter_tpu_torch.utils import operands

pytestmark = pytest.mark.cuda

N_HAS, METRICS, TICKS = 96, 3, 6


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these tests run the service's "
                    "families and the fused tick's CUDA graph on the card")


def _leaves(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def assert_same_bits(got, want):
    got, want = dict(_leaves(got.to_numpy())), dict(_leaves(want.to_numpy()))
    assert got.keys() == want.keys()
    for path, x in got.items():
        y = want[path]
        assert (x is None) == (y is None), path
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, path
            assert x.tobytes() == y.tobytes(), path


def run(svc, fused, ticks=TICKS):
    fleet = workloads.build_ha_fleet(
        N_HAS, METRICS, 0, service=svc, groups=3, pools=4, fused=fused,
        history=32,
    )
    out = []
    for _ in range(ticks):
        errors = fleet.tick()
        svc.note_tick()
        assert all(e is None for e in errors.values())
        out.append((fleet.trail(), fleet.statuses()))
    return out, fleet.registry.expose_text()


def test_card_fused_and_chained_equal_the_cpu():
    runs = {}
    for name, kw, fused in (("fused", {}, True), ("chained", {}, False),
                            ("cpu", dict(device="cpu", backend="numpy"), False)):
        svc = SolverService(registry=GaugeRegistry(), **kw)
        try:
            runs[name] = run(svc, fused)
            if name == "fused":
                st = svc.stats
                assert st.fused_dispatches == TICKS
                assert st.fused_chained_serves == st.fused_mirror_serves == 0
                assert st.last_dispatches_per_tick == 1
                assert svc.fused_program().captures == 1
            if name == "chained":
                assert svc.stats.fallbacks == 0
                assert svc.stats.last_dispatches_per_tick >= 2
        finally:
            svc.close()
    assert runs["fused"] == runs["cpu"]
    assert runs["chained"] == runs["cpu"]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_capture_beside_concurrent_solves(backend):
    """The worker's solves (the kernels' rung, or the torch rung with its
    resident upload) run on while the caller's thread captures the fused
    tick's graph: no lock between them, and neither syncs the device."""
    fields = workloads.build_inputs(2000, 50, 8, 8, seed=1)
    host = TB.BinPackInputs(**fields)
    tick = FT.FusedTickInputs.from_arrays(
        workloads.build_fused_tick_inputs(2, 512, 3, 256, 32, groups=8)
    )
    svc = SolverService(registry=GaugeRegistry())
    stop = threading.Event()
    answers, errors = [], []

    def traffic():
        try:
            while not stop.is_set():
                answers.append(
                    svc.solve(host, backend=backend).nodes_needed.copy()
                )
        except Exception as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    thread = threading.Thread(target=traffic)
    try:
        thread.start()
        while not answers and thread.is_alive():
            stop.wait(0.01)
        got = svc.fused_tick(tick)
        stop.set()
        thread.join(60)
        assert not errors, errors
        assert all(np.array_equal(a, answers[0]) for a in answers)
        assert svc.fused_program().captures == 1
        want = FT.fused_tick_numpy(tick)
        assert_same_bits(got, want)
    finally:
        stop.set()
        svc.close()


def test_each_family_fetches_once_on_the_card():
    svc = SolverService(registry=GaugeRegistry())
    try:
        fleet = workloads.build_ha_fleet(
            N_HAS, METRICS, 1, service=svc, groups=3, pools=4, history=32,
        )
        fleet.tick()
        before = operands.FETCHES["count"]
        fleet.tick()
        st = svc.stats
        assert operands.FETCHES["count"] - before == 4  # decide, forecast, cost, poolgroup
        assert st.forecast_dispatches == 2 and st.cost_dispatches == 2
    finally:
        svc.close()


def test_a_failure_on_the_card_raises():
    svc = SolverService(registry=GaugeRegistry(), health_failure_threshold=5)
    tick = FT.FusedTickInputs.from_arrays(
        workloads.build_fused_tick_inputs(3, 128, 3, 64, 16, groups=4)
    )
    try:
        with faults.injected_faults(seed=5) as reg:
            for point in ("fused.tick", "cost.score", "poolgroup.solve"):
                reg.plan(point, mode="error")
            with pytest.raises(faults.FaultInjected):
                svc.fused_tick(tick)
        st = svc.stats
        assert st.fused_chained_serves == st.fused_mirror_serves == 0
        assert st.device_failures == 1
        assert_same_bits(svc.fused_tick(tick), FT.fused_tick_numpy(tick))
    finally:
        svc.close()
