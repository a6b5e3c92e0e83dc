"""The port's own tests for behaviour that a deselected reference case
checks through a JAX internal or a run without `--device cpu`
(test_torch_reference_suites.py DESELECTED names each case and points
here). Each class runs the reference case's scenario on the port, with
the port's counterpart of the internal it read."""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_reference_suites import _helper, _port_defaults_to_cpu  # noqa: F401

from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
from karpenter_tpu_torch.metrics.producers.pendingcapacity import encoder
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.ops import binpack as B
from karpenter_tpu_torch.ops.numpy_binpack import binpack_numpy
from karpenter_tpu_torch.solver import service as S


class TestCacheResetSeams:
    """recovery's TestCacheResetSeams: the port's process caches are the
    service's seen dispatch keys and its resident operand stacks (there
    is no compile cache), and the encoder's delta cache."""

    def test_solver_service_reset_caches(self):
        svc = S.SolverService(registry=GaugeRegistry(), device="cpu")
        try:
            svc._compile_seen.add(("fake-key",))
            svc._resident._entries["fake"] = object()
            svc.reset_caches()
            assert svc._compile_seen == set()
            assert len(svc._resident._entries) == 0
        finally:
            svc.close()

    def test_recovery_boot_invalidates_process_caches(self, tmp_path):
        recovery = _helper("test_recovery")
        clock = recovery.FakeClock()
        rt1 = recovery._runtime(tmp_path, clock, FakeFactory())
        recovery._kill(rt1)  # leaves journal state + fence generation
        encoder._default_delta._entries["stale"] = object()
        shared = S.default_service()  # outlives in-process restarts
        shared._compile_seen.add(("stale",))
        shared._resident._entries["stale"] = object()
        rt2 = recovery._runtime(tmp_path, clock, FakeFactory())
        try:
            assert rt2.recovery.recovered
            assert len(encoder._default_delta._entries) == 0
            assert shared._compile_seen == set()
            assert len(shared._resident._entries) == 0
            assert rt2.solver_service._compile_seen == set()
        finally:
            rt2.close()
            S.reset_default_service()


class TestConstraintReroute:
    """constraints' TestPallasGuard: the fused CUDA path has no
    constraint entry, so constrained inputs route to the plain program
    (`_fold_for_fused`, counted in REROUTES) and the service counts the
    reroute, with the numpy program's answer."""

    def _world(self, seed):
        constraints = _helper("test_constraints")
        pods, profiles, groups = constraints._random_world(
            np.random.default_rng(seed)
        )
        return constraints._encode(pods, profiles, groups)

    def test_fold_for_fused_reroutes_constrained_inputs(self):
        inputs = self._world(11)
        assert B.has_constraint_operands(inputs)
        before = B.REROUTES["constraints"]
        _, route = B._fold_for_fused(inputs)
        assert route == "torch"
        assert B.REROUTES["constraints"] == before + 1

    def test_service_reroutes_and_counts(self, monkeypatch):
        """A CPU service held to the card's route: the cuda rung resolves
        as on the card, and the kernels' build is only recorded."""
        real = S.SolverService._resolve_backend
        monkeypatch.setattr(
            S.SolverService, "_resolve_backend",
            lambda self, b: "cuda" if (b or self.backend) == "cuda"
            else real(self, b),
        )
        builds = []
        monkeypatch.setattr(S.SolverService, "_ensure_kernels",
                            lambda self: builds.append(1))
        inputs = self._world(12)
        service = S.SolverService(
            registry=GaugeRegistry(), device="cpu", backend="cuda",
            health_failure_threshold=100,
        )
        try:
            built = len(builds)
            out = service.solve(inputs, buckets=8)
            assert service.stats.constraint_reroutes >= 1
            assert len(builds) == built  # never routed to the kernels
            ref = binpack_numpy(inputs, buckets=8)
            np.testing.assert_array_equal(
                np.asarray(out.assigned), np.asarray(ref.assigned)
            )
        finally:
            service.close()


def _with_device_cpu(main):
    def run(argv):
        return main(list(argv) + ["--device", "cpu"])

    return run


_observability = _helper("test_observability")
fresh_tracer = _observability.fresh_tracer
fresh_recorder = _observability.fresh_recorder


class TestCliOnCpu:
    """wiring's TestCLI and TestRealClusterModeCLI, simulate's and
    simlab's CLI cases and observability's TestTraceExportAcceptance, run
    as the reference wrote them with `--device cpu` added to the binary's
    arguments (the port's binary never falls back to the CPU)."""

    @pytest.mark.parametrize("case", [
        "test_main_runs_and_exits", "test_main_with_leader_election",
    ])
    def test_wiring_cli(self, case, monkeypatch, capsys):
        wiring = _helper("test_wiring")
        monkeypatch.setattr(wiring, "cli_main", _with_device_cpu(wiring.cli_main))
        test = getattr(wiring.TestCLI(), case)
        test(capsys) if case == "test_main_runs_and_exits" else test()

    def test_main_against_fake_apiserver_converges(self, monkeypatch):
        wiring = _helper("test_wiring")
        monkeypatch.setattr(wiring, "cli_main", _with_device_cpu(wiring.cli_main))
        wiring.TestRealClusterModeCLI().test_main_against_fake_apiserver_converges()

    @pytest.mark.parametrize("case", [
        "TestSimulateCLI::test_cli_simulate_with_what_if",
        "TestSimulateCLI::test_cli_rejects_non_list_what_if",
        "TestSimulateFidelity::test_empty_what_if_list_still_yields_delta_shape",
    ])
    def test_simulate_cli(self, case, tmp_path, capsys, monkeypatch):
        import karpenter_tpu_torch.__main__ as port_main

        monkeypatch.setattr(port_main, "main", _with_device_cpu(port_main.main))
        owner, test = case.split("::")
        getattr(getattr(_helper("test_simulate"), owner)(), test)(
            tmp_path, capsys)

    def test_simlab_default_seed_digests(self, tmp_path, capsys, monkeypatch):
        import karpenter_tpu_torch.__main__ as port_main

        monkeypatch.setattr(port_main, "main", _with_device_cpu(port_main.main))
        _helper("test_simlab").TestCLI(
        ).test_default_seed_digests_pinned_and_sim_seed_threads(tmp_path, capsys)

    def test_simulate_trace_export_end_to_end(
        self, fresh_tracer, fresh_recorder, tmp_path, capsys, monkeypatch
    ):
        import karpenter_tpu_torch.__main__ as port_main

        monkeypatch.setattr(port_main, "main", _with_device_cpu(port_main.main))
        _observability.TestTraceExportAcceptance().test_simulate_trace_export_end_to_end(
            fresh_tracer, fresh_recorder, tmp_path, capsys
        )


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_service_backend_names(backend):
    """The rename the loaded suites rely on: the reference's "xla" rung
    is the port's "torch", and both name a real rung on the CPU."""
    svc = S.SolverService(registry=GaugeRegistry(), device="cpu",
                          backend=backend)
    try:
        assert svc._resolve_backend(backend) == backend
    finally:
        svc.close()
