"""The port's process entry point (`python -m karpenter_tpu_torch`), its
HTTP surface and leader election, against the reference's, on the CPU.

  * parse_args gives the reference's value for every flag both packages
    have, with and without `--profile production`;
  * `main(... --device cpu)` runs ticks and returns 0; without
    `--device cpu` and with no card it exits non-zero with the reason and
    runs no tick;
  * `--apiserver` and `--webhook-port` parse as the reference's; the
    binary ticks over a fake kube-apiserver and exits 0 on SIGTERM, main
    serves the webhooks, and without a card `--apiserver` exits 1 before
    any watch;
  * `--solver-uri` and `--cloud-provider aws|tpu` parse as the
    reference's and run (the controller beside a CPU sidecar, the
    providers' factories with no SDK bound); Options.solver_uri fronts
    the sidecar;
  * `--shard-mesh` parses with the reference's errors, and the three
    shard options reach the runtime's service; `--tenant-config`,
    `--introspect` and `--partitions` (and their Options fields) run;
    `--simulate`,
    `--list` and `--sim-seed` parse as the reference's and run, and
    Options.sim_seed is carried;
  * MetricsServer's routes and LeaderElector behave as in
    tests/test_wiring.py, on both packages.
"""

from __future__ import annotations

import importlib
import json
import os
import urllib.error
import urllib.request

import pytest
import torch

from karpenter_tpu_torch import __main__ as port_main
from karpenter_tpu_torch import runtime as port_runtime
from karpenter_tpu_torch.controllers.engine import Manager

REF, PORT = "karpenter_tpu", "karpenter_tpu_torch"


def mod(package: str, name: str):
    return importlib.import_module(f"{package}.{name}")


class FakeClock:
    def __init__(self, start=1000.0):
        self.now = start

    def __call__(self):
        return self.now

    def advance(self, seconds):
        self.now += seconds


# -- flags -------------------------------------------------------------------


class TestParseArgs:
    @pytest.mark.parametrize("argv", [
        [], ["--profile", "production"],
        ["--profile", "production", "--no-event-driven", "--selfslo-objective",
         "2.5"],
        ["--event-driven", "--poolgroups", "--consolidate", "--preempt",
         "--journal-dir", "j", "--data-dir", "d", "--backoff-base", "2"],
    ], ids=["defaults", "production", "production_overrides", "explicit"])
    def test_every_shared_flag_matches_the_reference(self, argv):
        want = vars(mod(REF, "__main__").parse_args(argv))
        got = vars(port_main.parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want

    @pytest.mark.parametrize("argv,message", [
        (["--selfslo-target", "1.5"], "--selfslo-target must be in (0, 1)"),
        (["--selfslo-objective", "0"], "--selfslo-objective must be > 0"),
        (["--introspect-storm-threshold", "0"],
         "--introspect-storm-threshold must be >= 1"),
        (["--event-debounce", "-1"], "--event-debounce must be >= 0"),
        (["--device", "tpu"], "invalid choice"),
    ])
    def test_usage_errors_exit_2(self, argv, message, capsys):
        with pytest.raises(SystemExit) as exit_info:
            port_main.parse_args(argv)
        assert exit_info.value.code == 2
        assert message in capsys.readouterr().err

    @pytest.mark.parametrize("spec,want", [
        ("8x1", (8, 1)), ("2X4", (2, 4)), ("", None),
    ])
    def test_shard_mesh_parses_as_the_reference(self, spec, want):
        """--shard-mesh (the sharded dispatch of parallel/mesh.py, which
        used to exit 2) parses PODSxGROUPS as the reference's does."""
        from karpenter_tpu.__main__ import _parse_mesh_shape as ref_parse

        assert port_main._parse_mesh_shape(spec) == want == ref_parse(spec)
        args = port_main.parse_args(["--shard-mesh", spec] if spec else [])
        assert args.shard_mesh == (spec or None)

    @pytest.mark.parametrize("spec", ["8", "ax1", "0x2"])
    def test_bad_shard_mesh_exits_as_the_reference(self, spec):
        from karpenter_tpu.__main__ import _parse_mesh_shape as ref_parse

        with pytest.raises(SystemExit) as port_exit:
            port_main._parse_mesh_shape(spec)
        with pytest.raises(SystemExit) as ref_exit:
            ref_parse(spec)
        assert str(port_exit.value) == str(ref_exit.value)

    @pytest.mark.parametrize("flag", ["--tenant-config", "--introspect"])
    def test_ported_flag_runs(self, flag, tmp_path, monkeypatch, capsys):
        """The two flags that used to exit 2 (tenancy/ and
        observability/devicetelemetry.py) parse as the reference's and
        build their planes in a CPU run of main."""
        config = tmp_path / "tenants.json"
        config.write_text(json.dumps([
            {"id": "a", "weight": 1.0}, {"id": "b", "weight": 3.0},
        ]))
        argv = {"--tenant-config": [flag, str(config)],
                "--introspect": [flag]}[flag]
        ref_args = vars(mod(REF, "__main__").parse_args(argv))
        port_args = vars(port_main.parse_args(argv))
        assert {k: port_args[k] for k in ref_args if k in port_args} == {
            k: v for k, v in ref_args.items() if k in port_args
        }
        built = []
        real = port_runtime.KarpenterRuntime._build_selfslo

        def spy(self, options):
            built.append((
                self.tenancy and self.tenancy.tenants(),
                self.solver_introspection.enabled,
            ))
            return real(self, options)

        monkeypatch.setattr(port_runtime.KarpenterRuntime, "_build_selfslo",
                            spy)
        rc = port_main.main(argv + [
            "--device", "cpu", "--duration", "0.3", "--tick", "0.05",
            "--metrics-port", "0", "--no-leader-elect",
        ])
        assert rc == 0
        (tenants, enabled), = built
        if flag == "--tenant-config":
            assert tenants == ["a", "b"] and not enabled
        else:
            assert tenants is None and enabled

    def test_partitions_flag_runs(self, tmp_path, monkeypatch):
        """--partitions used to exit 2 naming replication/: it now parses
        as the reference's and runs main on the CPU as one replica, with
        the lease plane in place of the --leader-elect gate (every
        replica ticks) and the plane handed to /debug/replicas."""
        argv = ["--partitions", "2", "--replica-id", "r0",
                "--lease-duration", "3"]
        ref_args = vars(mod(REF, "__main__").parse_args(argv))
        port_args = vars(port_main.parse_args(argv))
        assert {k: port_args[k] for k in ref_args if k in port_args} == {
            k: v for k, v in ref_args.items() if k in port_args
        }
        seen = {}
        real_server = port_main.MetricsServer

        def server(*args, **kw):
            seen["replication"] = kw.get("replication")
            return real_server(*args, **kw)

        real_loop = port_main._run_loop

        def loop(args, runtime, elector):
            seen["elector"] = elector
            real_loop(args, runtime, elector)
            seen["board"] = runtime.replication.scoreboard()
            seen["leases"] = sorted(
                lease.metadata.name for lease in runtime.store.list("Lease"))

        monkeypatch.setattr(port_main, "MetricsServer", server)
        monkeypatch.setattr(port_main, "_run_loop", loop)
        rc = port_main.main(argv + [
            "--device", "cpu", "--duration", "0.5", "--tick", "0.05",
            "--metrics-port", "0", "--leader-elect",
        ])
        assert rc == 0
        assert seen["elector"] is None
        assert seen["replication"] is not None
        board = seen["board"]
        assert board["replica"] == "r0" and board["partitions"] == 2
        assert board["owned"] == [0, 1]
        assert seen["leases"] == ["karpenter-partition-0",
                                  "karpenter-partition-1",
                                  "karpenter-replica-r0"]


@pytest.fixture()
def no_live_gcp(monkeypatch):
    """The TPU provider's registry factory binds the google-cloud SDKs
    that are importable; monitoring_v3 is, here, and building its client
    looks for credentials on the GCE metadata server. Run as if absent."""
    from karpenter_tpu_torch.cloudprovider import gke_sdk

    monkeypatch.setattr(gke_sdk, "monitoring_sdk_available", lambda: False)
    monkeypatch.setattr(gke_sdk, "container_sdk_available", lambda: False)


class TestDeploymentFlags:
    """--solver-uri (sidecar/) and --cloud-provider aws|tpu
    (cloudprovider/aws.py, cloudprovider/tpu.py) are ported: they parse
    as the reference's and run."""

    @pytest.mark.parametrize("argv", [
        ["--solver-uri", "localhost:50051"],
        ["--cloud-provider", "aws"],
        ["--cloud-provider", "tpu"],
        # config/manager/manager.yaml's controller container
        ["--apiserver", "https://kubernetes.default.svc",
         "--cloud-provider=tpu", "--solver-uri=127.0.0.1:9090",
         "--webhook-port", "9443", "--profile", "production"],
    ], ids=["solver_uri", "aws", "tpu", "deployment"])
    def test_parse_as_the_reference(self, argv):
        want = vars(mod(REF, "__main__").parse_args(argv))
        got = vars(port_main.parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want

    @pytest.mark.parametrize("provider,factory", [
        ("aws", "AWSFactory"), ("tpu", "TPUFactory"),
    ])
    def test_cloud_provider_builds_the_provider(self, provider, factory,
                                                no_live_gcp):
        """The binary's runtime gets the provider's factory, bound to no
        SDK here: a pool answers the reference's not-implemented
        guidance."""
        from karpenter_tpu_torch.api.scalablenodegroup import (
            AWS_EC2_AUTO_SCALING_GROUP,
            TPU_POD_SLICE_POOL,
            ScalableNodeGroupSpec,
        )

        args = port_main.parse_args(["--cloud-provider", provider,
                                     "--device", "cpu"])
        rt = port_main._build_runtime(args)
        try:
            assert type(rt.cloud_provider).__name__ == factory
            spec = ScalableNodeGroupSpec(
                type=TPU_POD_SLICE_POOL if provider == "tpu"
                else AWS_EC2_AUTO_SCALING_GROUP,
                id=("projects/p/locations/l/nodePools/a"
                    if provider == "tpu" else "my-asg"))
            group = rt.cloud_provider.node_group_for(spec)
            with pytest.raises(Exception, match="client bound"):
                group.set_replicas(2)
        finally:
            rt.close()

    def test_solver_uri_binary_runs_on_a_cpu_sidecar(self, capsys):
        from karpenter_tpu_torch.sidecar import SolverServer

        server = SolverServer(port=0, host="127.0.0.1", device="cpu")
        port = server.start()
        try:
            rc = port_main.main([
                "--solver-uri", f"127.0.0.1:{port}", "--device", "cpu",
                "--metrics-port", "0", "--duration", "0.3", "--tick", "0.1",
                "--no-leader-elect"])
            assert rc == 0
            assert "solver sidecar at" in capsys.readouterr().err
        finally:
            server.stop()


class TestRealClusterFlags:
    """--apiserver (store/kube.py) and --webhook-port (webhook.py) are
    ported: they parse as the reference's and run."""

    @pytest.mark.parametrize("argv", [
        ["--apiserver", "https://kubernetes.default.svc"],
        ["--apiserver", "http://127.0.0.1:1", "--kube-token-file", "t",
         "--kube-ca", "ca.crt", "--kube-insecure"],
        ["--webhook-port", "9443"],
        ["--webhook-port", "9443", "--webhook-cert-dir", "certs",
         "--apiserver", "https://k8s", "--profile", "production"],
    ], ids=["apiserver", "kube_auth", "webhook", "both"])
    def test_parse_as_the_reference(self, argv):
        want = vars(mod(REF, "__main__").parse_args(argv))
        got = vars(port_main.parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want

    def test_apiserver_binary_ticks_and_exits_0_on_sigterm(self):
        """python -m karpenter_tpu_torch --apiserver URL --device cpu over
        a fake apiserver: the MetricsProducers get their statuses over
        REST, and SIGTERM ends the process with 0."""
        import signal
        import subprocess
        import sys
        import time

        from karpenter_tpu_torch import workloads
        from tests.fake_apiserver import FakeApiServer

        server = FakeApiServer()
        server.start()
        proc = None
        try:
            workloads.build_kube_world([server], 200, 3, 0)
            repo = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            proc = subprocess.Popen(
                [sys.executable, "-m", "karpenter_tpu_torch", "--apiserver",
                 server.url, "--kube-insecure", "--device", "cpu",
                 "--metrics-port", "0", "--tick", "0.05"],
                cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True,
            )

            def statuses():
                return [d.get("status", {}).get("pendingCapacity")
                        for d in server.objects("metricsproducers")]

            deadline = time.time() + 120
            while time.time() < deadline and not all(statuses()):
                assert proc.poll() is None, proc.stderr.read()
                time.sleep(0.1)
            assert all(statuses())
            assert sum(s["pendingPods"] for s in statuses()) == 200
            lease = server.objects("leases")
            assert len(lease) == 1 and lease[0]["spec"]["holderIdentity"]
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            server.stop()

    def test_webhook_port_serves_while_main_runs(self):
        """main(--webhook-port P --device cpu) serves the admission
        webhooks while it ticks; the answers equal review_validate's and
        review_mutate's. (0 keeps the reference's meaning: no server.)"""
        import socket
        import threading
        import time

        from karpenter_tpu_torch import webhook

        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        result = {}
        thread = threading.Thread(target=lambda: result.setdefault(
            "rc", port_main.main([
                "--device", "cpu", "--duration", "4", "--tick", "0.05",
                "--metrics-port", "0", "--no-leader-elect",
                "--webhook-port", str(port),
            ])))
        thread.start()
        try:
            review = {"apiVersion": "admission.k8s.io/v1",
                      "kind": "AdmissionReview",
                      "request": {"uid": "u1", "object": {
                          "apiVersion": "autoscaling.karpenter.sh/v1alpha1",
                          "kind": "HorizontalAutoscaler",
                          "metadata": {"name": "h", "namespace": "default"},
                          "spec": {"scaleTargetRef": {
                              "apiVersion": "v1", "kind": "Deployment",
                              "name": "web"},
                              "minReplicas": 5, "maxReplicas": 1}}}}
            answers = {}
            deadline = time.time() + 30
            while time.time() < deadline and len(answers) < 2:
                for path in ("validate", "mutate"):
                    try:
                        request = urllib.request.Request(
                            f"http://127.0.0.1:{port}/{path}",
                            data=json.dumps(review).encode(),
                            headers={"Content-Type": "application/json"})
                        with urllib.request.urlopen(request,
                                                    timeout=5) as resp:
                            answers[path] = json.loads(resp.read())
                    except (urllib.error.URLError, ConnectionError):
                        time.sleep(0.05)
            assert answers["validate"] == webhook.review_validate(review)
            assert answers["validate"]["response"]["allowed"] is False
            assert answers["mutate"] == webhook.review_mutate(review)
        finally:
            thread.join(timeout=60)
        assert result == {"rc": 0}

    def test_webhook_port_0_serves_nothing(self):
        assert port_main._start_webhook_server(
            port_main.parse_args(["--webhook-port", "0"])) is None

    def test_no_card_exits_1_before_any_watch(self, capsys):
        """Without --device cpu and with no card, --apiserver exits 1 with
        the reason before any LIST or watch reaches the apiserver, and
        leaves no informer thread."""
        import threading

        if torch.cuda.is_available():
            pytest.skip("a card is present")

        from tests.fake_apiserver import FakeApiServer

        server = FakeApiServer()
        server.start()
        try:
            before = set(threading.enumerate())
            rc = port_main.main(["--apiserver", server.url, "--metrics-port",
                                 "0", "--duration", "5"])
            assert rc == 1
            assert "CUDA device requested" in capsys.readouterr().err
            assert server.list_pages_served == 0 and not server._watchers
            assert not [t for t in set(threading.enumerate()) - before
                        if t.is_alive() and "watch" in repr(t.name)]
            rc = port_main.main(["--simulate", "--apiserver", server.url])
            assert rc == 1
            assert server.list_pages_served == 0 and not server._watchers
        finally:
            server.stop()


class TestNotPortedOptions:
    @pytest.mark.parametrize("field,value,attr", [
        pytest.param("solver_shard_mesh", (2, 1), "shard_mesh_shape",
                     id="solver_shard_mesh-value3-parallel/mesh.py"),
        pytest.param("solver_shard_threshold", 12345, "shard_threshold",
                     id="solver_shard_threshold"),
        pytest.param("solver_shard_devices", 3, "shard_devices",
                     id="solver_shard_devices"),
    ])
    def test_shard_option_reaches_the_service(self, field, value, attr):
        """The three shard options (solver_shard_mesh used to raise
        NotPortedError; the other two were carried and reached no
        service) reach the runtime's SolverService as the reference's
        do."""
        rt = port_runtime.KarpenterRuntime(
            port_runtime.Options(device="cpu", **{field: value})
        )
        try:
            assert getattr(rt.solver_service, attr) == value
        finally:
            rt.close()

    def test_main_passes_shard_flags_to_the_service(self, monkeypatch):
        seen = {}
        real = port_runtime.KarpenterRuntime.__init__

        def spy(self, options=None, *args, **kwargs):
            seen.update(threshold=options.solver_shard_threshold,
                        devices=options.solver_shard_devices,
                        mesh=options.solver_shard_mesh)
            real(self, options, *args, **kwargs)

        monkeypatch.setattr(port_runtime.KarpenterRuntime, "__init__", spy)
        rc = port_main.main([
            "--device", "cpu", "--duration", "0.3", "--tick", "0.05",
            "--metrics-port", "0", "--no-leader-elect",
            "--shard-threshold", "99", "--shard-devices", "4",
            "--shard-mesh", "4x1",
        ])
        assert rc == 0
        assert seen == {"threshold": 99, "devices": 4, "mesh": (4, 1)}

    @pytest.mark.parametrize("field", ["tenant_config", "introspect"])
    def test_ported_option_builds_its_plane(self, field, tmp_path):
        """Options.tenant_config and Options.introspect used to raise
        NotPortedError; each now builds its plane as the reference's
        runtime does."""
        config = tmp_path / "tenants.json"
        config.write_text(json.dumps([{"id": "a"}, {"id": "b"}]))
        value = {"tenant_config": str(config), "introspect": True}[field]
        rt = port_runtime.KarpenterRuntime(port_runtime.Options(
            device="cpu", journal_dir=str(tmp_path / "j"), **{field: value}
        ))
        try:
            rt.manager.reconcile_all()
            if field == "tenant_config":
                assert rt.tenancy.tenants() == ["a", "b"]
                assert rt.tenant_scheduler.service is rt.solver_service
                assert rt.tenancy.journal_dir_for("a") == str(
                    tmp_path / "j" / "tenants" / "a"
                )
                assert rt.selfslo.tenant_source() == {"a": False, "b": False}
                assert rt.solver_introspection.memory_source() is None
            else:
                assert rt.tenancy is None
                assert rt.solver_introspection.enabled
                # the CPU reports no device memory: the source stays quiet
                assert rt.solver_introspection.memory_source() is None
                assert rt.solver_introspection.snapshot()["enabled"] is True
        finally:
            rt.close()

    def test_partitions_option_builds_the_plane(self, tmp_path):
        """Options.partitions used to raise NotPortedError; it now builds
        the replicated control plane as the reference's runtime does,
        with the tenant registry as its tenant source, the fifth
        self-SLO source, and every lease released on close."""
        config = tmp_path / "tenants.json"
        config.write_text(json.dumps([{"id": "a"}, {"id": "b"}]))
        clock = {"now": 1000.0}
        rt = port_runtime.KarpenterRuntime(port_runtime.Options(
            device="cpu", partitions=2, replica_id="r0",
            lease_duration_s=5.0, tenant_config=str(config),
            journal_dir=str(tmp_path / "j"),
        ), clock=lambda: clock["now"])
        try:
            plane = rt.replication
            assert (plane.replica_id, plane.partitions) == ("r0", 2)
            assert rt.selfslo.replica_source == plane.slo_source
            for _ in range(2):
                clock["now"] += 61.0
                rt.manager.reconcile_all()
            assert sorted(plane.handoffs) == ["a", "b"]
            assert plane.leases.owned == {0, 1}
        finally:
            rt.close()
        assert all(lease.holder == "" for lease in rt.store.list("Lease"))

    def test_solver_uri_fronts_the_sidecar(self):
        """Options.solver_uri builds the split: the service runs on the
        host and sends the bin-pack and the decide to the sidecar."""
        from karpenter_tpu_torch.sidecar import SolverServer

        server = SolverServer(port=0, host="127.0.0.1", device="cpu")
        port = server.start()
        rt = port_runtime.KarpenterRuntime(port_runtime.Options(
            device="cpu", solver_uri=f"127.0.0.1:{port}"))
        try:
            svc = rt.solver_service
            assert svc.device_solver == rt.solver_client.solve
            assert svc._decider == rt.solver_client.decide
            assert svc.device.type == "cpu"
        finally:
            rt.close()
            server.stop()
        assert rt.solver_client is None

    def test_sim_seed_is_carried(self):
        rt = port_runtime.KarpenterRuntime(
            port_runtime.Options(device="cpu", sim_seed=7))
        try:
            assert rt.options.sim_seed == 7
        finally:
            rt.close()


class TestSimulateFlags:
    """The flags that used to exit 2 (simlab/ and simulate.py are ported):
    they parse as the reference's and run."""

    @pytest.mark.parametrize("argv", [
        ["--simulate"], ["--simulate", "--list"],
        ["--simulate", "--constraints", "--sim-seed", "8"],
        ["--simulate", "--what-if", "w.json", "--consolidate"],
    ], ids=["simulate", "list", "sim_seed", "what_if"])
    def test_parse_as_the_reference(self, argv):
        want = vars(mod(REF, "__main__").parse_args(argv))
        got = vars(port_main.parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want

    def test_simulate_runs_on_the_cpu(self, tmp_path, capsys):
        rc = port_main.main(["--simulate", "--device", "cpu", "--data-dir",
                             str(tmp_path / "d"), "--no-leader-elect"])
        assert rc == 0
        report = json.loads(capsys.readouterr().out)
        assert report == {"groups": {}, "rows": [], "unschedulable_pods": 0}

    def test_list_prints_the_catalog(self, capsys):
        assert port_main.main(["--simulate", "--list"]) == 0
        out = capsys.readouterr().out
        assert out.startswith("Registered simulation scenarios")
        assert "--sim-seed" in out


# -- main ----------------------------------------------------------------------


class TestMain:
    def test_cpu_run_ticks_and_returns_0(self, tmp_path, monkeypatch, capsys):
        ticks = []
        real = Manager.reconcile_all

        def counted(self):
            ticks.append(1)
            return real(self)

        monkeypatch.setattr(Manager, "reconcile_all", counted)
        rc = port_main.main([
            "--device", "cpu", "--duration", "0.3", "--tick", "0.05",
            "--metrics-port", "0", "--data-dir", str(tmp_path / "d"),
            "--journal-dir", str(tmp_path / "j"),
        ])
        assert rc == 0
        assert ticks
        err = capsys.readouterr().err
        assert "serving /metrics and /healthz on :" in err
        assert (tmp_path / "d" / "wal.jsonl").exists()

    def test_production_profile_on_cpu(self, capsys):
        rc = port_main.main([
            "--device", "cpu", "--profile", "production", "--poolgroups",
            "--duration", "0.3", "--tick", "0.05", "--metrics-port", "0",
            "--no-leader-elect",
        ])
        assert rc == 0

    @pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
    def test_no_card_no_cpu_no_tick(self, monkeypatch, capsys):
        ticks = []
        monkeypatch.setattr(
            Manager, "reconcile_all", lambda self: ticks.append(1)
        )
        rc = port_main.main([
            "--duration", "5", "--tick", "0.05", "--metrics-port", "0",
        ])
        assert rc != 0
        assert not ticks
        err = capsys.readouterr().err
        assert "CUDA device requested" in err
        assert "serving /metrics" not in err

    def test_runtime_default_device_needs_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            port_runtime.KarpenterRuntime(port_runtime.Options())

    def test_failed_prewarm_raises_at_boot(self, monkeypatch):
        from karpenter_tpu_torch.solver.service import SolverService

        def broken(self, family):
            raise RuntimeError(f"warm {family} failed")

        monkeypatch.setattr(SolverService, "_prewarm_dispatch", broken)
        with pytest.raises(RuntimeError, match="pre-warm failed at boot"):
            port_runtime.KarpenterRuntime(port_runtime.Options(
                device="cpu", prewarm_compile=True
            ))

    def test_compile_cache_dir_names_the_kernel_build_dir(self, tmp_path,
                                                          monkeypatch):
        from karpenter_tpu_torch import kernels
        from karpenter_tpu_torch.utils import backend

        monkeypatch.setattr(kernels, "BUILD", kernels.BUILD)
        assert backend.configure_compile_cache(str(tmp_path / "cache"))
        assert kernels.BUILD == (tmp_path / "cache").resolve()
        assert (tmp_path / "cache").is_dir()
        assert not backend.configure_compile_cache("")


# -- the HTTP surface ----------------------------------------------------------


def get(port, path):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10
        ) as response:
            return response.status, response.read()
    except urllib.error.HTTPError as error:
        return error.code, error.read()


class TestMetricsServer:
    @pytest.mark.parametrize("package", [REF, PORT])
    def test_routes(self, package, tmp_path):
        registry = mod(package, "metrics.registry").GaugeRegistry()
        registry.register("queue", "length").set(
            name="q", namespace="default", value=41.0
        )
        ready = {"ok": False}
        server = mod(package, "observability").MetricsServer(
            registry, port=0, host="127.0.0.1",
            readiness=lambda: (ready["ok"], "ok" if ready["ok"]
                               else "recovery warm-up: 1 tick(s) remaining"),
        )
        port = server.start()
        try:
            status, body = get(port, "/metrics?format=prometheus")
            assert status == 200
            assert b'karpenter_queue_length{name="q",namespace="default"} 41' in body
            assert get(port, "/healthz") == (200, b"ok")
            status, body = get(port, "/readyz")
            assert status == 503 and b"recovery warm-up" in body
            ready["ok"] = True
            assert get(port, "/readyz") == (200, b"ok")
            for path in ("/debug/traces?limit=5", "/debug/flightrecorder",
                         "/debug/decisions"):
                status, body = get(port, path)
                assert status == 200, path
                json.loads(body)
            for path in ("/debug/selfslo", "/debug/solver",
                         "/debug/replicas"):
                assert get(port, path) == (200, b'{"enabled": false}'), path
            status, body = get(port, "/debug/profile?ms=5")
            assert status == 503 and b"no --journal-dir" in body
            assert get(port, "/nope")[0] == 404
        finally:
            server.stop()

    def test_profile_capture_writes_a_chrome_trace(self, tmp_path):
        from karpenter_tpu_torch.metrics.registry import GaugeRegistry
        from karpenter_tpu_torch.observability import MetricsServer

        server = MetricsServer(GaugeRegistry(), port=0, host="127.0.0.1",
                               profile_dir=str(tmp_path))
        port = server.start()
        try:
            assert get(port, "/debug/profile?ms=x")[0] == 400
            status, body = get(port, "/debug/profile?ms=20")
            assert status == 200, body
            report = json.loads(body)
            assert report["ms_requested"] == 20
            assert os.path.exists(os.path.join(report["path"], "trace.json"))
            with open(os.path.join(report["path"], "manifest.json")) as fh:
                assert json.load(fh)["ms_requested"] == 20
        finally:
            server.stop()

    def test_selfslo_scoreboard_from_a_runtime(self):
        runtime = port_runtime.KarpenterRuntime(
            port_runtime.Options(device="cpu"), clock=FakeClock()
        )
        from karpenter_tpu_torch.observability import MetricsServer

        server = MetricsServer(runtime.registry, port=0, host="127.0.0.1",
                               selfslo=runtime.selfslo,
                               readiness=port_main._readiness(runtime))
        port = server.start()
        try:
            runtime.manager.reconcile_all()
            status, body = get(port, "/debug/selfslo")
            board = json.loads(body)
            assert status == 200 and board["enabled"] is True
            assert get(port, "/readyz") == (200, b"ok")
        finally:
            server.stop()
            runtime.close()


# -- leader election -----------------------------------------------------------


@pytest.mark.parametrize("package", [REF, PORT])
class TestLeaderElection:
    def elector(self, package, store, clock, identity, **kw):
        return mod(package, "leaderelection").LeaderElector(
            store, identity=identity, clock=clock, **kw
        )

    def test_second_candidate_blocked_until_expiry(self, package):
        store, clock = mod(package, "store").Store(), FakeClock()
        a = self.elector(package, store, clock, "a", lease_duration=15)
        b = self.elector(package, store, clock, "b", lease_duration=15)
        assert a.try_acquire() and a.is_leader()
        assert not b.try_acquire() and not b.is_leader()
        clock.advance(10)
        assert a.try_acquire()
        clock.advance(10)
        assert not b.try_acquire()
        clock.advance(16)
        assert b.try_acquire() and b.is_leader()
        assert not a.is_leader() and not a.try_acquire()

    def test_renew_is_throttled_while_fresh(self, package):
        store, clock = mod(package, "store").Store(), FakeClock()
        a = self.elector(package, store, clock, "a", lease_duration=15)
        assert a.try_acquire()
        rv = store.get("Lease", a.namespace, a.name).metadata.resource_version
        clock.advance(1)
        assert a.try_acquire()
        assert store.get(
            "Lease", a.namespace, a.name
        ).metadata.resource_version == rv
        clock.advance(5)
        assert a.try_acquire()
        assert store.get(
            "Lease", a.namespace, a.name
        ).metadata.resource_version != rv

    def test_lease_survives_the_durable_store(self, package, tmp_path):
        persistence = mod(package, "store.persistence")
        clock = FakeClock()
        store = persistence.open_store(str(tmp_path))
        a = self.elector(package, store, clock, "a", lease_duration=15)
        assert a.try_acquire()
        store.close()
        store = persistence.open_store(str(tmp_path))
        try:
            b = self.elector(package, store, clock, "b", lease_duration=15)
            assert not b.try_acquire()
            clock.advance(16)
            assert b.try_acquire()
        finally:
            store.close()
