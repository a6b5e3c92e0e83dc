"""The port's solver sidecar (karpenter_tpu_torch.sidecar) against the
reference's (karpenter_tpu.sidecar), on the CPU.

  * the reference's tests/test_sidecar.py cases on the port (codec
    roundtrips, Health / Solve / Decide over loopback gRPC, an error as
    INTERNAL, the producer path and the decide split through the
    sidecar), its server on the torch CPU rung;
  * the sidecar cases of tests/test_faults.py (one jittered retry, a
    deadline on every call);
  * the codec's bytes equal the reference's for the same seeded
    BinPackInputs, DecisionInputs and their outputs, and either
    package's client talks to either package's server with equal
    answers (integers exact, lp_bound bitwise);
  * both servers refuse a 100k x 300 x 64 x 64 request (past gRPC's
    default 4 MiB receive limit) with the same status code;
  * the flags: `--multihost` with no topology serves single-host; the
    sidecar without a card exits 1 before it binds unless `--device
    cpu`; the controller's Health
    gate and failure rule under both `--device` values;
  * the shipped Deployment's world (workloads.build_deployment_world:
    TPU pools behind a fake GKE cluster manager, one scaled from zero)
    through a runtime with solver_uri equals an in-process CPU runtime's
    and the reference's runtime behind its own sidecar, tick by tick.

The reference runs as its own tests run it (JAX on the CPU).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops import decision as TD
from karpenter_tpu_torch.sidecar import SolverClient, SolverServer, codec
from karpenter_tpu_torch.sidecar import client as client_mod
from karpenter_tpu_torch.sidecar import server as server_mod

grpc = pytest.importorskip("grpc")

REF, PORT = "karpenter_tpu", "karpenter_tpu_torch"
PACKAGES = (REF, PORT)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mod(package: str, name: str):
    return importlib.import_module(f"{package}.{name}")


def binpack_fields(seed, pods=300, types_=12, taints=8, labels=8):
    return workloads.build_inputs(pods, types_, taints, labels, seed=seed)


def decision_fields(seed, n=24, m=3, forecast=False):
    return workloads.build_decision_inputs(seed, n, m, forecast=forecast)


def as_dataclass(cls, fields):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in fields.items() if k in names})


def leaves(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def assert_equal_leaves(got, want, what=""):
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys(), what
    for name, value in want.items():
        assert got[name].dtype == value.dtype, (what, name)
        assert got[name].shape == value.shape, (what, name)
        np.testing.assert_array_equal(got[name], value, err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def server():
    s = SolverServer(port=0, host="127.0.0.1", device="cpu")
    port = s.start()
    yield f"127.0.0.1:{port}", s
    s.stop()


@pytest.fixture(scope="module")
def client(server):
    with SolverClient(server[0]) as c:
        yield c


@pytest.fixture(scope="module")
def ref_server():
    s = mod(REF, "sidecar").SolverServer(port=0, host="127.0.0.1")
    port = s.start()
    yield f"127.0.0.1:{port}"
    s.stop()


class _CardHealth:
    """The port server's Health answering `backend: "cuda"`: a stand-in
    for a sidecar on the card, so the controller's card rule can be
    driven on the CPU (its Solves still run on the CPU service)."""

    def __init__(self, monkeypatch):
        monkeypatch.setattr(server_mod, "_health", lambda request, device=None:
                            codec.pack({"ok": np.asarray(True)},
                                       meta={"backend": "cuda",
                                             "device_count": 1}))


# -- the reference's tests/test_sidecar.py on the port ------------------------


class TestCodec:
    def test_roundtrip_arrays(self):
        arrays = {
            "a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": np.asarray([True, False, True]),
            "scalar": np.asarray(7, np.int32),
        }
        packed = codec.pack(arrays, meta={"k": "v"})
        out, meta = codec.unpack(packed)
        assert meta == {"k": "v"}
        for name, arr in arrays.items():
            np.testing.assert_array_equal(out[name], arr)
            assert out[name].dtype == arr.dtype
            assert out[name].shape == arr.shape  # 0-d stays 0-d

    def test_roundtrip_dataclass(self):
        inputs = as_dataclass(TB.BinPackInputs, binpack_fields(1, pods=7,
                                                               types_=3))
        back, _ = codec.unpack_dataclass(
            TB.BinPackInputs, codec.pack_dataclass(inputs)
        )
        assert_equal_leaves(back, inputs)

    def test_tensor_set_mismatch_rejected(self):
        packed = codec.pack({"bogus": np.zeros(3)})
        with pytest.raises(ValueError):
            codec.unpack_dataclass(TB.BinPackInputs, packed)

    def test_torch_tensors_pack_as_their_arrays(self):
        """A dataclass of CPU tensors packs to the bytes of the same
        dataclass holding numpy arrays."""
        fields = binpack_fields(2, pods=20, types_=4)
        tensors = TB.inputs_from_numpy(fields, "cpu")
        arrays = as_dataclass(TB.BinPackInputs, fields)
        assert codec.pack_dataclass(tensors) == codec.pack_dataclass(arrays)


class TestSolverRPC:
    def test_health(self, client):
        ok, meta = client.health()
        assert ok
        assert meta == {"backend": "cpu", "device_count": 0}

    def test_solve_matches_inprocess(self, client):
        inputs = as_dataclass(TB.BinPackInputs, binpack_fields(3))
        local = TB.solve(inputs, buckets=16, backend="torch", device="cpu")
        remote = client.solve(inputs, buckets=16)
        for name in ("assigned", "nodes_needed", "lp_bound",
                     "assigned_count", "unschedulable"):
            np.testing.assert_array_equal(
                np.asarray(getattr(remote, name)),
                getattr(local, name).numpy(), err_msg=name)

    def test_decide_matches_inprocess(self, client):
        fields = decision_fields(4)
        local = TD.decide(TD.DecisionInputs.from_numpy(fields, "cpu"))
        remote = client.decide(as_dataclass(TD.DecisionInputs, fields))
        assert_equal_leaves(remote, TD.DecisionOutputs.from_arrays(local))

    def test_error_surfaces_as_status(self, server):
        # a malformed request must produce INTERNAL with a message, not a
        # hung/dead channel
        with SolverClient(server[0]) as c:
            with pytest.raises(grpc.RpcError) as e:
                c._solve(b"\x00" * 4, timeout=5.0)
            assert e.value.code() == grpc.StatusCode.INTERNAL

    def test_server_counts_rpcs_and_request_bytes(self):
        s = SolverServer(port=0, host="127.0.0.1", device="cpu")
        port = s.start()
        try:
            inputs = as_dataclass(TB.BinPackInputs, binpack_fields(5))
            request = codec.pack_dataclass(
                inputs, meta={"buckets": 32, "backend": "auto"})
            with SolverClient(f"127.0.0.1:{port}") as c:
                c.solve(inputs)
                c.health()
            assert s.reset_rpcs() == {
                "Solve": (1, len(request)), "Decide": (0, 0),
                "Health": (1, len(codec.pack({})))}
            assert s.reset_rpcs()["Solve"] == (0, 0)
        finally:
            s.stop()

    def test_tenant_metadata_is_counted_and_capped(self):
        from karpenter_tpu_torch.metrics.registry import GaugeRegistry

        registry = GaugeRegistry()
        s = SolverServer(port=0, host="127.0.0.1", device="cpu",
                         registry=registry)
        s.MAX_TENANT_SERIES = 2
        port = s.start()
        try:
            for tenant in ("a", "b", "c", "a"):
                with SolverClient(f"127.0.0.1:{port}", tenant=tenant) as c:
                    c.health()
            text = registry.expose_text()
            assert 'karpenter_tenant_rpcs_total{name="a",namespace="-"} 2' in text
            assert 'name="_overflow"' in text and 'name="c"' not in text
        finally:
            s.stop()


class TestProducerThroughSidecar:
    def test_pending_capacity_via_remote_solver(self, client):
        """The full producer path with the sidecar at the Algorithm seam."""
        from karpenter_tpu_torch.api.core import (
            Node,
            NodeCondition,
            NodeSpec,
            NodeStatus,
            ObjectMeta,
            Pod,
            PodSpec,
            resource_list,
        )
        from karpenter_tpu_torch.api.metricsproducer import (
            MetricsProducer,
            MetricsProducerSpec,
            PendingCapacitySpec,
        )
        from karpenter_tpu_torch.metrics.producers.pendingcapacity import (
            solve_pending,
        )
        from karpenter_tpu_torch.metrics.registry import GaugeRegistry
        from karpenter_tpu_torch.store import Store

        store = Store()
        store.create(Node(
            metadata=ObjectMeta(name="n1", labels={"pool": "a"}),
            spec=NodeSpec(),
            status=NodeStatus(
                allocatable=resource_list(cpu="8", memory="16Gi", pods="16"),
                conditions=[NodeCondition("Ready", "True")],
            ),
        ))
        store.create(Pod(metadata=ObjectMeta(name="p1"), spec=PodSpec()))
        mp = store.create(MetricsProducer(
            metadata=ObjectMeta(name="pending"),
            spec=MetricsProducerSpec(pending_capacity=PendingCapacitySpec(
                node_selector={"pool": "a"})),
        ))
        solve_pending(store, [mp], GaugeRegistry(), solver=client.solve)
        status = mp.status.pending_capacity
        assert status is not None
        assert status.pending_pods == 1
        assert status.additional_nodes_needed >= 1


def _decide_world(package, runtime):
    """tests/test_sidecar.py's decide-split HA (85% / 60% / 5 -> 8) in
    `runtime`'s store."""
    core = mod(package, "api.core")
    ha = mod(package, "api.horizontalautoscaler")
    sng = mod(package, "api.scalablenodegroup")
    gauge = runtime.registry.register("reserved_capacity", "cpu_utilization")
    gauge.set("g", "default", 0.85)
    runtime.store.create(sng.ScalableNodeGroup(
        metadata=core.ObjectMeta(name="g"),
        spec=sng.ScalableNodeGroupSpec(replicas=5, type="FakeNodeGroup",
                                       id="g")))
    runtime.store.create(ha.HorizontalAutoscaler(
        metadata=core.ObjectMeta(name="ha"),
        spec=ha.HorizontalAutoscalerSpec(
            scale_target_ref=ha.CrossVersionObjectReference(
                kind="ScalableNodeGroup", name="g"),
            min_replicas=3, max_replicas=23,
            metrics=[ha.Metric(prometheus=ha.PrometheusMetricSource(
                query='karpenter_reserved_capacity_cpu_utilization{name="g"}',
                target=ha.MetricTarget(type="Utilization", value=60)))])))


def _runtime(uri, device, provider=None, **options):
    from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options

    if provider is None:
        provider = FakeFactory()
        provider.node_replicas["g"] = 5
    return KarpenterRuntime(
        Options(cloud_provider="fake", solver_uri=uri, device=device,
                **options),
        cloud_provider_factory=provider,
    )


class TestDecideSplit:
    def test_control_plane_decides_through_sidecar(self, server):
        """With solver_uri the decision program rides the gRPC split too:
        the full HA pipeline (metric read -> remote decide -> scale write)
        gives the canonical 85%/60%/5 -> 8 with the math in the sidecar."""
        uri, s = server
        rt = _runtime(uri, "cpu")
        try:
            assert rt.batch_autoscaler.decider == rt.solver_service.decide
            assert rt.solver_service._decider == rt.solver_client.decide
            assert rt.solver_service.device_solver == rt.solver_client.solve
            assert rt.solver_service.device.type == "cpu"
            s.reset_rpcs()
            _decide_world(PORT, rt)
            rt.manager.reconcile_all()
            ha = rt.store.get("HorizontalAutoscaler", "default", "ha")
            assert ha.status.desired_replicas == 8
            assert s.reset_rpcs()["Decide"][0] == 1
        finally:
            rt.close()  # release the gRPC channel before the server stops


# -- the sidecar cases of tests/test_faults.py ---------------------------------


class TestSidecarFaults:
    def test_sidecar_rpc_retries_once_with_jitter(self):
        from karpenter_tpu_torch.faults import FaultInjected, FaultRegistry

        client = SolverClient("127.0.0.1:1", retry_jitter_s=0.01)
        calls = []

        def fake_rpc(request, timeout=None):
            calls.append(timeout)
            return b"ok"

        with FaultRegistry(seed=1) as reg:
            reg.plan("sidecar.rpc", mode="flaky", times=1)
            assert client._call(fake_rpc, b"") == b"ok"
        # first attempt consumed by the injected fault, second landed
        assert calls == [client.timeout]
        # a SECOND consecutive transport failure surfaces to the caller
        with FaultRegistry(seed=1) as reg:
            reg.plan("sidecar.rpc", mode="flaky", times=2)
            with pytest.raises(FaultInjected):
                client._call(fake_rpc, b"")
        client.close()

    def test_sidecar_rpc_always_has_deadline(self):
        client = SolverClient("127.0.0.1:1", timeout_seconds=0)
        seen = {}

        def fake_rpc(request, timeout=None):
            seen["timeout"] = timeout
            return b"ok"

        client._call(fake_rpc, b"")
        assert seen["timeout"] and seen["timeout"] > 0
        client.close()

    @pytest.mark.parametrize("package", PACKAGES)
    def test_retry_schedule_matches_the_reference(self, package):
        """The same fault plan gives the same attempts, sleeps and
        outcome in both packages' clients."""
        faults = mod(package, "faults")
        client = mod(package, "sidecar.client").SolverClient(
            "127.0.0.1:1", retry_jitter_s=0.01, seed=3)
        seen = []

        def fake_rpc(request, timeout=None):
            seen.append(timeout)
            return b"ok"

        try:
            with faults.FaultRegistry(seed=1) as reg:
                reg.plan("sidecar.rpc", mode="flaky", times=1)
                assert client._call(fake_rpc, b"") == b"ok"
            assert seen == [30.0]
            assert client._rng.random() == pytest.approx(
                _second_draw(3))
        finally:
            client.close()


def _second_draw(seed):
    import random

    rng = random.Random(seed)
    rng.uniform(0.0, 0.01)
    return rng.random()


# -- cross-package: bytes, clients and servers ---------------------------------


SEEDS = (0, 1, 2)


class TestCrossPackage:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_codec_bytes_equal_the_reference(self, seed):
        ref_codec = mod(REF, "sidecar.codec")
        ref_b = mod(REF, "ops.binpack")
        ref_d = mod(REF, "ops.decision")
        ref_nb = mod(REF, "ops.numpy_binpack")
        fields = binpack_fields(seed)
        meta = {"buckets": 32, "backend": "auto"}
        port_in = as_dataclass(TB.BinPackInputs, fields)
        ref_in = as_dataclass(ref_b.BinPackInputs, fields)
        assert codec.pack_dataclass(port_in, meta) == ref_codec.pack_dataclass(
            ref_in, meta)
        port_out = TB.solve(port_in, buckets=32, backend="numpy")
        ref_out = ref_nb.binpack_numpy(ref_in, buckets=32)
        assert codec.pack_dataclass(port_out) == ref_codec.pack_dataclass(
            ref_out)
        dfields = decision_fields(seed, forecast=bool(seed % 2))
        port_d = as_dataclass(TD.DecisionInputs, dfields)
        ref_dd = as_dataclass(ref_d.DecisionInputs, dfields)
        assert codec.pack_dataclass(port_d) == ref_codec.pack_dataclass(ref_dd)
        port_dout = TD.DecisionOutputs.from_arrays(
            TD.decide(TD.DecisionInputs.from_numpy(dfields, "cpu")))
        ref_dout = ref_d.decide_jit(ref_dd)
        ref_dout = ref_d.DecisionOutputs(**{
            f.name: np.asarray(getattr(ref_dout, f.name))
            for f in dataclasses.fields(ref_dout)})
        assert codec.pack_dataclass(port_dout) == ref_codec.pack_dataclass(
            ref_dout)
        # and the wire decodes into either package's dataclass
        back, got_meta = ref_codec.unpack_dataclass(
            ref_b.BinPackInputs, codec.pack_dataclass(port_in, meta))
        assert got_meta == meta
        assert_equal_leaves(back, ref_in)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_port_client_and_reference_server(self, seed, ref_server, server):
        """The port's client gets the same answers from the reference's
        server (JAX on the CPU) as from the port's."""
        inputs = as_dataclass(TB.BinPackInputs, binpack_fields(seed))
        dinputs = as_dataclass(TD.DecisionInputs, decision_fields(seed))
        with SolverClient(ref_server) as ref_side, \
                SolverClient(server[0]) as port_side:
            assert_equal_leaves(ref_side.solve(inputs),
                                port_side.solve(inputs), "solve")
            assert_equal_leaves(ref_side.decide(dinputs),
                                port_side.decide(dinputs), "decide")
            ok, meta = ref_side.health()
            assert ok and meta["backend"] == "cpu"

    @pytest.mark.parametrize("seed", SEEDS)
    def test_reference_client_and_port_server(self, seed, ref_server,
                                              server):
        """The reference's client gets the same answers from the port's
        server as from its own."""
        ref_client = mod(REF, "sidecar.client").SolverClient
        ref_b = mod(REF, "ops.binpack")
        ref_d = mod(REF, "ops.decision")
        inputs = as_dataclass(ref_b.BinPackInputs, binpack_fields(seed))
        dinputs = as_dataclass(ref_d.DecisionInputs, decision_fields(seed))
        with ref_client(server[0]) as port_side, \
                ref_client(ref_server) as ref_side:
            assert_equal_leaves(port_side.solve(inputs),
                                ref_side.solve(inputs), "solve")
            assert_equal_leaves(port_side.decide(dinputs),
                                ref_side.decide(dinputs), "decide")

    def test_both_servers_refuse_a_request_past_4_mib(self, ref_server,
                                                      server):
        """The bench's 100k x 300 x 64 x 64 problem is ~14 MB on the
        wire: both servers keep gRPC's default 4 MiB receive limit and
        refuse it with the same status code, before any handler runs."""
        fields = workloads.build_inputs(100_000, 300, 64, 64, seed=0)
        request = codec.pack_dataclass(
            as_dataclass(TB.BinPackInputs, fields),
            meta={"buckets": 32, "backend": "auto"})
        assert len(request) > 4 * 1024 * 1024
        codes = []
        for target in (ref_server, server[0]):
            with SolverClient(target, retries=0) as c:
                with pytest.raises(grpc.RpcError) as e:
                    c._call(c._solve, request)
                codes.append(e.value.code())
        assert codes == [grpc.StatusCode.RESOURCE_EXHAUSTED] * 2


# -- flags and the device rule ---------------------------------------------------


def _no_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


class TestSidecarFlags:
    def test_multihost_without_topology_serves_single_host(
        self, monkeypatch, capsys
    ):
        """--multihost (parallel/multihost.py, which used to exit 2) with
        no topology configured serves single-host: the join returns
        False before the device check, the server binds, and Health
        counts the process's own devices."""
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        served = []
        monkeypatch.setattr(server_mod, "_serve_until_signalled",
                            lambda server: served.append(server))
        assert server_mod.parse_args(["--multihost"]).multihost
        try:
            assert server_mod.main(["--multihost", "--device", "cpu",
                                    "--port", "0", "--host",
                                    "127.0.0.1"]) == 0
            assert "serving single-host" in capsys.readouterr().err
            (server,) = served
            _, meta = codec.unpack(server_mod._health(b"", "cpu"))
            assert meta["backend"] == "cpu"
            assert meta["device_count"] == __import__("torch").cuda.device_count()
        finally:
            for server in served:
                server.stop()

    @pytest.mark.parametrize("argv", [
        [], ["--port", "9090", "--host", "0.0.0.0"],
        ["--warmup-pods", "64", "--compile-cache-dir", "c"],
    ])
    def test_shared_flags_parse_as_the_reference(self, argv, monkeypatch):
        """Every flag the reference's sidecar has parses to the same
        value (the reference's main parses inside; its parser is read
        through a patched parse_args)."""
        import argparse

        seen = {}
        real = argparse.ArgumentParser.parse_args

        def capture(self, args=None, namespace=None):
            seen["args"] = real(self, args, namespace)
            raise SystemExit(0)

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            mod(REF, "sidecar.server").main(argv)
        monkeypatch.undo()
        want = vars(seen["args"])
        got = vars(server_mod.parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want

    def test_without_a_card_exits_1_before_binding(self, monkeypatch,
                                                   capsys):
        _no_card(monkeypatch)
        started = []
        monkeypatch.setattr(SolverServer, "start",
                            lambda self: started.append(self) or 0)
        assert server_mod.main(["--port", "0"]) == 1
        err = capsys.readouterr().err
        assert "cannot start" in err and "CUDA device requested" in err
        assert not started

    def test_device_cpu_serves_until_sigterm(self):
        """`python -m karpenter_tpu_torch.sidecar --device cpu` serves
        Health and Solve, and SIGTERM ends it with 0."""
        proc = subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch.sidecar",
             "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
             "--warmup-pods", "16"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        )
        try:
            line = proc.stdout.readline()
            serving = json.loads(line)["serving"]
            port = serving.rsplit(":", 1)[1]
            with SolverClient(f"127.0.0.1:{port}") as c:
                assert c.health() == (True, {"backend": "cpu",
                                             "device_count": 0})
                inputs = as_dataclass(TB.BinPackInputs, binpack_fields(6))
                want = TB.solve(inputs, buckets=32, backend="numpy")
                assert_equal_leaves(c.solve(inputs), want)
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
            assert "sidecar device: cpu" in proc.stderr.read()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


class TestControllerDeviceRule:
    """The controller under --solver-uri: Health before anything else,
    and the failure rule of the device it asked for."""

    def test_cuda_controller_refuses_a_cpu_sidecar(self, server, capsys):
        from karpenter_tpu_torch import __main__ as port_main

        rc = port_main.main(["--solver-uri", server[0], "--metrics-port",
                             "0", "--duration", "1", "--no-leader-elect"])
        assert rc == 1
        err = capsys.readouterr().err
        assert "computes on 'cpu'" in err and "--device cpu" in err
        from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
        from karpenter_tpu_torch.sidecar.client import SidecarDeviceError

        with pytest.raises(SidecarDeviceError, match="computes on 'cpu'"):
            KarpenterRuntime(Options(solver_uri=server[0]))

    def test_cpu_controller_accepts_a_cpu_sidecar(self, server, capsys):
        from karpenter_tpu_torch import __main__ as port_main

        uri, s = server
        s.reset_rpcs()
        rc = port_main.main(["--solver-uri", uri, "--device", "cpu",
                             "--cloud-provider", "fake", "--metrics-port",
                             "0", "--duration", "0.5", "--tick", "0.1",
                             "--no-leader-elect"])
        assert rc == 0
        assert "solver device: solver sidecar at" in capsys.readouterr().err
        # one gate: the binary's, whose client the runtime reuses
        assert s.reset_rpcs()["Health"][0] == 1

    def test_cuda_controller_needs_no_card_beside_a_card_sidecar(
            self, server, monkeypatch, capsys):
        """Under --solver-uri the controller builds no kernel: with the
        card hidden it boots and ticks against a sidecar on the card."""
        _CardHealth(monkeypatch)
        _no_card(monkeypatch)
        built = []
        from karpenter_tpu_torch.utils import backend

        monkeypatch.setattr(backend, "ensure_usable_backend",
                            lambda device=None: built.append(device))
        from karpenter_tpu_torch import __main__ as port_main

        rc = port_main.main(["--solver-uri", server[0], "--cloud-provider",
                             "fake", "--metrics-port", "0", "--duration",
                             "0.3", "--tick", "0.1", "--no-leader-elect"])
        assert rc == 0 and not built
        assert "backend cuda" in capsys.readouterr().err

    @pytest.mark.parametrize("device", ["cuda", "cpu"])
    def test_unanswered_health(self, device, caplog):
        """A sidecar that does not answer: the card's rule refuses to
        boot; the CPU boots and logs it (the numpy ladder answers)."""
        from karpenter_tpu_torch.runtime import KarpenterRuntime, Options

        options = Options(solver_uri="127.0.0.1:1", device=device)
        if device == "cuda":
            with pytest.raises(grpc.RpcError):
                KarpenterRuntime(options)
            return
        rt = KarpenterRuntime(options)
        try:
            assert rt.solver_service._numpy_ladder
        finally:
            rt.close()

    @pytest.mark.parametrize("device", ["cuda", "cpu"])
    def test_failed_rpc(self, device, monkeypatch):
        """A Solve and a Decide that still fail after the client's retry:
        SolverDeviceError under the card's rule (no numpy answer), the
        numpy ladder's answer on the CPU."""
        from karpenter_tpu_torch.faults import FaultRegistry
        from karpenter_tpu_torch.solver import SolverDeviceError

        _CardHealth(monkeypatch)
        s = SolverServer(port=0, host="127.0.0.1", device="cpu")
        port = s.start()
        rt = _runtime(f"127.0.0.1:{port}", device)
        try:
            svc = rt.solver_service
            assert svc.device.type == "cpu"
            assert svc._numpy_ladder == (device == "cpu")
            assert svc.on_timeout == ("fallback" if device == "cpu"
                                      else "raise")
            inputs = as_dataclass(TB.BinPackInputs, binpack_fields(7))
            want = TB.solve(inputs, buckets=32, backend="numpy")
            assert_equal_leaves(svc.solve(inputs), want)
            dinputs = as_dataclass(TD.DecisionInputs, decision_fields(7))
            with FaultRegistry(seed=1) as reg:
                reg.plan("sidecar.rpc", mode="flaky", times=4)
                if device == "cuda":
                    with pytest.raises(SolverDeviceError, match="sidecar"):
                        svc.solve(inputs)
                    with pytest.raises(SolverDeviceError, match="sidecar"):
                        svc.decide(dinputs)
                    assert svc.stats.fallbacks == 0
                else:
                    assert_equal_leaves(svc.solve(inputs), want)
                    assert svc.stats.fallbacks == 1
                    with pytest.raises(Exception, match="injected"):
                        svc.decide(dinputs)
        finally:
            rt.close()
            s.stop()

    def test_expired_deadline_is_a_solver_timeout(self):
        from karpenter_tpu_torch.solver import SolverTimeout

        class Expired(grpc.RpcError):
            def code(self):
                return grpc.StatusCode.DEADLINE_EXCEEDED

        class Broken:
            target = "x"

            def solve(self, *args, **kwargs):
                raise Expired()

            def decide(self, inputs):
                raise RuntimeError("gone")

        solve, decide = client_mod.card_seams(Broken())
        with pytest.raises(SolverTimeout):
            solve(None)
        with pytest.raises(Exception, match="sidecar RPC failed"):
            decide(None)


# -- the shipped Deployment's world ----------------------------------------------


def deployment_api(package):
    return workloads.deployment_api_namespace({
        key: mod(package, key) for key in workloads.DEPLOYMENT_API
    })


class DeploymentRun:
    """One package's runtime over the Deployment world: with `uri` behind
    a solver sidecar, else in process on the CPU."""

    def __init__(self, package, uri, seed=0, pods=600, types_=12):
        rt = mod(package, "runtime")
        self.package = package
        self.api = deployment_api(package)
        self.store = mod(package, "store").Store()
        self.manager = workloads.FakeClusterManager()
        self.cluster = workloads.build_deployment_world(
            self.store, pods, types_, seed, tpu_pods=2, api=self.api)
        self.now = [1000.0]
        options = dict(solver_uri=uri)
        if package == PORT:
            options["device"] = "cpu"
        self.runtime = rt.KarpenterRuntime(
            rt.Options(**options), store=self.store,
            cloud_provider_factory=workloads.tpu_factory(
                self.api, self.manager, self.store),
            clock=lambda: self.now[0],
        )

    def tick(self, churn):
        if churn:
            self.now[0] += 5.0
            workloads.churn_reconcile(self.cluster, churn)()
        self.runtime.manager.reconcile_all()
        return self.snapshot()

    def snapshot(self):
        snap = workloads.runtime_snapshot(
            self.store, self.runtime.registry,
            types.SimpleNamespace(node_replicas={}),
            mod(self.package, "api.serialization").to_dict,
            skip=workloads.RUNG_SKIP, pods="fields")
        snap["resizes"] = self.manager.take_resizes()
        return snap


class TestDeploymentWorld:
    def test_split_runtime_equals_inprocess_and_reference(self, server,
                                                          ref_server):
        uri, s = server
        runs = [DeploymentRun(PORT, uri), DeploymentRun(PORT, None),
                DeploymentRun(REF, ref_server)]
        try:
            s.reset_rpcs()
            resized = set()
            for tick, churn in enumerate((0, 40, 40, 40)):
                snaps = [run.tick(churn) for run in runs]
                for other in snaps[1:]:
                    assert other["objects"] == snaps[0]["objects"], tick
                    assert other["exposition"] == snaps[0]["exposition"], tick
                    assert other["resizes"] == snaps[0]["resizes"], tick
                resized.update(pool for pool, _ in snaps[0]["resizes"])
                rpcs = s.reset_rpcs()
                assert rpcs["Solve"][0] == 1, (tick, rpcs)
            # the scale-from-zero pool was profiled from its template: its
            # pending TPU pods need nodes, and its pool was resized
            zero = runs[0].store.get("MetricsProducer", "default",
                                     "tpu-tpu-train-pool")
            assert zero.status.pending_capacity.additional_nodes_needed == 8
            assert "tpu-train-pool" in resized
            assert runs[0].runtime.solver_service.stats.fallbacks == 0
        finally:
            for run in runs:
                run.runtime.close()
