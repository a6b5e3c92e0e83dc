"""gRPC solver sidecar server: owns the CUDA card, serves Solve/Decide/Health
(the port's copy of karpenter_tpu/sidecar/server.py).

The service/method names and message semantics are proto/solver.proto;
handlers are registered generically (no generated stubs, see
sidecar/__init__.py). Solve routes the pending-pods bin-pack through the
process-shared solve service (solver/service.py): on the card that is the
cuda rung, one launch of each CUDA kernel (csrc/fused_assign.cu,
csrc/shelf_bfd.cu) per request. Decide runs the HPA decision program
(ops/decision.decide) on the server's device. Both are stateless: all
inputs arrive in the request, matching the reference's checkpoint/resume
posture (all durable state in the store; SURVEY.md §5).

What differs from the reference:

  * the server runs on the CUDA card, or on the CPU only when
    `--device cpu` names it. Without a card `main` exits 1 with the
    reason before it binds: the reference's CPU fallback for an unusable
    accelerator is not copied, so a controller that asked for the card
    never gets CPU answers from a sidecar that silently lost it.
  * `--compile-cache-dir` names the CUDA kernels' build directory.
  * `--multihost` joins torch.distributed (parallel/multihost.py: the
    topology from torch's rendezvous env, MASTER_ADDR + MASTER_PORT,
    WORLD_SIZE and RANK) before the device check, as the reference joins
    before its backend probe; with no topology it serves single-host. A
    joined member computes where `--device` says and never falls back
    to the CPU (no sidecar of the port does), and Health's
    `device_count` is then the fleet's global device count. Each
    member's Solve runs on its own process's devices.
  * each server counts the RPCs it answered and their request bytes
    (`rpcs`), per method.
  * `main` stops the server on SIGTERM and exits 0 (the reference's
    waits until the signal kills the process).
"""

from __future__ import annotations

import json
import os
import sys
import threading
from concurrent import futures
from typing import Optional

import numpy as np
import torch

from karpenter_tpu_torch.observability import default_tracer
from karpenter_tpu_torch.sidecar import codec

SERVICE = "karpenter.solver.v1.Solver"

# tenant-scoped RPCs (docs/multitenancy.md): a multi-tenant control
# plane stamps its tenant id into this gRPC metadata key; the server
# attributes solver traffic per tenant on /metrics
# (karpenter_tenant_rpcs_total{name=<tenant>}).
TENANT_METADATA_KEY = "x-karpenter-tenant"

METHODS = ("Solve", "Decide", "Health")


def _solve(request: bytes, service=None) -> bytes:
    """One Solve: BinPackInputs bytes in, BinPackOutputs bytes out,
    through `service` (the process-shared one, on the card, by default)."""
    from karpenter_tpu_torch.ops.binpack import BinPackInputs
    from karpenter_tpu_torch.solver import default_service

    # optional tensors (pod_weight) may be absent from the wire; the codec
    # fills dataclass defaults and rejects missing-required/extra tensors
    inputs, meta = codec.unpack_dataclass(BinPackInputs, request)
    buckets = int(meta.get("buckets", 32))
    backend = meta.get("backend", "auto")
    service = service if service is not None else default_service()
    with default_tracer().span("sidecar.solve"):
        # the shared service owns device access: concurrent RPCs from the
        # gRPC worker pool queue on its worker, and outputs come back as
        # host numpy ready for the wire
        out = service.solve(inputs, buckets=buckets, backend=backend)
    return codec.pack_dataclass(out)


def _decide(request: bytes, device=None) -> bytes:
    """One Decide: DecisionInputs bytes in, DecisionOutputs bytes out,
    computed on `device` (the card by default) and fetched in one copy."""
    from karpenter_tpu_torch.ops import decision as D
    from karpenter_tpu_torch.utils.operands import host_seam

    inputs, _ = codec.unpack_dataclass(D.DecisionInputs, request)
    with default_tracer().span("sidecar.decide"):
        out = host_seam(D.decide, D.DecisionInputs, device)(inputs)
    return codec.pack_dataclass(out)


def _health(request: bytes, device=None) -> bytes:
    """`backend` is the device the server computes on ("cuda" or "cpu"),
    `device_count` the CUDA cards the process sees, or after a multihost
    join every rank's devices."""
    from karpenter_tpu_torch.parallel import multihost
    from karpenter_tpu_torch.utils.device import resolve_device

    return codec.pack(
        {"ok": np.asarray(True)},
        meta={
            "backend": resolve_device(device).type,
            "device_count": (len(multihost.global_devices())
                             if multihost.joined()
                             else torch.cuda.device_count()),
        },
    )


class SolverServer:
    """port=0 binds an ephemeral port; `port` holds the bound port after
    start(). `device` None is the card, whose Solves go through the
    process-shared service; `device="cpu"` builds a CPU service of the
    server's own (`service`, None on the card)."""

    def __init__(self, port: int = 9090, host: str = "0.0.0.0",
                 max_workers: int = 4, registry=None, device=None):
        from karpenter_tpu_torch.metrics.registry import default_registry

        self.host = host
        self.port = port
        self.max_workers = max_workers
        self.device = device
        self._server = None
        self.service = None
        if device is not None and torch.device(device).type == "cpu":
            from karpenter_tpu_torch.solver import SolverService

            self.service = SolverService(device="cpu")
        registry = registry if registry is not None else default_registry()
        # per-tenant RPC attribution (docs/multitenancy.md): counted by
        # the tenant id the client stamped into TENANT_METADATA_KEY;
        # single-tenant clients (no metadata) count nothing. The label
        # value is CLIENT-SUPPLIED, so it is sanitized and the distinct
        # series are CAPPED — an adversarial or misconfigured fleet
        # stamping unbounded ids must not grow /metrics without bound;
        # past the cap, traffic counts under the "_overflow" series.
        self._c_tenant_rpcs = registry.register(
            "tenant", "rpcs_total", kind="counter"
        )
        self._tenant_labels: set = set()
        # {method: [RPCs answered, request bytes]}
        self.rpcs = {method: [0, 0] for method in METHODS}
        self._rpcs_lock = threading.Lock()

    # distinct tenant label values one server will track; chosen well
    # above any sane tenant fleet per sidecar, far below scrape pain
    MAX_TENANT_SERIES = 1024

    def _tenant_label(self, value: str):
        """Sanitized, cardinality-capped label for a client-supplied
        tenant id: printable, bounded length, no label-breaking
        characters (the exposition escaper handles quoting, this bounds
        SIZE); ids beyond the series cap collapse to "_overflow"."""
        value = str(value)[:64]
        if not value or not value.isprintable():
            return None
        if value in self._tenant_labels:
            return value
        if len(self._tenant_labels) >= self.MAX_TENANT_SERIES:
            return "_overflow"
        self._tenant_labels.add(value)
        return value

    def _count_tenant(self, context) -> None:
        try:
            for key, value in context.invocation_metadata() or ():
                if key == TENANT_METADATA_KEY and value:
                    label = self._tenant_label(value)
                    if label is not None:
                        self._c_tenant_rpcs.inc(label, "-")
                    return
        except Exception:  # noqa: BLE001 — attribution must never fail an RPC
            pass

    def handlers(self):
        """{method: bytes -> bytes} bound to this server's device and
        service: what the gRPC handlers call."""
        return {
            "Solve": lambda request: _solve(request, self.service),
            "Decide": lambda request: _decide(request, self.device),
            "Health": lambda request: _health(request, self.device),
        }

    def reset_rpcs(self) -> dict:
        """The RPC counts so far ({method: (calls, request bytes)}),
        then zero them."""
        with self._rpcs_lock:
            taken = {m: tuple(v) for m, v in self.rpcs.items()}
            self.rpcs = {method: [0, 0] for method in METHODS}
        return taken

    def start(self) -> int:
        import grpc

        def wrap(method, fn):
            def handler(request: bytes, context) -> bytes:
                self._count_tenant(context)
                with self._rpcs_lock:
                    self.rpcs[method][0] += 1
                    self.rpcs[method][1] += len(request)
                try:
                    return fn(request)
                except Exception as e:  # noqa: BLE001 — errors go to the
                    # client as INTERNAL with the message, not a dead channel
                    context.abort(
                        grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
                    )

            return grpc.unary_unary_rpc_method_handler(
                handler,
                request_deserializer=None,  # raw bytes both ways
                response_serializer=None,
            )

        handlers = grpc.method_handlers_generic_handler(
            SERVICE,
            {method: wrap(method, fn)
             for method, fn in self.handlers().items()},
        )
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self.max_workers)
        )
        self._server.add_generic_rpc_handlers((handlers,))
        self.port = self._server.add_insecure_port(f"{self.host}:{self.port}")
        if self.port == 0:
            raise RuntimeError(f"could not bind {self.host}")
        self._server.start()
        return self.port

    def wait(self) -> None:
        self._server.wait_for_termination()

    def stop(self, grace: Optional[float] = 1.0) -> None:
        if self._server is not None:
            self._server.stop(grace).wait()
            self._server = None
        if self.service is not None:
            self.service.close()
            self.service = None


def _warmup(pods: int, service) -> None:
    """One solve of a `pods` x 300 problem through `service` (the
    reference's warm-up shape), so the first RPC finds the kernels built
    and loaded."""
    from karpenter_tpu_torch.ops.binpack import BinPackInputs

    service.solve(BinPackInputs(
        pod_requests=np.ones((pods, 3), np.float32),
        pod_valid=np.ones((pods,), bool),
        pod_intolerant=np.zeros((pods, 64), bool),
        pod_required=np.zeros((pods, 64), bool),
        group_allocatable=np.ones((300, 3), np.float32),
        group_taints=np.zeros((300, 64), bool),
        group_labels=np.ones((300, 64), bool),
    ))


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="karpenter_tpu_torch.sidecar",
        description="karpenter-tpu solver sidecar on a CUDA card (the "
        "PyTorch port)",
    )
    ap.add_argument("--port", type=int, default=9090)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument(
        "--warmup-pods",
        type=int,
        default=0,
        help="solve one problem at this pod count before serving",
    )
    ap.add_argument(
        "--multihost",
        action="store_true",
        help="join a multi-host deployment before serving (topology from "
        "MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK; none configured "
        "= single-host)",
    )
    ap.add_argument(
        "--compile-cache-dir",
        default=os.environ.get("KARPENTER_COMPILE_CACHE", ""),
        help="directory the CUDA kernels build into (also env "
        "KARPENTER_COMPILE_CACHE): a restarted sidecar loads them "
        "instead of running nvcc again. Empty = the package's own.",
    )
    ap.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the sidecar computes: the CUDA card (default; the "
        "process exits 1 when there is none) or the host CPU",
    )
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from karpenter_tpu_torch.utils.backend import (
        configure_compile_cache,
        ensure_usable_backend,
    )

    configure_compile_cache(args.compile_cache_dir)
    device = None if args.device == "cuda" else "cpu"
    server = None
    try:
        if args.multihost:
            # the join precedes the device check, as the reference's
            # precedes its backend probe; a configured but broken
            # topology raises (N independent solvers would double-solve
            # the fleet)
            from karpenter_tpu_torch.parallel.multihost import (
                initialize_multihost,
            )

            if not initialize_multihost(kind=args.device):
                print("multihost: no topology configured; serving "
                      "single-host", file=sys.stderr)
        # the card and every kernel, before the port is bound: a sidecar
        # that cannot compute on the card serves nothing
        note = ensure_usable_backend(device)
        server = SolverServer(port=args.port, host=args.host, device=device)
        if args.warmup_pods:
            from karpenter_tpu_torch.solver import default_service

            _warmup(args.warmup_pods, server.service or default_service())
        port = server.start()
    except Exception as error:  # noqa: BLE001 — reported, exit non-zero
        if server is not None:
            server.stop()
        print(
            f"karpenter_tpu_torch.sidecar: cannot start: "
            f"{type(error).__name__}: {error}",
            file=sys.stderr,
        )
        return 1
    print(f"sidecar device: {note}", file=sys.stderr)
    _serve_until_signalled(server)
    return 0


def _serve_until_signalled(server: SolverServer) -> None:
    """Print the serving line ({"serving": host:port, "service"}) on
    stdout once SIGTERM is handled (a SIGTERM sent on that line stops
    the server cleanly), serve until SIGTERM or ^C, then stop the server
    (and the process-shared service) and print one closing JSON line on
    stdout: the RPCs answered ({method: [calls, request bytes]}), the
    CUDA kernel launches this process made ({wrapper: launches}) and its
    peak resident memory in MiB."""
    import resource
    import signal

    stopping = threading.Event()
    previous = None
    try:
        previous = signal.signal(signal.SIGTERM,
                                 lambda signum, frame: stopping.set())
    except ValueError:
        pass  # not the main thread: ^C or the caller's stop() ends it
    print(json.dumps({"serving": f"{server.host}:{server.port}",
                      "service": SERVICE}), flush=True)
    try:
        while not stopping.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
        server.stop()
        from karpenter_tpu_torch.ops import fused_assign
        from karpenter_tpu_torch.solver import reset_default_service

        reset_default_service()
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        print(json.dumps({"stopped": f"{server.host}:{server.port}",
                          "rpcs": server.reset_rpcs(),
                          "launches": dict(fused_assign.LAUNCHES),
                          "peak_rss_mib": peak}),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
