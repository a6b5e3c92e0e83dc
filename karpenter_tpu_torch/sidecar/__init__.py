"""Solver sidecar: the control-plane / device-solver process split (the
port's copy of karpenter_tpu/sidecar).

BASELINE.json's north star names the shape: the control plane "ships the
batch to a [control-plane]→gRPC→JAX sidecar" — the reference's analogous
process boundaries are the Prometheus HTTP hop (pkg/metrics/clients/
prometheus.go:35-55) and the scale-subresource RPC
(pkg/autoscaler/autoscaler.go:196-221). Running the solver out of process
keeps the card in exactly one place (one process holds it; N
control-plane replicas can share it) and makes the solver independently
restartable — the stateless-resume posture of SURVEY.md §5. In the
port the sidecar holds the CUDA card and launches both CUDA kernels; a
controller started with --solver-uri builds no kernel and needs no card.

The wire contract is documented in proto/solver.proto; messages are a
self-describing array framing (codec.py) rather than generated protobuf
classes, because this environment has no grpc codegen plugin — the gRPC
transport, service/method names, and semantics match the proto exactly,
and the bytes equal the reference package's, so either package's client
talks to either package's server. grpc is imported only where a server
starts or a client connects.
"""

from karpenter_tpu_torch.sidecar.client import SolverClient
from karpenter_tpu_torch.sidecar.server import SolverServer

__all__ = ["SolverClient", "SolverServer"]
