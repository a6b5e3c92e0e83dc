"""gRPC solver client: the control-plane side of the sidecar split (the
port's copy of karpenter_tpu/sidecar/client.py).

Drop-in for the in-process solver at the Algorithm seam (the reference's
pluggable-Algorithm boundary, pkg/autoscaler/algorithms/algorithm.go:24-40):
`SolverClient.solve` has the same (inputs, buckets) -> BinPackOutputs
contract as ops/binpack.solve, so metrics/producers/pendingcapacity
routes through it when the runtime is configured with a solver URI.

Resilience posture (docs/resilience.md): every RPC carries a DEADLINE
(`timeout_seconds`, default 30 s — never an unbounded wait on a dead
server) and transient failures (UNAVAILABLE — server restarting, channel
reconnecting — and DEADLINE_EXCEEDED) get ONE retry after a short
jittered sleep, decorrelating concurrent callers hitting the same
restart. Anything still failing surfaces to the caller.

What the port adds: the device rule of a controller that asked for the
card (`--device cuda`) while its card lives in the sidecar.
`require_backend` holds the sidecar's Health answer to it, and
`card_seams` gives the solve and decide seams whose failures reach the
caller as SolverDeviceError (SolverTimeout for an expired deadline), so
the solve service raises them instead of answering from numpy. Under
`--device cpu` the plain `solve` / `decide` keep the reference's
posture: the service's numpy ladder takes over.
"""

from __future__ import annotations

import random
import time as _time
from typing import Any, Dict, Optional, Tuple

from karpenter_tpu_torch.faults import FaultInjected, inject
from karpenter_tpu_torch.sidecar import codec
from karpenter_tpu_torch.sidecar.server import SERVICE, TENANT_METADATA_KEY
from karpenter_tpu_torch.utils.log import logger

DEFAULT_TIMEOUT_S = 30.0
# one retry, after uniform(0, retry_jitter_s) — enough to ride out a
# sidecar restart without amplifying load against a genuinely dead one
DEFAULT_RETRIES = 1
DEFAULT_RETRY_JITTER_S = 0.25


def _retryable_rpc_error(err: BaseException) -> bool:
    import grpc

    if isinstance(err, FaultInjected):
        return err.retryable  # injected transport faults ride the retry
    if not isinstance(err, grpc.RpcError):
        return False
    code = err.code() if callable(getattr(err, "code", None)) else None
    return code in (
        grpc.StatusCode.UNAVAILABLE,
        grpc.StatusCode.DEADLINE_EXCEEDED,
    )


class SolverClient:
    def __init__(
        self,
        target: str,
        timeout_seconds: float = DEFAULT_TIMEOUT_S,
        retries: int = DEFAULT_RETRIES,
        retry_jitter_s: float = DEFAULT_RETRY_JITTER_S,
        seed: int = 0,
        tenant: Optional[str] = None,
    ):
        import grpc

        self.target = target
        self.timeout = (
            timeout_seconds if timeout_seconds else DEFAULT_TIMEOUT_S
        )
        self.retries = retries
        self.retry_jitter_s = retry_jitter_s
        self._rng = random.Random(seed)
        # tenant-scoped RPCs (docs/multitenancy.md): the tenant id rides
        # every call as gRPC metadata, so a multi-tenant sidecar can
        # attribute solver traffic per tenant (server-side the label is
        # sanitized and series-capped — the value crosses a trust
        # boundary). None = single-tenant wire, byte-identical to
        # previous releases.
        self.tenant = tenant
        self._metadata = (
            ((TENANT_METADATA_KEY, tenant),) if tenant else None
        )
        self._channel = grpc.insecure_channel(target)
        self._solve = self._channel.unary_unary(f"/{SERVICE}/Solve")
        self._decide = self._channel.unary_unary(f"/{SERVICE}/Decide")
        self._health = self._channel.unary_unary(f"/{SERVICE}/Health")

    def _call(self, rpc, request, timeout: Optional[float] = None):
        """One RPC under the default deadline, with one jittered retry on
        transient transport failure. `sidecar.rpc` is the fault-injection
        point (faults/registry.py)."""
        deadline = timeout if timeout else self.timeout
        attempts = 1 + max(0, self.retries)
        # the tenant metadata kwarg is only passed when a tenant is
        # configured: the single-tenant call signature stays exactly
        # rpc(request, timeout=...) — wire- and test-double-compatible
        kwargs = (
            {"metadata": self._metadata} if self._metadata else {}
        )
        for attempt in range(attempts):
            try:
                inject("sidecar.rpc")
                return rpc(request, timeout=deadline, **kwargs)
            except Exception as e:  # noqa: BLE001 — classified below
                if attempt + 1 >= attempts or not _retryable_rpc_error(e):
                    raise
                delay = self._rng.uniform(0.0, self.retry_jitter_s)
                logger().warning(
                    "sidecar RPC failed (%s); retrying once in %.3fs",
                    e, delay,
                )
                _time.sleep(delay)

    def solve(self, inputs, buckets: int = 32, backend: str = "auto"):
        """BinPackInputs -> BinPackOutputs via the sidecar (numpy-backed)."""
        from karpenter_tpu_torch.ops.binpack import BinPackOutputs

        request = codec.pack_dataclass(
            inputs, meta={"buckets": buckets, "backend": backend}
        )
        response = self._call(self._solve, request)
        out, _ = codec.unpack_dataclass(BinPackOutputs, response)
        return out

    def decide(self, inputs):
        """DecisionInputs -> DecisionOutputs via the sidecar."""
        from karpenter_tpu_torch.ops.decision import DecisionOutputs

        response = self._call(self._decide, codec.pack_dataclass(inputs))
        out, _ = codec.unpack_dataclass(DecisionOutputs, response)
        return out

    def health(self) -> Tuple[bool, Dict[str, Any]]:
        arrays, meta = codec.unpack(
            self._call(self._health, codec.pack({}))
        )
        return bool(arrays["ok"]), meta

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "SolverClient":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None


class SidecarDeviceError(RuntimeError):
    """The sidecar does not compute where the controller asked it to."""


def require_backend(client: SolverClient, device: Optional[str]) -> dict:
    """The Health gate of a controller split from its card: returns the
    sidecar's Health meta. Under `device` None or "cuda" the sidecar must
    answer and say `backend: "cuda"`, else this raises (the RPC's error,
    or SidecarDeviceError). Under "cpu" either backend is accepted, and
    an unanswered Health is logged, not raised: the service's numpy
    ladder answers while the sidecar is away, as in the reference."""
    card = device in (None, "cuda")
    try:
        ok, meta = client.health()
    except Exception as error:  # noqa: BLE001 — raised on the card's rule
        if card:
            raise
        logger().warning(
            "solver sidecar %s did not answer Health (%s: %s); the numpy "
            "ladder serves until it does", client.target,
            type(error).__name__, error,
        )
        return {}
    if card and not (ok and meta.get("backend") == "cuda"):
        raise SidecarDeviceError(
            f"the solver sidecar at {client.target} computes on "
            f"{meta.get('backend')!r} (ok={ok}), and this controller asked "
            "for the CUDA card (--device cuda); start the sidecar on the "
            "card, or pass --device cpu to accept a CPU sidecar"
        )
    return meta


def _device_error(error: BaseException) -> BaseException:
    """A failed RPC as the card's error: an expired deadline is a
    SolverTimeout, anything else a SolverDeviceError."""
    from karpenter_tpu_torch.solver import SolverDeviceError, SolverTimeout

    if isinstance(error, (SolverDeviceError, SolverTimeout)):
        return error
    code = getattr(error, "code", None)
    code = code() if callable(code) else None
    if getattr(code, "name", None) == "DEADLINE_EXCEEDED":
        return SolverTimeout(f"solver sidecar RPC deadline expired: {error}")
    return SolverDeviceError(
        f"solver sidecar RPC failed: {type(error).__name__}: {error}"
    )


def card_seams(client: SolverClient):
    """(solve, decide) over `client` whose failures (after the client's
    one retry) raise SolverDeviceError or SolverTimeout, chained to the
    RPC's own error."""

    def solve(inputs, buckets: int = 32, backend: str = "auto"):
        try:
            return client.solve(inputs, buckets=buckets, backend=backend)
        except Exception as error:  # noqa: BLE001 — re-raised as the card's
            raise _device_error(error) from error

    def decide(inputs):
        try:
            return client.decide(inputs)
        except Exception as error:  # noqa: BLE001 — re-raised as the card's
            raise _device_error(error) from error

    return solve, decide
