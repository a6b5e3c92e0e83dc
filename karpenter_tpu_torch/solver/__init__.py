"""Shared solve service: request coalescing, shape buckets, the
device-resident fleet state and the never-block ladder for every
bin-pack caller (the port's copy of karpenter_tpu/solver).

Public surface:

  * SolverService       — the long-lived in-process service (on the CUDA
                          card by default; device="cpu" when asked for)
  * SolveFuture         — async handle from SolverService.submit
  * SolverSaturated     — bounded-queue backpressure signal
  * SolverTimeout       — per-request deadline expiry
  * SolverDeviceError   — the card's device path hung or is degraded
  * CostUnavailable     — the cost family is short-circuited (FSM
                          degraded): the caller scales cost-blind
  * default_service     — the process-shared instance
  * bucket_up / bucket_shape / pad_to_bucket — the shape ladder
"""

from karpenter_tpu_torch.solver.bucketing import (
    bucket_shape,
    bucket_up,
    pad_to_bucket,
)
from karpenter_tpu_torch.solver.resident import ResidentFleetState
from karpenter_tpu_torch.solver.service import (
    SUBSYSTEM,
    CostUnavailable,
    SolveFuture,
    SolverDeviceError,
    SolverSaturated,
    SolverService,
    SolverStatistics,
    SolverTimeout,
    default_service,
    reset_default_service,
)

__all__ = [
    "CostUnavailable",
    "ResidentFleetState",
    "SUBSYSTEM",
    "SolveFuture",
    "SolverDeviceError",
    "SolverSaturated",
    "SolverService",
    "SolverStatistics",
    "SolverTimeout",
    "bucket_shape",
    "bucket_up",
    "default_service",
    "pad_to_bucket",
    "reset_default_service",
]
