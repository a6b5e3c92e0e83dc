"""Shared solve service: one amortized device pipeline for every caller.

The port's copy of karpenter_tpu/solver/service.py: the bin-pack,
decide, fleet-tick (forecast, cost, poolgroup, fused_tick) and
disruption (consolidate, preempt) families with the numpy floor rung.
Every bin-pack caller — the pendingCapacity
batch solve, and later simulate and the sidecar — goes through this
single in-process front door, which turns independent calls into one
production pipeline:

  submit → coalesce → pad → dispatch → scatter

  * ADAPTIVE COALESCING QUEUE: requests arriving within a gather window
    are batched, grouped by compatibility key, and same-key requests on
    the `torch` rung ride ONE batched dispatch (a loop over the stacked
    operands' batch axis — each item runs the same per-item program as
    a direct solve(backend="torch"), so results match direct calls
    element for element). The window is LOAD-ADAPTIVE: an idle queue
    dispatches immediately (a lone reconcile tick pays no batching-timer
    tax), and the window widens to `window_s` only while recent traffic
    was actually concurrent.
  * PIPELINED DISPATCH: the worker double-buffers device work — while
    batch k computes on device, batch k+1 is gathered, padded, stacked,
    and dispatched, and only then is batch k's host-side fetch/crop
    paid. The torch rung's program makes no host sync between dispatch
    and drain; the drain waits on a CUDA event recorded after the
    dispatch, so it waits for its own batch only.
  * SHAPE BUCKETING (torch rung): operands are padded up the
    power-of-two-ish ladder (solver/bucketing.py) so that requests of
    nearby sizes stack into one batch; the dispatch key is (shape
    bucket, batch bucket, buckets, operand presence, backend). Nothing
    is compiled per key: the compile-cache counters count FIRST-SEEN
    dispatch keys (the first launch of a key pays lazy CUDA module
    loading and the caching allocator's growth, and earns the
    watchdog's grace), under the reference's metric names. The cuda
    rung does not pad (its kernels take any shape).
  * BACKPRESSURE + DEADLINES: the queue is bounded; each request
    carries a deadline.
  * BACKEND HEALTH FSM + WATCHDOG: after `health_failure_threshold`
    CONSECUTIVE device failures the service trips to DEGRADED: requests
    get no device attempt, and one probe dispatch per
    `health_probe_interval_s` rides the device path — a probe success
    flips back to HEALTHY. Separately, a watchdog (enabled by
    `watchdog_timeout_s` > 0) detects a worker HUNG inside a device
    call, restarts the worker thread (generation-stamped; the stale
    thread's late results are discarded) and answers the stuck
    requests. Both export karpenter_resilience_* metrics.
  * METRICS: queue depth, coalesce factor, first-seen keys,
    rejections/expiries/fallbacks, and per-stage latency percentiles,
    registered through the same GaugeRegistry the runtime serves on
    /metrics (subsystem "solver"), under the reference's names.

Who answers when the device path cannot. On the CPU (device="cpu") the
reference's never-block ladder holds: a full queue, an expired deadline
(on_timeout="fallback"), a device-path failure, a hang and a degraded
FSM are each answered from the numpy rung, counted in fallback_total.
On the card the service never answers from numpy unless the caller
named backend="numpy": a full queue raises SolverSaturated, an expired
deadline SolverTimeout, a failed launch its own error, a hang or a
degraded FSM SolverDeviceError — a kernel that fails is never hidden
behind the host program. A real CUDA fault (an illegal address, a
device-side assert) is sticky for the process's CUDA context: every
later launch fails too, so the FSM's probe cannot heal it; the service
keeps raising until the process restarts. Faults the probe heals are
the transient ones (an injected plan, a failed allocation).

Rungs. The reference resolves `auto` from JAX's platform; the port from
the service's `device=`, which defaults to the CUDA card (raising
without one — the CPU runs only when asked for, device="cpu"):

  * `cuda` (auto on the card; the reference's `pallas`): per request,
    ops/binpack.on_device places the request's own operands on the
    card (no padding), then ops/binpack.solve(backend="cuda") on them
    launches the hand-written CUDA kernels; synchronised inside the
    supervised device section; one device->host copy. Its stages split
    the "dispatch" stage into "upload" (the operands' host copy and
    host->device copy), "launch" (the operands on the card to the last
    op enqueued) and "sync"; the
    "device" stage is the card's own span of a Solve, from the operands
    on the card to the last op, read from two CUDA events after the
    sync. Each step is a span of the request's trace (solver.dispatch
    over solver.upload / fold / pack / assign / shelf / tail, then
    solver.sync, solver.fetch, solver.answer); the worker's
    solver.wait (blocked for work) and solver.gauges are roots of their
    own, and a turn of its loop is the profiler range solver.worker
    (never in the Tracer's ring). The kernels are built and loaded when a service whose rung
    resolves to `cuda` is constructed (or a request first names the
    rung), on the caller's thread, outside any supervised section: a
    build or load failure raises.
  * `torch` (the reference's `xla`): the coalesced, pipelined batch of
    the plain program, with the device-resident fleet state.
  * `numpy` (auto on the CPU): the host program (ops/numpy_binpack.py),
    with no padding.

The service holds no DOMAIN state — results are a pure function of each
request — but it does own one derived cache: the DEVICE-RESIDENT fleet
state (solver/resident.py). Singleton torch-rung dispatches keep their
padded operand stack resident on device, keyed by the host inputs
object's identity: an unchanged fleet re-dispatches with zero host
encode and zero upload, and a delta-encoded successor (the encoder's
SnapshotDeltaCache publishes the changed-row plan) applies as a row
scatter instead of a full re-upload.

The fleet-tick families (the HorizontalAutoscaler path; each answers
host numpy, fetched from the device in one copy per call):

  * `forecast` rides the coalescing queue: same-history-bucket requests
    are concatenated along the series axis and answered by one dispatch
    of forecast/models.forecast on the service's device.
  * `cost` is synchronous: the numpy mirror answers only as the
    requested backend; a device failure propagates (the CostEngine goes
    cost-blind) and a degraded FSM raises CostUnavailable.
  * `poolgroup` is synchronous: the joint program, then (CPU only) the
    independent per-pool ladders (poolgroup_numpy(enforce=False)).
  * `fused_tick` pads the forecast group up the T and S ladders at the
    door and runs ops/fusedtick.FusedTickProgram (one captured CUDA
    graph per shape class on the card). On the CPU a failure steps down
    to the chained per-stage path, then the numpy floor. On the card a
    failure raises (counted by the FSM): a chained serve would hide a
    broken graph while ticks carry on.

The disruption families (the consolidation and preemption engines):

  * `consolidate` submits N masked bin-packs (one per drain candidate)
    as one atomic batch (a shared batch marker lets it past max_batch),
    which takes one slot of the bounded queue on either device (the
    reference admits it candidate by candidate). On the torch rung the batch rides ONE dispatch under its own key
    ("vmap"); on the cuda rung each candidate is one launch of each
    CUDA kernel, one after another.
  * `preempt` rides the queue on its own shape ladder and runs
    ops/preempt.preempt_plan (PyTorch ops; no hand-written kernel) on
    the service's device, padded, fetched in one copy; the numpy mirror
    is bit-identical.

The simlab families (simlab/env.py, simlab/policy.py):

  * `sim_step` / `sim_rollout` are synchronous: one upload, one run of
    ops/simstep's tensor program on the service's device (a batched
    rollout is one program over the leading cluster axis), one fetch.
    `cuda` means the tensor program on the card (there is no
    hand-written sim kernel); `numpy` serves the bit-identical mirror.
    On the CPU the reference's never-block ladder holds: a failure
    serves the mirror and counts toward the FSM. On the card a failure
    raises and a degraded FSM raises SolverDeviceError; the mirror
    answers only when `numpy` is requested. `simlab.step` is the
    fault-injection point.

The introspection plane (observability/devicetelemetry.py,
--introspect) attaches with attach_introspection: the first dispatch of
a key (solve, forecast, preempt, fused — with its CUDA-graph capture)
and the kernels' build or load are noted into its compile ledger, and a
cuda-rung solve key carries the kernels' analytic cost
(ops/fused_assign.solve_cost) on its later dispatch spans.

Sharded dispatch (the reference's "Sharded dispatch"): a request whose
pods x groups cell count (forecast: series x history slots; preempt:
candidates x victims; decide: autoscalers x metrics) reaches
`shard_threshold` rides a mesh (parallel/mesh.py) of the process's own
devices (utils/device.visible_devices: every CUDA card, or the virtual
devices of force_virtual_devices), when one of two or more devices can be
built; `shard_devices` caps it and `shard_mesh_shape` pins its (pods,
groups) extents. Only device-resolved traffic shards (the cuda and torch
rungs, and the fleet-tick families on torch): a CPU service on its
default numpy rung never does. The key gains ("shard", extents)
("vmap_shard" for a consolidation batch). On the cuda rung each request
is one sharded solve whose shards launch the CUDA kernels (the card
route); on the torch rung the batch pads to mesh_aligned_shape and runs
the plain program on every shard, with residency keyed by mode, so a
threshold crossing rebuilds. The dispatch completes inline. A failure
retries the same requests on the single-device path of the same rung
(counted in shard_fallbacks, logged, and recorded), which on the card
is the card's kernels again, never numpy, and stops routing new traffic
to the mesh until reset_caches re-arms it. The reference builds its mesh
over jax.devices(), the global set after a multi-host join; the port's
service keeps to its own process's devices, and a joined fleet's global
mesh is parallel/mesh.py's (build_mesh). The fused tick keeps its one
graph whatever its size (the reference sends a fleet past the threshold
to its chained rung, whose decide shards).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.faults import inject
from karpenter_tpu_torch.metrics.registry import GaugeRegistry, default_registry
from karpenter_tpu_torch.observability import (
    default_flight_recorder,
    default_tracer,
)
from karpenter_tpu_torch.ops.binpack import (
    DEFAULT_BUCKETS,
    BinPackInputs,
    BinPackOutputs,
    has_constraint_operands,
    on_device,
)
from karpenter_tpu_torch.solver import bucketing
from karpenter_tpu_torch.solver.bucketing import (
    bucket_shape,
    bucket_up,
    constraint_shape,
    crop_outputs,
    crop_preempt_outputs,
    pad_preempt_inputs,
    pad_to_bucket,
    preempt_bucket_shape,
    presence,
)
from karpenter_tpu_torch.utils.device import DeviceLike, resolve_device
from karpenter_tpu_torch.utils.functional import pad_to_multiple
from karpenter_tpu_torch.utils.log import logger
from karpenter_tpu_torch.utils.operands import _field_of, fetch, host_seam

SUBSYSTEM = "solver"

QUEUE_DEPTH = "queue_depth"
COALESCE_FACTOR = "coalesce_factor"
REQUESTS_TOTAL = "requests_total"
DISPATCH_TOTAL = "dispatch_total"
COMPILE_CACHE_HITS = "compile_cache_hits_total"
COMPILE_CACHE_MISSES = "compile_cache_misses_total"
FALLBACK_TOTAL = "fallback_total"
REJECTED_TOTAL = "rejected_total"
DEADLINE_EXPIRED_TOTAL = "deadline_expired_total"
STAGE_P50_MS = "stage_p50_ms"
STAGE_P99_MS = "stage_p99_ms"
STAGE_SECONDS = "stage_seconds"
COALESCE_BATCH_SIZE = "coalesce_batch_size"
WINDOW_MS = "window_ms"
PIPELINE_DEPTH = "pipeline_depth"
UPLOAD_MS = "upload_ms"
SHARD_DEVICES = "shard_devices"
# device-resident fleet state (solver/resident.py)
RESIDENT_BYTES = "resident_bytes"
RESIDENT_ROWS = "resident_rows"
RESIDENT_SCATTER_MS = "resident_scatter_ms"
RESIDENT_REBUILDS = "resident_rebuilds_total"
# boot-time pre-warm
PREWARM_COMPILES = "prewarm_compiles_total"
PREWARM_MS = "prewarm_ms"
# device programs the last reconcile tick paid (note_tick)
DISPATCHES_PER_TICK = "dispatches_per_tick"

# The shard route (module docstring): a request whose cell count reaches
# this many cells rides the mesh when one of >= 2 devices exists. 2^24
# cells is about the north-star 100k x 300 fleet with headroom: small
# fleets (10k x 50 = 5 x 10^5) never pay the mesh, fleet-scale ones
# always shard. 0 disables sharding outright.
DEFAULT_SHARD_THRESHOLD = 1 << 24

# Forecast shape ladders (forecast requests bucket on (series, history
# length))
FORECAST_T_FLOOR = 16
FORECAST_S_FLOOR = 8

# A lone coalesced batch splits into pipeline_depth+1 chunked dispatches
# (so the double buffer has something to overlap) only at or above this
# size — smaller batches aren't worth a second dispatch's fixed cost, and
# 2-request batches must keep riding one dispatch.
_PIPELINE_SPLIT_MIN = 4

# Backend health FSM states (karpenter_resilience_solver_backend_state)
HEALTHY = "healthy"
DEGRADED = "degraded"

# Extra watchdog headroom for a dispatch whose key MISSED the cache: the
# first launch of a key pays lazy CUDA module loading and library
# handles (the reference's reason, a first XLA compile, is larger), and
# a restart mid-first-launch would loop. Cache hits get the bare
# watchdog_timeout_s. Kernel BUILDS never run under the watchdog.
COMPILE_GRACE_S = 120.0

_STAGE_WINDOW = 256  # per-stage latency ring size (fleet-scale constant)
# native-histogram ladders: stage latencies run from sub-ms host work to
# seconds-long first launches; coalesce batch sizes follow the
# power-of-two batch ladder
_STAGE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 30.0,
)
_COALESCE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
# Adaptive-window load tracking: EWMA of gathered batch sizes. Below the
# threshold the queue is treated as idle (dispatch immediately); at or
# above it the full window holds so concurrent bursts keep coalescing.
_LOAD_ALPHA = 0.5
_LOAD_IDLE = 1.5

BACKENDS = ("cuda", "torch", "numpy")

_OUTPUT_FIELDS = (
    "assigned", "assigned_count", "nodes_needed", "lp_bound", "unschedulable"
)


class SolverSaturated(RuntimeError):
    """The bounded request queue is full (backpressure signal)."""


class CostUnavailable(RuntimeError):
    """The cost-refinement path is short-circuited (backend-health FSM
    degraded, no probe due): the caller proceeds cost-blind this tick."""


class SolverTimeout(TimeoutError):
    """A request's deadline expired before the device path answered."""


class SolverDeviceError(RuntimeError):
    """The card's device path hung or is degraded (health FSM tripped):
    on the card the service raises this where the CPU service would
    answer from numpy."""


@dataclass
class SolverStatistics:
    """Plain-int mirror of the service counters (tests and callers read
    these directly; the registry carries the same values for /metrics).
    The reference's fields for the families this slice leaves out are
    absent; `upload_bytes` is the port's own."""

    requests: int = 0
    dispatches: int = 0
    coalesced_batches: int = 0
    compile_cache_hits: int = 0
    compile_cache_misses: int = 0
    fallbacks: int = 0
    rejected: int = 0
    deadline_expired: int = 0
    last_coalesce_factor: int = 0
    immediate_dispatches: int = 0  # idle-queue batches that skipped the window
    pipeline_overlaps: int = 0  # dispatches issued while another was in flight
    decide_calls: int = 0
    decide_errors: int = 0
    # cost-refinement seam (cost/)
    cost_calls: int = 0  # cost() entries
    cost_errors: int = 0  # cost() failures (the caller goes cost-blind)
    cost_dispatches: int = 0  # cost device dispatches
    # joint pool-group allocation seam (poolgroups/)
    poolgroup_calls: int = 0  # poolgroup() entries
    poolgroup_errors: int = 0  # poolgroup() failures
    poolgroup_dispatches: int = 0  # joint device dispatches
    poolgroup_independent_serves: int = 0  # degraded independent-ladder serves
    # batched drain-candidate evaluation (consolidation/)
    consolidate_calls: int = 0  # consolidate() entries
    consolidate_candidates: int = 0  # total candidates submitted across calls
    # forecast seam (forecast/)
    forecast_calls: int = 0  # forecast() entries
    forecast_series: int = 0  # total series submitted across calls
    forecast_dispatches: int = 0  # coalesced forecast device dispatches
    # eviction-planning seam (ops/preempt.py, preemption/)
    preempt_calls: int = 0  # preempt() entries
    preempt_candidates: int = 0  # total candidates submitted across calls
    preempt_dispatches: int = 0  # preempt device dispatches
    # fused steady-state tick (ops/fusedtick.py)
    fused_calls: int = 0  # fused_tick() entries
    fused_dispatches: int = 0  # ticks answered by the ONE fused program
    fused_chained_serves: int = 0  # ticks served by the per-stage rung
    fused_mirror_serves: int = 0  # ticks served by the numpy floor
    # simlab cluster-stepping seam (ops/simstep.py, simlab/)
    sim_calls: int = 0  # sim_step() + sim_rollout() entries
    sim_dispatches: int = 0  # sim device dispatches (1 per batched call)
    sim_mirror_serves: int = 0  # sim calls served by the numpy mirror
    # cuda-resolved requests carrying constraint operands rerouted to the
    # torch rung (the fused kernel has no constraint entry — counted,
    # never silently dropped)
    constraint_reroutes: int = 0
    last_dispatches_per_tick: int = 0  # note_tick() delta (the gauge)
    # device-resident fleet state (solver/resident.py)
    resident_hits: int = 0  # dispatches served from resident buffers as-is
    resident_scatters: int = 0  # dispatches served via a changed-row scatter
    resident_rebuilds: int = 0  # full uploads (re)establishing residency
    resident_drops: int = 0  # wholesale discards (ladder / recovery boot)
    pipeline_splits: int = 0  # lone batches chunked so the pipeline overlaps
    # the shard route (module docstring)
    shard_dispatches: int = 0  # dispatches answered by the sharded program
    shard_requests: int = 0  # requests routed onto the mesh at submit
    shard_fallbacks: int = 0  # shard-route failures retried single-device
    # host bytes sent to the device: full uploads plus resident scatters'
    # index vectors and update blocks
    upload_bytes: int = 0
    # backend health FSM + watchdog
    device_failures: int = 0  # total device-path failures (any rung)
    fsm_trips: int = 0  # healthy -> degraded transitions
    fsm_recoveries: int = 0  # degraded -> healthy transitions
    fsm_probes: int = 0  # device probes granted while degraded
    fsm_short_circuits: int = 0  # batches routed to numpy with no attempt
    watchdog_restarts: int = 0  # hung-worker restarts


@dataclass
class _Request:
    inputs: BinPackInputs
    buckets: int
    backend: str
    key: tuple
    n_pods: int
    n_groups: int
    deadline: Optional[float]
    enqueued_at: float
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[object] = None
    error: Optional[BaseException] = None
    abandoned: bool = False
    # consolidate() batch marker: requests sharing an id were enqueued
    # atomically and must ride ONE dispatch — _collect keeps draining the
    # queue past max_batch while the head continues the same batch
    coalesce_id: Optional[int] = None
    # reconcile-trace span opened at submit (observability.tracing):
    # covers queue wait through completion; the coalesced dispatch span
    # LINKS it, and the FSM-trip flight-recorder event backlinks its
    # trace id. None with tracing disabled.
    span: Optional[object] = None
    # tenant id the submitter stamped, carried into the span args
    tenant: Optional[str] = None
    _finish_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False
    )

    def trace_id(self) -> Optional[str]:
        return self.span.trace_id if self.span is not None else None

    def finish(self, result=None, error=None, degraded: bool = False) -> bool:
        """First finisher wins (idempotent): the watchdog may answer a
        stuck request while the stale worker later unwedges and tries to
        answer it too — the caller must see exactly one result.
        `degraded` marks the span of a request the ladder answered from
        numpy AFTER a device failure/hang."""
        with self._finish_lock:
            if self.event.is_set():
                return False
            self.result = result
            self.error = error
            self.event.set()
            if self.span is not None:
                self.span.close(
                    ok=error is None, degraded=degraded or None
                )
            return True


class SolveFuture:
    """Handle returned by submit(); result() blocks with a deadline."""

    def __init__(self, request: _Request, service: "SolverService"):
        self._request = request
        self._service = service

    def result(self, timeout: Optional[float] = None):
        req = self._request
        if not req.event.wait(timeout):
            req.abandoned = True  # the worker will skip it
            self._service._on_expired(req)
            raise SolverTimeout(
                f"solve deadline expired after {timeout}s "
                f"(queue depth {self._service.queue_depth()})"
            )
        if req.error is not None:
            raise req.error
        return req.result


def _p50_p99(samples: Sequence[float]) -> Tuple[float, float]:
    """np.percentile(samples, (50, 99)) bit for bit (numpy's default
    "linear" method) from one sort. publish_gauges takes both for every
    stage after every batch, where np.percentile's own overhead cost
    ~5x the sort."""
    ordered = sorted(samples)
    last = len(ordered) - 1
    out = []
    for q in (0.5, 0.99):
        virtual = last * q
        lo = math.floor(virtual)
        a, b = ordered[lo], ordered[min(lo + 1, last)]
        t = virtual - lo
        # numpy's _lerp: from the nearer end
        out.append(b - (b - a) * (1 - t) if t >= 0.5 else a + (b - a) * t)
    return out[0], out[1]


class SolverService:
    """Long-lived in-process solve service (module docstring).

    `device` is where the device rungs run: the CUDA card by default
    (raising without one), the CPU only when named. `device_solver`
    overrides the in-process device path with any (inputs, buckets=...,
    backend=...) -> BinPackOutputs callable — a fault injector in tests,
    or a remote solver. With an override the worker dispatches requests
    individually, but queueing, deadlines, backpressure, fallback, and
    metrics still apply. `decider` seams the HPA decision program the
    same way.

    `card_rule` holds a host service to the card's failure rule (failures
    raise, never answered from numpy): a controller whose card lives in a
    solver sidecar runs its service on the host with `card_rule=True`
    when the operator asked for the card.
    """

    def __init__(
        self,
        registry: Optional[GaugeRegistry] = None,
        *,
        window_s: float = 0.002,
        adaptive_window: bool = True,
        pipeline_depth: int = 1,
        max_queue: int = 64,
        max_batch: int = 8,
        default_timeout_s: float = 30.0,
        backend: str = "auto",
        on_timeout: Optional[str] = None,  # "fallback" (CPU only) | "raise"
        device_solver: Optional[Callable] = None,
        decider: Optional[Callable] = None,
        clock: Callable[[], float] = _time.monotonic,
        health_failure_threshold: int = 3,
        health_probe_interval_s: float = 5.0,
        watchdog_timeout_s: float = 0.0,  # 0 = watchdog disabled
        shard_threshold: int = DEFAULT_SHARD_THRESHOLD,
        shard_devices: Optional[int] = None,
        shard_mesh_shape: Optional[tuple] = None,
        resident: bool = True,
        device: DeviceLike = None,
        card_rule: bool = False,
    ):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        # the never-block ladder (module docstring) answers from numpy on
        # the CPU only: on the card a failure reaches the caller
        self._numpy_ladder = dev.type != "cuda" and not card_rule
        if on_timeout is None:
            on_timeout = "fallback" if self._numpy_ladder else "raise"
        if on_timeout not in ("fallback", "raise"):
            raise ValueError(f"on_timeout must be fallback|raise, got {on_timeout!r}")
        if on_timeout == "fallback" and not self._numpy_ladder:
            raise ValueError(
                "on_timeout='fallback' answers from numpy, which the card's "
                "service never does; use 'raise'"
            )
        self.registry = registry if registry is not None else default_registry()
        # window_s is the MAX gather window: with adaptive_window an idle
        # queue dispatches immediately and only concurrent traffic waits
        # the window out; adaptive_window=False pins the fixed window
        self.window_s = window_s
        self.adaptive_window = adaptive_window
        # how many dispatched-but-unfetched batches may be in flight (1 =
        # double buffering: host scatter of batch k overlaps device
        # compute of batch k+1); 0 disables pipelining
        self.pipeline_depth = pipeline_depth
        self.max_queue = max_queue
        self.max_batch = max_batch
        self.default_timeout_s = default_timeout_s
        self.backend = backend
        self.on_timeout = on_timeout
        self.device_solver = device_solver
        self._decider = decider
        self._clock = clock
        self.stats = SolverStatistics()
        self._queue: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        # dispatch keys seen so far (_count_key)
        self._compile_seen: set = set()
        # the introspection plane (attach_introspection); None = detached
        self._introspect = None
        # wall seconds of this service's kernel build/load, until the
        # plane has ledgered it (_note_kernels)
        self._kernels_unnoted: Optional[float] = None
        # kernel families already pre-warmed (prewarm; reset_caches re-arms)
        self._prewarmed: set = set()
        self._kernels_ready = False
        self._kernel_lock = threading.Lock()
        # the fused tick's program (one captured graph per shape class),
        # built on first use
        self._fused_program = None
        self._stages: Dict[str, collections.deque] = {}
        self._stage_lock = threading.Lock()
        # worker-only state: batch-size EWMA (adaptive window), in-flight
        # dispatches (pipeline), and the gauges mirroring both
        self._load = 0.0
        self._window_now_s = 0.0 if adaptive_window else window_s
        self._inflight: collections.deque = collections.deque()
        self._last_pipeline_depth = 0
        # the shard route (module docstring): the mesh is built lazily on
        # first use; one shard-route failure stops routing NEW traffic to
        # it (the single-device path keeps serving) until reset_caches
        self.shard_threshold = shard_threshold
        self.shard_devices = shard_devices
        self.shard_mesh_shape = (
            tuple(shard_mesh_shape) if shard_mesh_shape else None
        )
        self._mesh = None
        self._mesh_ready = False
        self._mesh_lock = threading.Lock()
        self._shard_broken = False
        # device-resident fleet state (solver/resident.py): singleton
        # torch-rung dispatches keep their operand stack on device and
        # churn applies as row scatters. `resident=False` pins the
        # upload-every-dispatch path.
        self.resident_enabled = resident
        from karpenter_tpu_torch.solver.resident import ResidentFleetState

        self._resident = ResidentFleetState()
        # backend health FSM (module docstring)
        self.health_failure_threshold = health_failure_threshold
        self.health_probe_interval_s = health_probe_interval_s
        self.watchdog_timeout_s = watchdog_timeout_s
        self._health_lock = threading.Lock()
        self._health = HEALTHY
        self._consec_device_failures = 0
        self._next_probe = 0.0
        # watchdog: generation-stamped worker threads; a restart bumps
        # the generation and the superseded thread discards its results
        self._worker_gen = 0
        self._watchdog: Optional[threading.Thread] = None
        self._busy_since: Optional[float] = None
        self._busy_requests: List[_Request] = []
        # the FULL batch the worker is currently processing (already
        # popped from the queue): on a watchdog restart, groups not yet
        # dispatched live only here and must be drained too
        self._current_batch: List[_Request] = []
        self._tls = threading.local()
        # per-tick dispatch accounting (note_tick)
        self._tick_dispatch_mark = 0
        self._coalesce_seq = 0  # consolidate() batch-marker source
        self._register_metrics()
        if self._resolve_backend(None) == "cuda":
            self._ensure_kernels()

    # -- metrics ----------------------------------------------------------

    def _register_metrics(self) -> None:
        reg = self.registry.register
        self._g_queue = reg(SUBSYSTEM, QUEUE_DEPTH)
        self._g_coalesce = reg(SUBSYSTEM, COALESCE_FACTOR)
        self._c_requests = reg(SUBSYSTEM, REQUESTS_TOTAL, kind="counter")
        self._c_dispatch = reg(SUBSYSTEM, DISPATCH_TOTAL, kind="counter")
        self._c_hits = reg(SUBSYSTEM, COMPILE_CACHE_HITS, kind="counter")
        self._c_misses = reg(SUBSYSTEM, COMPILE_CACHE_MISSES, kind="counter")
        self._c_fallback = reg(SUBSYSTEM, FALLBACK_TOTAL, kind="counter")
        self._c_rejected = reg(SUBSYSTEM, REJECTED_TOTAL, kind="counter")
        self._c_expired = reg(
            SUBSYSTEM, DEADLINE_EXPIRED_TOTAL, kind="counter"
        )
        self._g_stage_p50 = reg(SUBSYSTEM, STAGE_P50_MS)
        self._g_stage_p99 = reg(SUBSYSTEM, STAGE_P99_MS)
        # native histograms: the stage rings as bucketed distributions
        # {name=<stage>}, and the coalesce factor as a batch-size histogram
        self._h_stage = reg(
            SUBSYSTEM, STAGE_SECONDS, kind="histogram",
            buckets=_STAGE_BUCKETS,
        )
        self._h_coalesce = reg(
            SUBSYSTEM, COALESCE_BATCH_SIZE, kind="histogram",
            buckets=_COALESCE_BUCKETS,
        )
        self._g_window = reg(SUBSYSTEM, WINDOW_MS)
        self._g_pipeline = reg(SUBSYSTEM, PIPELINE_DEPTH)
        # devices behind the shard route (0: no mesh, or the route tripped)
        self._g_shard = reg(SUBSYSTEM, SHARD_DEVICES)
        # host->device transfer p50 of recent dispatches; also present
        # per-dispatch under stage_p50_ms{upload}
        self._g_upload = reg(SUBSYSTEM, UPLOAD_MS)
        # device-resident fleet state: bytes/rows currently resident, the
        # last scatter's wall time, and how often residency had to
        # rebuild from a full upload
        self._g_resident_bytes = reg(SUBSYSTEM, RESIDENT_BYTES)
        self._g_resident_rows = reg(SUBSYSTEM, RESIDENT_ROWS)
        self._g_resident_scatter = reg(SUBSYSTEM, RESIDENT_SCATTER_MS)
        self._c_resident_rebuilds = reg(
            SUBSYSTEM, RESIDENT_REBUILDS, kind="counter"
        )
        # boot-time pre-warm: families warmed {name=<family>} and the
        # wall cost of each family's warm dispatch
        self._c_prewarm = reg(SUBSYSTEM, PREWARM_COMPILES, kind="counter")
        self._g_prewarm_ms = reg(SUBSYSTEM, PREWARM_MS)
        # device programs per reconcile tick (note_tick)
        self._g_dispatches_tick = reg(SUBSYSTEM, DISPATCHES_PER_TICK)
        # degradation-ladder surface: FSM state (0 healthy / 1 degraded)
        # + transition and watchdog counters
        self._g_backend_state = reg("resilience", "solver_backend_state")
        self._g_backend_state.set("-", "-", 0.0)
        self._c_trips = reg(
            "resilience", "solver_trips_total", kind="counter"
        )
        self._c_probes = reg(
            "resilience", "solver_probes_total", kind="counter"
        )
        self._c_recoveries = reg(
            "resilience", "solver_recoveries_total", kind="counter"
        )
        self._c_watchdog = reg(
            "resilience", "solver_watchdog_restarts_total", kind="counter"
        )

    def _record_stage(self, stage: str, seconds: float) -> None:
        ms = seconds * 1e3
        with self._stage_lock:
            ring = self._stages.get(stage)
            if ring is None:
                ring = self._stages[stage] = collections.deque(
                    maxlen=_STAGE_WINDOW
                )
            ring.append(ms)
        self._h_stage.observe(stage, "-", seconds)

    def publish_gauges(self) -> None:
        """Refresh the point-in-time gauges (queue depth, coalesce
        factor, per-stage latency percentiles). Counters are incremented
        at event time and need no refresh."""
        self._g_queue.set("-", "-", float(self.queue_depth()))
        self._g_coalesce.set(
            "-", "-", float(self.stats.last_coalesce_factor)
        )
        # the EFFECTIVE window of the last gather (0 on an idle queue,
        # window_s under concurrency) and the in-flight depth of the
        # last dispatch
        self._g_window.set("-", "-", self._window_now_s * 1e3)
        self._g_pipeline.set("-", "-", float(self._last_pipeline_depth))
        n_shard = 0
        if self._mesh is not None and not self._shard_broken:
            n_shard = self._mesh.size
        self._g_shard.set("-", "-", float(n_shard))
        self._g_resident_bytes.set(
            "-", "-", float(self._resident.resident_bytes())
        )
        self._g_resident_rows.set(
            "-", "-", float(self._resident.resident_rows())
        )
        with self._stage_lock:
            snapshot = {k: list(v) for k, v in self._stages.items()}
        for stage, samples in snapshot.items():
            if samples:
                p50, p99 = _p50_p99(samples)
                self._g_stage_p50.set(stage, "-", p50)
                self._g_stage_p99.set(stage, "-", p99)
                if stage == "upload":
                    self._g_upload.set("-", "-", p50)

    def note_tick(self) -> None:
        """Per-tick dispatch accounting behind the
        karpenter_solver_dispatches_per_tick gauge: called once at the
        end of every reconcile tick; the gauge then shows how many
        device dispatches that tick paid."""
        delta = self.stats.dispatches - self._tick_dispatch_mark
        self._tick_dispatch_mark = self.stats.dispatches
        self.stats.last_dispatches_per_tick = delta
        self._g_dispatches_tick.set("-", "-", float(delta))

    @contextlib.contextmanager
    def track(self, stage: str):
        """Record an arbitrary caller stage (e.g. the HA controller's
        fleet decide) into the service's latency surface."""
        t0 = _time.perf_counter()
        try:
            yield
        finally:
            self._record_stage(stage, _time.perf_counter() - t0)

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def reset_caches(self) -> None:
        """Recovery-boot seam: forget the seen dispatch keys and drop
        every device-resident operand stack, so post-restart dispatches
        rebuild from scratch (post-recovery encodes must not scatter
        into pre-crash buffers). A fresh set is swapped in whole, so a
        worker mid-lookup keeps a consistent (old) view and the next
        lookup sees the reset. The built CUDA kernels stay loaded: they
        are a pure function of their sources."""
        with self._cond:
            self._compile_seen = set()
        # a recovery boot also re-arms the shard route: a pre-crash shard
        # failure must not pin the successor single-device forever
        self._shard_broken = False
        self._resident.drop_all()
        # a reset plane may legitimately want a fresh warm-up
        self._prewarmed = set()

    # -- kernels ----------------------------------------------------------

    def _ensure_kernels(self) -> None:
        """Build (nvcc, all sources at once) and load the CUDA kernels
        the cuda rung launches, on the calling thread and outside any
        supervised device section. A failure raises: it is a defect of
        the build, not a device outage, and must not be served by the
        numpy rung."""
        if self._kernels_ready:
            return
        from karpenter_tpu_torch import kernels

        with self._kernel_lock:  # concurrent cuda submits build once
            if self._kernels_ready:
                return
            t0 = _time.perf_counter()
            kernels.build()
            for name in kernels.SOURCES:
                kernels.library(name)
            self._kernels_unnoted = _time.perf_counter() - t0
            self._kernels_ready = True
        self._note_kernels()

    # -- introspection plane (observability/devicetelemetry.py) ------------

    def attach_introspection(self, plane) -> None:
        """Wire the solver introspection plane (--introspect): dispatch
        sites note first-time events into its ledger and dispatch spans
        gain the cost attribution captured then. A kernel build that ran
        before the plane attached (the constructor's) is noted now.
        Detached (the default), every hook below is one attribute read."""
        self._introspect = plane
        self._note_kernels()

    def _note_kernels(self) -> None:
        """Ledger this service's CUDA kernel build/load once, as family
        "kernels" (rung "cuda")."""
        seconds = self._kernels_unnoted
        if seconds is None or self._introspect is None:
            return
        from karpenter_tpu_torch import kernels

        self._kernels_unnoted = None
        self._note_compile(
            "kernels", ("kernels", "cuda", "+".join(kernels.SOURCES)),
            seconds,
        )

    def _note_compile(
        self, family: str, key: tuple, seconds: float,
        live: List[_Request] = (), extents=None, cost_fn=None,
    ) -> None:
        """One first-time event into the introspection ledger: the wall
        time it paid, the trace ids that paid for it, and — lazily, only
        with the plane enabled — its cost analysis. Never raises into
        the dispatch path."""
        plane = self._introspect
        if plane is None:
            return
        try:
            plane.note_compile(
                family, key, seconds,
                trace_ids=self._trace_ids(list(live)),
                extents=extents, cost_fn=cost_fn,
            )
        except Exception:  # noqa: BLE001 — telemetry must never break a solve
            pass

    def _span_cost_args(self, key: tuple) -> dict:
        """{flops, bytes} args for this dispatch's span, {} when the
        introspection plane is off or never attributed the key."""
        plane = self._introspect
        if plane is None:
            return {}
        return plane.dispatch_cost_args(key)

    # -- boot-time pre-warm -------------------------------------------------

    def prewarm(self, families=("solve", "decide")) -> Dict[str, dict]:
        """Drive one tiny REAL dispatch per named family through the
        normal queue before the first real request arrives — same
        bucketing, same key cache, same FSM accounting — so the first
        touch of a small fleet (lazy CUDA module loading, library
        handles, the caching allocator's first blocks) is paid at boot:

          solve  — 1 pod x 1 group, padded up to the floor rung
                   (256 pods x 8 groups), weight operand present;
          decide — 1 autoscaler x 1 metric, padded to the decision
                   program's row bucket (ops/decision.pad_to);
          forecast — 1 series x 1 sample, padded to the forecast
                   ladders' floors (8 series x 16 samples);
          cost / poolgroup — the smallest fleet row bucket / one group
                   of two pools;
          fused  — the fused tick with forecast, decide and cost
                   present at the smallest rung of every ladder (on the
                   card: one graph capture).

        A family already warmed is SKIPPED (reset_caches re-arms).
        Failures of a warm dispatch degrade, never block boot: the
        family is reported and skipped. The CUDA kernels' build is not
        such a failure: it runs first and raises (see _ensure_kernels)."""
        if "solve" in families and self._resolve_backend(None) == "cuda":
            self._ensure_kernels()
        report: Dict[str, dict] = {}
        for family in families:
            if family in self._prewarmed:
                report[family] = {"skipped": True}
                continue
            misses_before = self.stats.compile_cache_misses
            t0 = _time.perf_counter()
            try:
                self._prewarm_dispatch(family)
            except Exception as error:  # noqa: BLE001 — never block boot
                logger().warning(
                    "pre-warm for family %r failed (%s: %s); first-touch "
                    "traffic will pay it (or degrade) instead",
                    family, type(error).__name__, error,
                )
                report[family] = {
                    "skipped": False, "error": type(error).__name__,
                }
                continue
            elapsed_ms = (_time.perf_counter() - t0) * 1e3
            self._prewarmed.add(family)
            self._c_prewarm.inc(family, "-")
            self._g_prewarm_ms.set(family, "-", elapsed_ms)
            report[family] = {
                "skipped": False,
                "ms": round(elapsed_ms, 3),
            }
            if family in ("solve", "forecast", "fused"):
                # only the queue and fused families count keys in the
                # service's cache counters; the synchronous families
                # have no such counter, so no (meaningless) zero is
                # reported for them
                report[family]["fresh_compiles"] = (
                    self.stats.compile_cache_misses - misses_before
                )
        return report

    def _prewarm_dispatch(self, family: str) -> None:
        """One tiny real dispatch for `family` (see prewarm)."""
        if family == "solve":
            self.solve(_prewarm_solve_inputs())
            return
        if family == "decide":
            self.decide(_prewarm_decide_inputs())
            return
        if family == "forecast":
            self.forecast(_prewarm_fused_inputs().forecast)
            return
        if family == "cost":
            self.cost(_prewarm_cost_inputs())
            return
        if family == "poolgroup":
            self.poolgroup(_prewarm_poolgroup_inputs())
            return
        if family == "fused":
            self.fused_tick(_prewarm_fused_inputs())
            return
        raise ValueError(f"unknown pre-warm family {family!r}")

    def stage_percentiles(self) -> Dict[str, Dict[str, float]]:
        """{stage: {"p50_ms", "p99_ms", "n"}} over the retained latency
        rings."""
        with self._stage_lock:
            snapshot = {k: list(v) for k, v in self._stages.items()}
        return {
            stage: {
                "p50_ms": round(float(np.percentile(samples, 50)), 4),
                "p99_ms": round(float(np.percentile(samples, 99)), 4),
                "n": len(samples),
            }
            for stage, samples in snapshot.items()
            if samples
        }

    def stage_samples(self, stage: str) -> List[float]:
        """The retained samples of one stage's latency ring, in ms,
        oldest first (empty for a stage never recorded)."""
        with self._stage_lock:
            return list(self._stages.get(stage, ()))

    # -- submission -------------------------------------------------------

    def _resolve_backend(self, backend: Optional[str]) -> str:
        backend = backend or self.backend
        if self.device_solver is not None:
            return backend  # the override owns backend semantics
        if backend == "auto":
            return "cuda" if self.device.type == "cuda" else "numpy"
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown solver backend {backend!r} (one of {BACKENDS})"
            )
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError(
                f"backend 'cuda' needs a CUDA device, the service runs on "
                f"{self.device}"
            )
        return backend

    def _shard_mesh(self):
        """The lazily-built mesh of the shard route (parallel/mesh.py)
        over this process's devices of the service's type, or None when
        sharding is unavailable: disabled (shard_threshold <= 0), fewer
        than 2 devices, or mesh construction failed (logged once; the
        single-device path serves)."""
        if self._mesh_ready:
            return self._mesh
        with self._mesh_lock:
            if self._mesh_ready:
                return self._mesh
            mesh = None
            try:
                if self.shard_threshold > 0:
                    from karpenter_tpu_torch.parallel.mesh import build_mesh
                    from karpenter_tpu_torch.utils.device import visible_devices

                    devices = visible_devices(self.device.type)
                    n = len(devices)
                    if self.shard_devices is not None:
                        n = min(n, self.shard_devices)
                    shape = self.shard_mesh_shape
                    if shape is not None and shape[0] * shape[1] >= 2:
                        mesh = build_mesh(devices=devices[:n], shape=shape)
                    elif shape is None and n >= 2:
                        # a 1-device "mesh" (an explicit 1x1 included)
                        # would route traffic through the sharded path
                        # with no parallelism while reporting sharding
                        # active: below 2 devices the single-device
                        # program IS the right path
                        mesh = build_mesh(devices=devices[:n])
            except Exception as error:  # noqa: BLE001 — optional route
                logger().warning(
                    "sharded dispatch unavailable (%s: %s); staying "
                    "single-device",
                    type(error).__name__, error,
                )
            self._mesh = mesh
            self._mesh_ready = True
            return mesh

    def _shard_extents(self, resolved: str, n_pods: int, n_groups: int):
        """Route one request: the mesh extents it rides, or None. A
        request of the cuda or torch rung whose cell count reaches
        shard_threshold rides the mesh on the same rung; below threshold
        (or with sharding unavailable or tripped, or under a
        device_solver override, where device math lives out of process)
        nothing changes."""
        if (
            self.shard_threshold <= 0
            or self._shard_broken
            or self.device_solver is not None
            or resolved not in ("cuda", "torch")
            or n_pods * n_groups < self.shard_threshold
        ):
            return None
        mesh = self._shard_mesh()
        if mesh is None:
            return None
        from karpenter_tpu_torch.parallel.mesh import mesh_extents

        return mesh_extents(mesh)

    def submit(
        self,
        inputs: BinPackInputs,
        buckets: int = DEFAULT_BUCKETS,
        backend: Optional[str] = None,
        timeout: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> SolveFuture:
        """Enqueue one solve; raises SolverSaturated when the bounded
        queue is full (solve() turns that into the numpy fallback on the
        CPU).
        `tenant` stamps the request's trace span."""
        if self._closed:
            raise RuntimeError("solver service is closed")
        n_pods = inputs.pod_requests.shape[0]
        n_groups = inputs.group_allocatable.shape[0]
        resolved = self._resolve_backend(backend)
        if resolved == "cuda" and self.device_solver is None:
            if has_constraint_operands(inputs):
                # the fused kernel has no constraint entry; route to the
                # torch rung (exact, still on the card) and COUNT it
                resolved = "torch"
                self.stats.constraint_reroutes += 1
            else:
                self._ensure_kernels()
        extents = self._shard_extents(resolved, n_pods, n_groups)
        key = (
            bucket_shape(inputs), buckets, resolved, presence(inputs),
            constraint_shape(inputs),
        )
        if extents is not None:
            key += ("shard", extents)
            self.stats.shard_requests += 1
        timeout = self.default_timeout_s if timeout is None else timeout
        now = self._clock()
        request = _Request(
            inputs=inputs,
            buckets=buckets,
            backend=resolved,
            key=key,
            n_pods=n_pods,
            n_groups=n_groups,
            deadline=(now + timeout) if timeout else None,
            enqueued_at=now,
            tenant=tenant,
        )
        self._enqueue_one(request)
        return SolveFuture(request, self)

    def _begin_request_span(self, request: _Request) -> None:
        """Open the request's reconcile-trace span (parented to the
        submitter's current span, so a tick-minted trace id follows the
        request across the worker-thread boundary). No-op — request.span
        stays None — when tracing is disabled."""
        family = (
            request.key[0] if isinstance(request.key[0], str) else "binpack"
        )
        request.span = default_tracer().begin(
            "solver.request", family=family, backend=request.backend,
            tenant=request.tenant,
        )

    def _record_rejected_span(self, backend: str) -> None:
        """Open-and-close a rejected request span for a consolidate()
        overflow slot that never became a _Request — a trace taken during
        saturation must show the rejected candidates, not just rejected
        singletons."""
        span = default_tracer().begin(
            "solver.request", family="binpack", backend=backend,
        )
        if span is not None:
            span.close(ok=False, rejected=True)

    def _slots(self) -> int:
        """The queue's depth in admission slots, which max_queue bounds
        (the caller holds _cond): a request is one slot, and so is a
        whole consolidate() batch (its members are contiguous and share
        one coalesce_id)."""
        slots, last = 0, None
        for request in self._queue:
            cid = request.coalesce_id
            if cid is None or cid != last:
                slots += 1
            last = cid
        return slots

    def _enqueue_one(self, request: _Request) -> None:
        """Admit one request to the bounded queue (raises
        SolverSaturated when full) and wake the worker."""
        self._begin_request_span(request)
        with self._cond:
            if self._slots() >= self.max_queue:
                self.stats.rejected += 1
                self._c_rejected.inc("-", "-")
                if request.span is not None:
                    request.span.close(ok=False, rejected=True)
                raise SolverSaturated(
                    f"solver queue full ({self.max_queue})"
                )
            self._ensure_worker()
            self._queue.append(request)
            self.stats.requests += 1
            self._c_requests.inc("-", "-")
            self._g_queue.set("-", "-", float(len(self._queue)))
            self._cond.notify_all()

    def solve(
        self,
        inputs: BinPackInputs,
        buckets: int = DEFAULT_BUCKETS,
        backend: Optional[str] = None,
        timeout: Optional[float] = None,
    ):
        """Synchronous solve through the service — the drop-in `solver`
        seam every caller already takes (any (inputs, buckets=...) ->
        BinPackOutputs callable; the outputs are host numpy arrays).
        On the CPU, saturation and (by default) deadline expiry degrade
        to the numpy backend inline, so a caller always gets an answer
        while the device path is sick; on the card both raise."""
        timeout = self.default_timeout_s if timeout is None else timeout
        try:
            future = self.submit(
                inputs, buckets=buckets, backend=backend, timeout=timeout
            )
        except SolverSaturated:
            if not self._numpy_ladder:
                raise
            logger().warning(
                "solver queue saturated; degrading one request to numpy"
            )
            return self._numpy_fallback(inputs, buckets)
        try:
            return future.result(timeout if timeout else None)
        except SolverTimeout:
            if self.on_timeout == "raise":
                raise
            logger().warning(
                "solve deadline expired; degrading one request to numpy"
            )
            return self._numpy_fallback(inputs, buckets)

    # -- consolidate family -------------------------------------------------

    def consolidate(
        self,
        inputs_list,
        buckets: int = DEFAULT_BUCKETS,
        backend: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> list:
        """Batched candidate evaluation for the consolidation planner:
        N masked bin-packs (one per drain candidate) submitted ATOMICALLY
        and answered as a list of host outputs in input order.

        The requests ride the normal pipeline (coalescing queue, shape
        ladder, the rung's dispatch) but carry a shared batch marker, so
        the worker drains the whole set past `max_batch`. On the torch
        rung same-bucket candidates ride ONE batched dispatch, and
        candidate-count jitter only moves along the batch ladder, so
        steady-state consolidation meets no new dispatch key. On the
        cuda rung the candidates are answered one after another, each
        one launch of each CUDA kernel (the fused kernel has no batched
        entry, as the reference's fused Mosaic kernel has none).

        The batch takes one slot of the bounded queue and is admitted or
        refused whole. On the CPU a refused batch is answered from numpy
        inline and an expired deadline degrades (or raises, per
        `on_timeout`) per candidate; on the card both raise, and the
        rest of the batch is abandoned."""
        if not inputs_list:
            return []
        if self._closed:
            raise RuntimeError("solver service is closed")
        self.stats.consolidate_calls += 1
        self.stats.consolidate_candidates += len(inputs_list)
        resolved = self._resolve_backend(backend)
        timeout = self.default_timeout_s if timeout is None else timeout
        requests = self._enqueue_batch(
            inputs_list, buckets, resolved, timeout
        )
        return self._gather_batch(requests, inputs_list, buckets, timeout)

    @staticmethod
    def _abandon(requests) -> None:
        """Nobody will wait on these batch members: the worker skips
        them instead of burning a dispatch for dropped results."""
        for request in requests:
            if request is not None:
                request.abandoned = True

    def _gather_batch(
        self, requests, inputs_list, buckets: int, timeout
    ) -> list:
        """Wait out a consolidate() batch in input order. A refused
        batch (its slots None) and expired candidates degrade to numpy
        on the CPU, per solve()'s semantics; on the card a refusal raises
        SolverSaturated before any wait and an expiry SolverTimeout."""
        if not self._numpy_ladder and any(r is None for r in requests):
            self._abandon(requests)
            raise SolverSaturated(
                f"solver queue full ({self.max_queue}) for a "
                f"{len(requests)}-candidate consolidation batch"
            )
        results = []
        for i, request in enumerate(requests):
            if request is None:
                logger().warning(
                    "solver queue saturated; degrading one consolidation "
                    "candidate to numpy"
                )
                results.append(
                    self._numpy_fallback(inputs_list[i], buckets)
                )
                continue
            try:
                results.append(
                    SolveFuture(request, self).result(
                        timeout if timeout else None
                    )
                )
            except SolverTimeout:
                if self.on_timeout == "raise":
                    self._abandon(requests[i + 1:])
                    raise
                logger().warning(
                    "consolidation candidate deadline expired; degrading "
                    "to numpy"
                )
                results.append(
                    self._numpy_fallback(inputs_list[i], buckets)
                )
        return results

    def _consolidate_key(self, inputs, buckets: int, resolved: str):
        """The dispatch key of one consolidate() candidate. The
        6th key element ("vmap", the reference's name) keeps these groups
        from mixing with plain solve() traffic: on the torch rung a
        consolidation batch never splits into pipeline chunks and never
        takes the resident singleton path. Fleet-scale candidates also
        ride the mesh ("vmap_shard" + extents, the shard route)."""
        if resolved == "cuda" and self.device_solver is None:
            if has_constraint_operands(inputs):
                # the planner folds taints, selectors and affinity into
                # pod_group_forbidden; the fused kernel has no constraint
                # entry, and a drain verdict is never served by the plain
                # program on the card
                raise ValueError(
                    "a consolidation candidate carries constraint "
                    "operands, which the cuda rung does not take"
                )
            self._ensure_kernels()
        extents = self._shard_extents(
            resolved,
            inputs.pod_requests.shape[0],
            inputs.group_allocatable.shape[0],
        )
        key = (
            bucket_shape(inputs), buckets, resolved, presence(inputs),
            constraint_shape(inputs),
        )
        if extents is None:
            return key + ("vmap",)
        self.stats.shard_requests += 1
        return key + ("vmap_shard", extents)

    def _enqueue_batch(
        self, inputs_list, buckets: int, resolved: str, timeout
    ) -> List[Optional[_Request]]:
        """Enqueue a consolidate() batch atomically under one lock hold
        (contiguous in the deque, shared coalesce_id). Keys (and any
        kernel build) resolve before the lock, so no submitter or worker
        waits on them.

        The batch takes ONE admission slot (_slots), as the worker drains
        it as one group past max_batch: it is admitted whole when the
        queue has a free slot, else refused whole, every slot coming back
        as None (answered from numpy on the CPU, raised on the card)."""
        now = self._clock()
        keys = [
            self._consolidate_key(inputs, buckets, resolved)
            for inputs in inputs_list
        ]
        requests: List[Optional[_Request]] = []
        with self._cond:
            if self._slots() >= self.max_queue:
                for _ in inputs_list:
                    self.stats.rejected += 1
                    self._c_rejected.inc("-", "-")
                    self._record_rejected_span(resolved)
                return [None] * len(inputs_list)
            self._coalesce_seq += 1
            cid = self._coalesce_seq
            for inputs, key in zip(inputs_list, keys):
                request = _Request(
                    inputs=inputs,
                    buckets=buckets,
                    backend=resolved,
                    key=key,
                    n_pods=inputs.pod_requests.shape[0],
                    n_groups=inputs.group_allocatable.shape[0],
                    deadline=(now + timeout) if timeout else None,
                    enqueued_at=now,
                    coalesce_id=cid,
                )
                self._begin_request_span(request)
                self._queue.append(request)
                self.stats.requests += 1
                self._c_requests.inc("-", "-")
                requests.append(request)
            self._ensure_worker()
            self._g_queue.set("-", "-", float(len(self._queue)))
            self._cond.notify_all()
        return requests

    def decide(self, inputs):
        """The HPA decision program through the service: same metrics
        surface and error accounting, no coalescing (the batch
        autoscaler already evaluates the whole fleet in one call). Runs
        the port's ops/decision.decide on the service's device; a fleet
        whose N x M cell count reaches shard_threshold rides the mesh
        (the fleet axis split over its shards), with a single-device
        retry on any mesh failure. Host operands (numpy fields) are
        answered as host numpy in one fetch; DecisionInputs already
        holding tensors keep tensors (_decide_dispatch). An injected
        `decider` gets the inputs as given."""
        self.stats.decide_calls += 1
        t0 = _time.perf_counter()
        try:
            with default_tracer().span("solver.decide"):
                out = self._decide_dispatch(inputs)
            # served by the in-process program, or across the gRPC split
            self._annotate_provenance(
                "grpc" if self.device_solver is not None else "torch",
                "sidecar" if self.device_solver is not None else "device",
            )
            return out
        except Exception:
            self.stats.decide_errors += 1
            raise
        finally:
            self._record_stage("decide", _time.perf_counter() - t0)

    def _decide_dispatch(self, inputs):
        """Operands already held as tensors keep tensors (moved to the
        service's device); host operands (numpy fields, a dict or the
        reference's dataclass) are uploaded and answered as host numpy,
        fetched in one copy — the BatchAutoscaler indexes the outputs row
        by row, which on card tensors would sync once per element."""
        if self._decider is not None:
            return self._decider(inputs)
        from karpenter_tpu_torch.ops import decision as D

        tensors = isinstance(inputs, D.DecisionInputs) and isinstance(
            inputs.metric_value, torch.Tensor
        )
        out = self._sharded_decide(inputs)
        if out is not None:
            return out if tensors else fetch(out)
        if tensors:
            return D.decide(inputs.to(self.device))
        return host_seam(D.decide, D.DecisionInputs, self.device)(inputs)

    def _sharded_decide(self, inputs):
        """The shard route of one fleet decide (tensors on the mesh's
        home device), or None: below threshold, or the mesh failed — a
        failure is counted in shard_fallbacks, trips the route like the
        bin-pack ladder's, and the caller retries single-device."""
        n = int(np.shape(_field_of(inputs, "spec_replicas"))[0])
        m = int(np.shape(_field_of(inputs, "metric_value"))[1])
        extents = self._shard_extents(self._family_backend(None), n, max(m, 1))
        if extents is None:
            return None
        from karpenter_tpu_torch.parallel.mesh import sharded_decide

        self.stats.shard_requests += 1
        try:
            out = sharded_decide(self._shard_mesh(), inputs)
        except Exception as error:  # noqa: BLE001 — shard-route failure
            self._note_shard_fallback(error, [], family="decide")
            return None
        self.stats.shard_dispatches += 1
        return out

    def _family_backend(self, backend: Optional[str]) -> str:
        """The rung a fleet-tick family runs: the service's resolution,
        with `cuda` meaning the family's tensor program on the card (no
        family has a hand-written kernel) and an injected device_solver
        (a remote bin-pack wire) leaving these families to numpy."""
        resolved = self._resolve_backend(backend)
        if self.device_solver is not None:
            return "numpy"
        return "torch" if resolved == "cuda" else resolved

    # -- forecast family ----------------------------------------------------

    def forecast(self, inputs, backend: Optional[str] = None,
                 timeout: Optional[float] = None):
        """Batched metric forecasting through the service: one
        ForecastInputs matrix of S series in (host arrays), one
        ForecastOutputs of host arrays out. Requests ride the coalescing
        queue: concurrent callers whose histories share a time-axis
        bucket are concatenated along the series axis and answered by
        ONE dispatch of forecast/models.forecast. On the CPU a full
        queue, an expired deadline, a device failure or a degraded FSM
        answers from the bit-identical numpy mirror (counted in
        fallback_total); on the card each raises. `forecast.predict` is
        the fault-injection point on the device path."""
        from karpenter_tpu_torch.forecast import models as M

        inputs = M.ForecastInputs.from_arrays(inputs)
        n_series = int(inputs.values.shape[0])
        self.stats.forecast_calls += 1
        self.stats.forecast_series += n_series
        if n_series == 0:
            empty = np.zeros(0, np.float32)
            return M.ForecastOutputs(
                point=empty, sigma2=empty.copy(),
                n_valid=np.zeros(0, np.int32),
            )
        if self._closed:
            raise RuntimeError("solver service is closed")
        timeout = self.default_timeout_s if timeout is None else timeout
        request = self._forecast_request(inputs, n_series, backend, timeout)
        try:
            self._enqueue_one(request)
        except SolverSaturated:
            if not self._numpy_ladder:
                raise
            logger().warning(
                "solver queue saturated; degrading one forecast to numpy"
            )
            return self._numpy_fallback(request.inputs, 0)
        try:
            return SolveFuture(request, self).result(
                timeout if timeout else None
            )
        except SolverTimeout:
            if self.on_timeout == "raise":
                raise
            logger().warning("forecast deadline expired; degrading to numpy")
            return self._numpy_fallback(request.inputs, 0)

    def _forecast_request(
        self, inputs, n_series: int, backend: Optional[str], timeout
    ) -> _Request:
        """One queue-ready forecast request, padded up the history-length
        ladder on the host."""
        from karpenter_tpu_torch.forecast import models as M

        resolved = self._family_backend(backend)
        now = self._clock()
        t_bucket = bucket_up(int(inputs.values.shape[1]), FORECAST_T_FLOOR)
        # fleet-scale forecasts split their SERIES axis over the mesh
        # (cells = series x history slots)
        extents = self._shard_extents(resolved, n_series, t_bucket)
        key = ("forecast", t_bucket, resolved)
        if extents is not None:
            key += ("shard", extents)
            self.stats.shard_requests += 1
        return _Request(
            inputs=M.pad_forecast_inputs(inputs, t_bucket),
            buckets=0,
            backend=resolved,
            key=key,
            n_pods=n_series,
            n_groups=0,
            deadline=(now + timeout) if timeout else None,
            enqueued_at=now,
        )

    def _forecast_group(self, key: tuple, live: List[_Request]) -> None:
        """One coalesced forecast dispatch: same-T-bucket requests are
        concatenated along the series axis, padded up the series ladder
        and answered by ONE program; results slice back per request.
        backend == "numpy" serves the mirror inline (the REQUESTED
        backend, not a degradation). Device failures raise to
        _dispatch_group, which feeds the FSM and answers the batch (from
        numpy on the CPU, with the error on the card)."""
        from karpenter_tpu_torch.forecast import models as M

        t_bucket, backend = key[1], key[2]
        # completes inline (forecast batches are small and latency-bound),
        # so in-flight bin-pack work drains first to keep completion ordered
        self._drain_inflight()
        if backend == "numpy":
            for request in live:
                t0 = _time.perf_counter()
                request.finish(result=M.forecast_numpy(request.inputs))
                self._record_stage("dispatch", _time.perf_counter() - t0)
            return
        mesh = self._shard_mesh_for(key)
        t0 = _time.perf_counter()
        sizes = [request.n_pods for request in live]
        s_bucket = bucket_up(sum(sizes), FORECAST_S_FLOOR)
        if mesh is not None:
            # the series bucket grows to the mesh's row extent (the
            # reference's padding); padding series are all-invalid
            s_bucket = pad_to_multiple(s_bucket, key[4][0])
        stacked = M.concat_forecast_inputs(
            [request.inputs for request in live], s_bucket
        )
        self._record_stage("pad", _time.perf_counter() - t0)
        cache_key = ("forecast", s_bucket, t_bucket, backend)
        if mesh is not None:
            cache_key += ("shard", key[4])
        fresh = self._count_key(cache_key)
        t0 = _time.perf_counter()
        with self._dispatch_span(
            "solver.dispatch.forecast" + (".shard" if mesh is not None else ""),
            live,
        ):
            with self._device_section(
                live, grace=COMPILE_GRACE_S if fresh else 0.0
            ):
                with default_tracer().span("solver.forecast"):
                    # the forecast-path fault-injection point: an error
                    # plan exercises the failure answer + FSM, a hang
                    # plan the watchdog drain
                    inject("forecast.predict")
                    if mesh is not None:
                        from karpenter_tpu_torch.parallel.mesh import (
                            sharded_forecast,
                        )

                        host = fetch(sharded_forecast(mesh, stacked))
                    else:
                        host = host_seam(
                            M.forecast, M.ForecastInputs, self.device
                        )(stacked)
        if self._stale():
            return  # the watchdog already answered these
        if fresh:
            self._note_compile(
                "forecast", cache_key, _time.perf_counter() - t0, live,
                extents=key[4] if mesh is not None else None,
            )
        self.stats.upload_bytes += sum(
            np.asarray(getattr(stacked, f.name)).nbytes
            for f in dataclasses.fields(stacked)
        )
        self._record_stage("dispatch", _time.perf_counter() - t0)
        self._count_dispatch()
        self.stats.forecast_dispatches += 1
        if mesh is not None:
            self.stats.shard_dispatches += 1
        t0 = _time.perf_counter()
        offset = 0
        for request, size in zip(live, sizes):
            self._finish_device(
                request, M.slice_forecast_outputs(host, offset, offset + size)
            )
            offset += size
        self._record_stage("scatter", _time.perf_counter() - t0)

    # -- preempt family -----------------------------------------------------

    def preempt(self, inputs, backend: Optional[str] = None,
                timeout: Optional[float] = None):
        """Fleet-wide placement-with-eviction through the service: one
        PreemptInputs problem (C candidate pods x N node columns x V
        victims; either package's dataclass or a dict of host arrays)
        in, one PreemptOutputs of host arrays out, ONE dispatch of
        ops/preempt.preempt_plan planning every candidate. Requests ride
        the coalescing queue on the preempt shape ladder; the cuda rung
        runs that PyTorch program on the service's device (there is no
        hand-written preempt kernel). On the CPU a full queue, an expired
        deadline, a device failure or a degraded FSM answers from the
        bit-identical numpy mirror; on the card each raises.
        `preempt.plan` is the fault-injection point on the device path."""
        from karpenter_tpu_torch.ops import preempt as PK

        inputs = PK.PreemptInputs.from_arrays(inputs)
        n_candidates = int(inputs.pod_requests.shape[0])
        n_victims = int(inputs.victim_requests.shape[0])
        self.stats.preempt_calls += 1
        self.stats.preempt_candidates += n_candidates
        if n_candidates == 0:
            return PK.PreemptOutputs(
                chosen_node=np.zeros(0, np.int32),
                evict_count=np.zeros(0, np.int32),
                evict_mask=np.zeros((0, n_victims), bool),
                unplaceable=np.int32(0),
            )
        if n_victims > PK.MAX_VICTIMS:
            raise ValueError(
                f"preempt solve supports at most {PK.MAX_VICTIMS} victims, "
                f"got {n_victims}"
            )
        if self._closed:
            raise RuntimeError("solver service is closed")
        timeout = self.default_timeout_s if timeout is None else timeout
        now = self._clock()
        resolved = self._family_backend(backend)
        # fleet-scale eviction storms split their CANDIDATE axis over the
        # mesh (cells = candidates x victims)
        extents = self._shard_extents(
            resolved, n_candidates, max(n_victims, 1)
        )
        key = ("preempt", preempt_bucket_shape(inputs), resolved)
        if extents is not None:
            key += ("shard", extents)
            self.stats.shard_requests += 1
        request = _Request(
            inputs=inputs,
            buckets=0,
            backend=resolved,
            key=key,
            n_pods=n_candidates,
            n_groups=n_victims,
            deadline=(now + timeout) if timeout else None,
            enqueued_at=now,
        )
        try:
            self._enqueue_one(request)
        except SolverSaturated:
            if not self._numpy_ladder:
                raise
            logger().warning(
                "solver queue saturated; degrading one eviction plan to numpy"
            )
            return self._numpy_fallback(inputs, 0)
        try:
            return SolveFuture(request, self).result(
                timeout if timeout else None
            )
        except SolverTimeout:
            if self.on_timeout == "raise":
                raise
            logger().warning("eviction-plan deadline expired; degrading to numpy")
            return self._numpy_fallback(inputs, 0)

    def _preempt_group(self, key: tuple, live: List[_Request]) -> None:
        """Eviction-planning dispatches: each request is already a
        whole-fleet batched problem (the candidate axis IS the batch), so
        same-key requests dispatch one after another, each padded up the
        shape ladder and fetched in one copy. Completes inline, so
        in-flight bin-pack work drains first. Device failures raise to
        _dispatch_group, which feeds the FSM and answers the request
        (from numpy on the CPU, with the error on the card)."""
        from karpenter_tpu_torch.ops import preempt as PK

        shape, backend = key[1], key[2]
        self._drain_inflight()
        if backend == "numpy":
            # the REQUESTED backend, not a degradation: no padding
            for request in live:
                t0 = _time.perf_counter()
                request.finish(result=PK.preempt_numpy(request.inputs))
                self._record_stage("dispatch", _time.perf_counter() - t0)
            return
        mesh = self._shard_mesh_for(key)
        cache_key = ("preempt", shape, backend)
        if mesh is not None:
            # the CANDIDATE axis grows to the mesh's row extent; padding
            # candidates are invalid and forbidden everywhere
            c, n, r, v = shape
            shape = (pad_to_multiple(c, key[4][0]), n, r, v)
            cache_key = ("preempt", shape, backend, "shard", key[4])
        fresh = self._count_key(cache_key)
        grace = COMPILE_GRACE_S if fresh else 0.0
        for request in live:
            t0 = _time.perf_counter()
            padded = pad_preempt_inputs(request.inputs, shape)
            self._record_stage("pad", _time.perf_counter() - t0)
            t0 = _time.perf_counter()
            with self._dispatch_span(
                "solver.dispatch.preempt"
                + (".shard" if mesh is not None else ""),
                [request],
            ):
                with self._device_section([request], grace=grace):
                    with default_tracer().span("solver.preempt"):
                        # the preempt-path fault-injection point: an
                        # error plan exercises the failure answer + FSM,
                        # a hang plan the watchdog drain
                        inject("preempt.plan")
                        if mesh is not None:
                            from karpenter_tpu_torch.parallel.mesh import (
                                sharded_preempt,
                            )

                            host = fetch(sharded_preempt(mesh, padded))
                        else:
                            host = fetch(
                                PK.preempt_plan(padded, self.device)
                            )
            grace = 0.0  # only the first dispatch of the group is a first launch
            if self._stale():
                return  # the watchdog already answered these
            if fresh:
                fresh = False  # only the first dispatch paid the first launch
                self._note_compile(
                    "preempt", cache_key, _time.perf_counter() - t0,
                    [request], extents=key[4] if mesh is not None else None,
                )
            self.stats.upload_bytes += sum(
                np.asarray(getattr(padded, f.name)).nbytes
                for f in dataclasses.fields(padded)
            )
            self._record_stage("dispatch", _time.perf_counter() - t0)
            self._count_dispatch()
            self.stats.preempt_dispatches += 1
            if mesh is not None:
                self.stats.shard_dispatches += 1
            t0 = _time.perf_counter()
            self._finish_device(request, crop_preempt_outputs(
                host, request.n_pods, request.n_groups
            ))
            self._record_stage("scatter", _time.perf_counter() - t0)

    # -- cost family --------------------------------------------------------

    def cost(self, inputs, backend: Optional[str] = None):
        """The cost/SLO refinement through the service: one CostInputs
        matrix for the whole fleet in, one CostOutputs of host arrays
        out, ONE dispatch of ops/cost.cost_decide — synchronous like
        decide(). The refinement is advisory, so: the numpy mirror
        serves only as the REQUESTED backend; a device failure counts
        toward the FSM and PROPAGATES (the CostEngine goes cost-blind
        this tick); a DEGRADED FSM raises CostUnavailable without
        touching the device (probes ride the normal recovery path). The
        same on the card and the CPU. `cost.score` is the
        fault-injection point."""
        from karpenter_tpu_torch.ops import cost as C

        self.stats.cost_calls += 1
        resolved = self._family_backend(backend)
        t0 = _time.perf_counter()
        try:
            if resolved == "numpy":
                with default_tracer().span("solver.cost", backend="numpy"):
                    out = C.cost_numpy(C.CostInputs.from_arrays(inputs))
                self._annotate_provenance("numpy", "numpy")
                return out
            if not self._device_allowed():
                raise CostUnavailable(
                    "solver backend degraded; scaling cost-blind until "
                    "a probe recovers the device path"
                )
            try:
                with default_tracer().span("solver.cost", backend=resolved):
                    inject("cost.score")
                    out = host_seam(
                        C.cost_decide, C.CostInputs, self.device
                    )(inputs)
            except Exception:
                self._record_device_failure()
                raise
            self._record_device_success()
            self.stats.cost_dispatches += 1
            self._count_dispatch()
            self._annotate_provenance(resolved, "device")
            return out
        except Exception:
            self.stats.cost_errors += 1
            raise
        finally:
            self._record_stage("cost", _time.perf_counter() - t0)

    # -- poolgroup family ---------------------------------------------------

    def poolgroup(self, inputs, backend: Optional[str] = None):
        """The joint pool-group allocation through the service: every
        PoolGroup's joint candidate ladder scored in ONE dispatch of
        ops/poolgroup.poolgroup_decide, answered as host arrays. A
        numpy-resolved backend serves the full JOINT mirror (the
        REQUESTED backend). On the CPU the ladder is the reference's:
        a device failure or a degraded FSM serves the INDEPENDENT
        per-pool ladders (poolgroup_numpy(enforce=False): ratios and the
        shared budget go advisory for the tick). On the card a device
        failure raises, and a degraded FSM raises SolverDeviceError.
        `poolgroup.solve` is the fault-injection point."""
        from karpenter_tpu_torch.ops import poolgroup as PG

        self.stats.poolgroup_calls += 1
        resolved = self._family_backend(backend)
        t0 = _time.perf_counter()
        try:
            if resolved == "numpy":
                with default_tracer().span(
                    "solver.poolgroup", backend="numpy"
                ):
                    out = PG.poolgroup_numpy(PG.PoolGroupInputs.from_arrays(inputs))
                self._annotate_provenance("numpy", "numpy")
                return out
            if self._device_allowed():
                try:
                    with default_tracer().span(
                        "solver.poolgroup", backend=resolved
                    ):
                        inject("poolgroup.solve")
                        out = host_seam(
                            PG.poolgroup_decide, PG.PoolGroupInputs,
                            self.device,
                        )(inputs)
                    self._record_device_success()
                    self.stats.poolgroup_dispatches += 1
                    self._count_dispatch()
                    self._annotate_provenance(resolved, "device")
                    return out
                except Exception as error:  # noqa: BLE001 — the ladder
                    self._record_device_failure()
                    if not self._numpy_ladder:
                        raise
                    logger().warning(
                        "joint poolgroup dispatch failed (%s: %s); "
                        "serving INDEPENDENT per-pool ladders this tick "
                        "(ratios advisory)",
                        type(error).__name__, error,
                    )
            elif not self._numpy_ladder:
                raise SolverDeviceError(
                    "solver backend degraded: no device attempt until the "
                    "next probe"
                )
            with default_tracer().span(
                "solver.poolgroup", backend="independent"
            ):
                self.stats.poolgroup_independent_serves += 1
                out = PG.poolgroup_numpy(
                    PG.PoolGroupInputs.from_arrays(inputs), enforce=False
                )
            self._annotate_provenance("numpy", "numpy")
            return out
        except Exception:
            self.stats.poolgroup_errors += 1
            raise
        finally:
            self._record_stage("poolgroup", _time.perf_counter() - t0)

    # -- simlab families ----------------------------------------------------

    def sim_step(self, inputs, backend: Optional[str] = None):
        """One simulated-cluster tick through the service (ops/simstep.py):
        elementwise over any leading batch shape, so a BatchedSimEnv's N
        clusters advance as ONE dispatch. Host operands in, host numpy
        out (SimStepOutputs)."""
        from karpenter_tpu_torch.ops import simstep as SK

        return self._sim_dispatch(
            "solver.sim_step", SK.sim_step, SK.SimStepInputs,
            SK.sim_step_numpy, inputs, backend,
        )

    def sim_rollout(self, inputs, backend: Optional[str] = None):
        """A whole simulated episode (the in-program tuned policy) through
        the service: batched trails [B, T, R] ride one program over the
        cluster axis — N clusters x T ticks in one dispatch."""
        from karpenter_tpu_torch.ops import simstep as SK

        return self._sim_dispatch(
            "solver.sim_rollout", SK.sim_rollout, SK.SimRolloutInputs,
            SK.sim_rollout_numpy, inputs, backend,
        )

    def _sim_dispatch(self, span, program, in_cls, numpy_fn, inputs, backend):
        """The simlab family's one door: tracing, stats, backend
        resolution (`cuda` = the tensor program on the card) and the
        failure policy of the module docstring. `simlab.step` is the
        fault-injection point."""
        self.stats.sim_calls += 1
        resolved = self._family_backend(backend)
        t0 = _time.perf_counter()
        try:
            if resolved != "numpy":
                if self._device_allowed():
                    try:
                        with default_tracer().span(span, backend=resolved):
                            inject("simlab.step")
                            out = host_seam(
                                program, in_cls, self.device
                            )(inputs)
                        self._record_device_success()
                        self.stats.sim_dispatches += 1
                        self._count_dispatch()
                        return out
                    except Exception as error:  # noqa: BLE001 — the ladder
                        self._record_device_failure()
                        if not self._numpy_ladder:
                            raise
                        logger().warning(
                            "sim device dispatch failed (%s: %s); serving "
                            "the bit-identical numpy mirror",
                            type(error).__name__, error,
                        )
                elif not self._numpy_ladder:
                    raise SolverDeviceError(
                        "solver backend degraded: no device attempt until "
                        "the next probe"
                    )
            with default_tracer().span(span, backend="numpy"):
                self.stats.sim_mirror_serves += 1
                return numpy_fn(inputs)
        finally:
            self._record_stage("sim", _time.perf_counter() - t0)

    # -- fused tick family --------------------------------------------------

    def fused_tick(self, inputs, backend: Optional[str] = None):
        """The fused steady-state tick through the service: forecast ->
        decide -> cost -> pool groups as ONE program
        (ops/fusedtick.FusedTickProgram: one captured CUDA graph per
        shape class on the card), host operands uploaded into its static
        buffers and every output leaf fetched in one copy.

        The forecast group is padded up the forecast family's T and S
        ladders ONCE, at the door, so every rung consumes the same
        operands and a steady fleet keeps one shape class. On the CPU
        the ladder is the reference's: a fused failure falls back to the
        chained per-stage path, a chained failure to the numpy floor,
        and a degraded FSM to the floor. On the card a failure of the
        program raises (counted by the FSM) and a degraded FSM raises
        SolverDeviceError: no chained or numpy serve hides a broken
        graph. `fused.tick` is the fault-injection point.

        One `solver.fused_tick` span covers a call: its child
        `solver.fused.pad` is the door, then the rung that answers opens
        its own (the program's `solver.fused.upload`, `.replay` and
        `.fetch`; `solver.fused.chained`; `solver.fused.numpy`). Stages:
        "fused_pad" (the door), "fused" (the rungs), and the program's
        "fused_upload", "fused_replay", "fused_fetch" and, on the card,
        "fused_device" (ops/fusedtick.FusedTickProgram)."""
        from karpenter_tpu_torch.forecast import models as M
        from karpenter_tpu_torch.ops import fusedtick as FT

        self.stats.fused_calls += 1
        resolved = self._family_backend(backend)
        tracer = default_tracer()
        with tracer.span("solver.fused_tick", backend=resolved):
            t_door = _time.perf_counter()
            with tracer.span("solver.fused.pad"):
                inputs = FT.FusedTickInputs.from_arrays(inputs)
                t_bucket = s_bucket = n_series = 0
                if inputs.forecast is not None:
                    n_series, t = inputs.forecast.values.shape
                    t_bucket = bucket_up(int(t), FORECAST_T_FLOOR)
                    s_bucket = bucket_up(int(n_series), FORECAST_S_FLOOR)
                    inputs = dataclasses.replace(
                        inputs,
                        forecast=M.pad_forecast_inputs(
                            inputs.forecast, t_bucket),
                    )
                    inputs = FT.pad_series(inputs, s_bucket)
            n = int(inputs.decision.spec_replicas.shape[0])
            m = int(inputs.decision.metric_value.shape[1])
            t0 = _time.perf_counter()
            self._record_stage("fused_pad", t0 - t_door)
            try:
                if resolved != "numpy":
                    if self._device_allowed():
                        out = self._fused_device(
                            inputs, resolved, n, m, t_bucket, s_bucket
                        )
                        if out is not None:
                            return self._fused_slice(out, n_series)
                    elif not self._numpy_ladder:
                        raise SolverDeviceError(
                            "solver backend degraded: no device attempt "
                            "until the next probe"
                        )
                with tracer.span("solver.fused.numpy"):
                    out = FT.fused_tick_numpy(inputs)
                if resolved != "numpy":
                    self.stats.fused_mirror_serves += 1
                self._annotate_provenance("numpy", "numpy")
                return self._fused_slice(out, n_series)
            finally:
                self._record_stage("fused", _time.perf_counter() - t0)

    def fused_program(self):
        """The service's FusedTickProgram (built on first use); its
        `captures` and `replays` count the graphs."""
        if self._fused_program is None:
            from karpenter_tpu_torch.ops import fusedtick as FT

            self._fused_program = FT.FusedTickProgram(self.device)
        return self._fused_program

    def _fused_device(
        self, inputs, resolved: str, n: int, m: int,
        t_bucket: int, s_bucket: int,
    ):
        """The fused rung, and on the CPU the chained rung after it;
        None = both failed on the CPU (the caller serves the numpy
        floor). On the card a failure raises."""
        from karpenter_tpu_torch.ops import fusedtick as FT

        key = (
            "fused", n, m, t_bucket, s_bucket,
            inputs.forecast is not None,
            inputs.slo_valid is not None,
            inputs.poolgroup is not None,
            resolved,
        )
        try:
            fresh = self._count_key(key)
            program = self.fused_program()
            captures = program.captures
            t0 = _time.perf_counter()
            # the fused-path fault-injection point
            inject("fused.tick")
            out = program(inputs, host=True, record=self._record_stage)
            if fresh or program.captures != captures:
                # a new key's first dispatch, or a CUDA-graph capture
                self._note_compile("fused", key, _time.perf_counter() - t0)
            self._record_device_success()
            self.stats.fused_dispatches += 1
            self._count_dispatch()
            self._annotate_provenance(resolved, "device")
            return out
        except Exception as error:  # noqa: BLE001 — the ladder
            self._record_device_failure()
            if not self._numpy_ladder:
                raise
            logger().warning(
                "fused tick dispatch failed (%s: %s); falling back to the "
                "chained per-stage path", type(error).__name__, error,
            )
        try:
            with default_tracer().span("solver.fused.chained"):
                out = FT.fused_tick_chained(inputs, device=self.device)
            # a degraded serve: stage dispatches are counted (the
            # dispatches-per-tick gauge must show the real program
            # count) but the FSM keeps counting fused failures
            self.stats.fused_chained_serves += 1
            for _ in range(FT.programs(inputs)):
                self._count_dispatch()
            self._annotate_provenance("torch", "device")
            return out
        except Exception as error:  # noqa: BLE001 — the ladder
            self._record_device_failure()
            logger().warning(
                "chained fused-tick fallback failed (%s: %s); serving the "
                "bit-identical numpy floor", type(error).__name__, error,
            )
            return None

    @staticmethod
    def _fused_slice(out, n_series: int):
        """Slice the forecast outputs back to the caller's S (padding
        series are service-internal, exactly like the queue family)."""
        if out.forecast is None:
            return out
        from karpenter_tpu_torch.forecast import models as M

        return dataclasses.replace(
            out,
            forecast=M.slice_forecast_outputs(out.forecast, 0, n_series),
        )

    def _annotate_provenance(self, backend: str, rung: str) -> None:
        """Provenance slice (observability/provenance.py): stamp the
        backend + degradation rung that actually served onto the
        CURRENT ledger batch — only for batches whose owner opted into
        service-side stamping (the BatchAutoscaler flow). One attribute
        read when the ledger is off."""
        from karpenter_tpu_torch.observability import default_ledger

        ledger = default_ledger()
        if not ledger.enabled:
            return
        batch = ledger.current()
        if batch is not None and batch.autosolver:
            batch.annotate(solver_backend=backend, solver_rung=rung)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        worker = self._worker
        if worker is not None:
            worker.join(timeout=5.0)
            self._worker = None
        watchdog = self._watchdog
        if watchdog is not None:
            watchdog.join(timeout=2.0)
            self._watchdog = None

    # -- backend health FSM + watchdog ------------------------------------

    def backend_health(self) -> str:
        with self._health_lock:
            return self._health

    def _device_allowed(self) -> bool:
        """Gate one batch's device attempt through the FSM: always in
        HEALTHY; in DEGRADED only the periodic probe — everything else
        short-circuits (_answer_failed) without billing a failed
        dispatch."""
        with self._health_lock:
            if self._health == HEALTHY:
                return True
            now = self._clock()
            if now >= self._next_probe:
                # this dispatch IS the recovery probe; schedule the next
                # one now so concurrent groups don't all probe at once
                self._next_probe = now + self.health_probe_interval_s
                self.stats.fsm_probes += 1
                self._c_probes.inc("-", "-")
                return True
            self.stats.fsm_short_circuits += 1
            return False

    def _record_device_failure(self, requests: List[_Request] = ()) -> bool:
        # the degradation ladder discards residency cleanly: after ANY
        # device-path failure the resident buffers are suspect, so the
        # next healthy dispatch re-establishes them from a full upload
        self._resident.drop_all()
        with self._health_lock:
            self.stats.device_failures += 1
            self._consec_device_failures += 1
            tripped = (
                self._health == HEALTHY
                and self._consec_device_failures
                >= self.health_failure_threshold
            )
            if tripped:
                self._health = DEGRADED
                self._next_probe = (
                    self._clock() + self.health_probe_interval_s
                )
                self.stats.fsm_trips += 1
                self._c_trips.inc("-", "-")
                self._g_backend_state.set("-", "-", 1.0)
        if tripped:
            logger().warning(
                "solver backend DEGRADED after %d consecutive device "
                "failures; %s, probing recovery every %.1fs",
                self._consec_device_failures,
                "serving from numpy" if self._numpy_ladder
                else "raising SolverDeviceError",
                self.health_probe_interval_s,
            )
            # post-mortem surface: WHICH reconcile traces the trip
            # degraded, not just that it happened
            default_flight_recorder().record(
                "fsm_trip",
                trace_ids=self._trace_ids(requests),
                subsystem="solver",
                consecutive_failures=self._consec_device_failures,
                requests=len(requests),
            )
        return tripped

    @staticmethod
    def _trace_ids(requests: List[_Request]) -> List[str]:
        """Distinct trace ids of the requests a degradation touched
        (insertion-ordered, deduped)."""
        return list(dict.fromkeys(
            tid for r in requests
            if (tid := r.trace_id()) is not None
        ))

    def _record_device_success(self) -> None:
        with self._health_lock:
            self._consec_device_failures = 0
            recovered = self._health == DEGRADED
            if recovered:
                self._health = HEALTHY
                self.stats.fsm_recoveries += 1
                self._c_recoveries.inc("-", "-")
                self._g_backend_state.set("-", "-", 0.0)
        if recovered:
            logger().info(
                "solver backend recovered; device path re-enabled"
            )

    def _stale(self) -> bool:
        """True on a worker thread superseded by a watchdog restart: its
        late results are discarded (the watchdog already answered its
        requests)."""
        gen = getattr(self._tls, "gen", None)
        return gen is not None and gen != self._worker_gen

    @contextlib.contextmanager
    def _device_section(self, requests: List[_Request], grace: float = 0.0):
        """Mark the worker busy inside a device call — the window the
        watchdog supervises. A hang here never raises, so supervision
        must come from outside the thread. `grace` shifts the busy mark
        forward (a dispatch key's first launch gets COMPILE_GRACE_S)."""
        with self._cond:
            self._busy_since = self._clock() + grace
            self._busy_requests = list(requests)
        try:
            yield
        finally:
            with self._cond:
                if not self._stale():  # a restart already reset these
                    self._busy_since = None
                    self._busy_requests = []

    def _watchdog_loop(self) -> None:
        poll = max(0.05, self.watchdog_timeout_s / 4.0)
        while not self._closed:
            _time.sleep(poll)
            self._watchdog_check()

    def _watchdog_check(self) -> None:
        """One supervision pass: if the worker has been inside a device
        call longer than watchdog_timeout_s, supersede it (generation
        bump + fresh thread) and answer every request it held — the
        stuck batch AND the pipelined in-flight ones (_answer_failed)."""
        stuck: List[_Request] = []
        with self._cond:
            busy = self._busy_since
            if busy is None or (
                self._clock() - busy <= self.watchdog_timeout_s
            ):
                return
            # everything the superseded worker holds: the stuck device
            # batch, pipelined in-flight batches, AND the not-yet-
            # dispatched groups of its current batch (already popped
            # from the queue — they live nowhere else). Dedup by
            # identity: a request can appear in more than one list.
            stuck.extend(self._busy_requests)
            for _out, live, _t, _done in self._inflight:
                stuck.extend(live)
            stuck.extend(self._current_batch)
            self._inflight.clear()
            self._busy_since = None
            self._busy_requests = []
            self._current_batch = []
            self.stats.watchdog_restarts += 1
            self._c_watchdog.inc("-", "-")
            if not self._closed:
                self._spawn_worker()
        stuck = list({id(r): r for r in stuck}.values())
        logger().warning(
            "solver worker hung in a device call > %.1fs; restarted the "
            "worker and answering %d request(s) %s",
            self.watchdog_timeout_s, len(stuck),
            "from numpy" if self._numpy_ladder else "with an error",
        )
        recorder = default_flight_recorder()
        # one incident, one dump: when the hang also trips the FSM, the
        # fsm_trip auto-dump lands milliseconds later with THIS event
        # already in the ring
        recorder.record(
            "watchdog_restart",
            trace_ids=self._trace_ids(stuck),
            subsystem="solver",
            requests=len(stuck),
            auto_dump=False,
        )
        tripped = self._record_device_failure(stuck)  # hang counts toward trip
        if not tripped:
            recorder.maybe_auto_dump("watchdog_restart")
        self._answer_failed(stuck, SolverDeviceError(
            f"solver worker hung in a device call > "
            f"{self.watchdog_timeout_s}s"
        ))

    # -- worker -----------------------------------------------------------

    def _spawn_worker(self) -> None:
        # called under self._cond
        self._worker_gen += 1
        self._worker = threading.Thread(
            target=self._run, args=(self._worker_gen,),
            name="solver-service", daemon=True,
        )
        self._worker.start()

    def _ensure_worker(self) -> None:
        # called under self._cond
        if self._worker is None or not self._worker.is_alive():
            self._spawn_worker()
        if self.watchdog_timeout_s > 0 and (
            self._watchdog is None or not self._watchdog.is_alive()
        ):
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="solver-watchdog",
                daemon=True,
            )
            self._watchdog.start()

    def _run(self, gen: Optional[int] = None) -> None:
        self._tls.gen = gen
        if self.device.type == "cuda":
            # a fresh thread starts on the process's current device;
            # every launch of this worker belongs on the service's
            torch.cuda.set_device(self.device)
        tracer = default_tracer()
        while not self._stale():
            # a turn of the loop is a profiler range, never in the ring:
            # a capture names the worker's time between its spans by it
            with tracer.range("solver.worker"):
                if self._inflight:
                    # a dispatch is computing on device: gather the NEXT
                    # batch without blocking — if nothing is queued, the
                    # useful work left is fetching the in-flight results
                    batch = self._collect(block=False)
                    if batch is None:
                        self._drain_inflight()
                        return
                    if not batch:
                        self._drain_one()
                        continue
                else:
                    batch = self._collect()
                    if batch is None:
                        self._drain_inflight()
                        return
                with self._cond:
                    self._current_batch = list(batch)
                groups: Dict[tuple, List[_Request]] = {}
                for request in batch:
                    groups.setdefault(request.key, []).append(request)
                # lone = this batch is one compatibility group with nothing
                # else in flight to overlap — the shape the pipeline
                # chunk-split exists for
                for key, requests in groups.items():
                    self._dispatch_group(
                        key, requests, lone=len(groups) == 1
                    )
                with self._cond:
                    if not self._stale():  # a restart already drained it
                        self._current_batch = []
                if not self._queue:
                    # nothing else waiting: complete in-flight work now
                    # rather than holding a lone batch's results hostage to
                    # traffic that may never come
                    self._drain_inflight()
                with tracer.trace("solver.gauges"):
                    self.publish_gauges()

    def _collect(self, block: bool = True) -> Optional[List[_Request]]:
        """Gather one batch: block for the first request (block=True),
        then hold the ADAPTIVE coalescing window open, gathering up to
        max_batch requests. The window is 0 — dispatch immediately —
        when the queue was empty behind the first request and recent
        batches were singletons; it widens to window_s while traffic is
        concurrent. The time blocked, and in the window, is the root
        span solver.wait (a wait begun before a profiler starts has no
        range in its capture). None = closed+drained; [] = block=False
        and idle."""
        tracer = default_tracer()
        with self._cond:
            if block and not self._queue and not self._closed:
                with tracer.trace("solver.wait"):
                    while not self._queue and not self._closed:
                        self._cond.wait()
            if not self._queue:
                return None if self._closed else []
            batch = [self._queue.popleft()]
            backlog = len(self._queue)
        window = self._effective_window(backlog)
        self._window_now_s = window
        if window > 0:
            with tracer.trace("solver.wait", window_s=window):
                self._gather_window(batch, window)
        else:
            self.stats.immediate_dispatches += 1
            with self._cond:
                while self._queue and len(batch) < self.max_batch:
                    batch.append(self._queue.popleft())
        with self._cond:
            self._drain_batch_tail(batch)
            self._g_queue.set("-", "-", float(len(self._queue)))
        # worker-only EWMA of observed concurrency: decays back to 1 a
        # few idle batches after a burst, so steady singleton traffic
        # keeps dispatching immediately
        self._load = (
            (1 - _LOAD_ALPHA) * self._load + _LOAD_ALPHA * len(batch)
        )
        return batch

    def _gather_window(self, batch: List[_Request], window: float) -> None:
        """Hold the coalescing window open, folding arrivals into the
        batch until it fills or the window closes."""
        window_end = self._clock() + window
        while len(batch) < self.max_batch:
            remaining = window_end - self._clock()
            if remaining <= 0:
                return
            with self._cond:
                if not self._queue:
                    self._cond.wait(timeout=remaining)
                while self._queue and len(batch) < self.max_batch:
                    batch.append(self._queue.popleft())

    def _effective_window(self, backlog: int) -> float:
        """The gather window for this batch: 0 (dispatch now) on an idle
        queue, window_s while concurrency is observed — either directly
        (requests already queued behind the head) or recently (the
        batch-size EWMA is still above the idle threshold)."""
        if not self.adaptive_window:
            return self.window_s
        if backlog > 0 or self._load >= _LOAD_IDLE:
            return self.window_s
        return 0.0

    def _drain_batch_tail(self, batch: List[_Request]) -> None:
        """consolidate() batches are enqueued atomically (contiguous in
        the deque) and must ride one dispatch: keep draining past
        max_batch while the queue head continues a batch already
        partially collected. Called under self._cond."""
        taken = {
            r.coalesce_id for r in batch if r.coalesce_id is not None
        }
        while (
            self._queue
            and self._queue[0].coalesce_id is not None
            and self._queue[0].coalesce_id in taken
        ):
            batch.append(self._queue.popleft())

    def _filter_live(self, requests: List[_Request]) -> List[_Request]:
        """Drop abandoned and queue-expired requests; the survivors are
        the batch that actually dispatches."""
        now = self._clock()
        live: List[_Request] = []
        for request in requests:
            if request.abandoned:
                # caller already gave up (counted there) — but the
                # caller-side timeout never calls finish(), so close
                # the trace span HERE
                if request.span is not None:
                    request.span.close(ok=False, abandoned=True)
                continue
            if request.deadline is not None and now > request.deadline:
                self._on_expired(request)
                request.finish(
                    error=SolverTimeout("deadline expired in queue")
                )
                continue
            self._record_stage("queue_wait", now - request.enqueued_at)
            live.append(request)
        return live

    @staticmethod
    def _shard_strategy(key: tuple) -> Optional[str]:
        """The shard marker of a request key, or None for a single-device
        key. Sharded bin-pack keys: (shape, buckets, backend, presence,
        cshape, "shard"|"vmap_shard", extents); sharded forecast and
        preempt keys: ("forecast"|"preempt", shape-ish, backend, "shard",
        extents)."""
        if key[0] in ("forecast", "preempt"):
            return "shard" if len(key) > 3 and key[3] == "shard" else None
        if len(key) > 6 and key[5] in ("shard", "vmap_shard"):
            return key[5]
        return None

    @staticmethod
    def _single_device_key(key: tuple) -> tuple:
        """The single-device key a sharded group retries on: the same
        shape, buckets, backend and presence, the mesh marker stripped
        ("vmap_shard" keeps the consolidation batch's "vmap")."""
        if key[0] in ("forecast", "preempt"):
            return key[:3]
        if key[5] == "vmap_shard":
            return key[:5] + ("vmap",)
        return key[:5]

    def _shard_mesh_for(self, key: tuple):
        """The mesh a group's key routes it onto, None for a
        single-device key; raises when a sharded key finds no mesh."""
        if self._shard_strategy(key) is None:
            return None
        mesh = self._shard_mesh()
        if mesh is None:
            raise RuntimeError("shard mesh unavailable for a shard-routed batch")
        return mesh

    def _note_shard_fallback(self, error, live, **fields) -> None:
        """Count, log and record a shard-route failure, and stop routing
        new traffic to the mesh (reset_caches re-arms it)."""
        self.stats.shard_fallbacks += 1
        self._shard_broken = True
        logger().warning(
            "sharded dispatch failed (%s: %s); retrying %d request(s) on "
            "the single-device path and disabling the shard route",
            type(error).__name__, error, max(len(live), 1),
        )
        default_flight_recorder().record(
            "shard_fallback",
            trace_ids=self._trace_ids(live),
            subsystem="solver",
            error=type(error).__name__,
            requests=len(live),
            **fields,
        )

    def _retry_unsharded(
        self, key: tuple, live: List[_Request], error: BaseException
    ) -> Optional[BaseException]:
        """The shard rung of the ladder: shard -> single-device on the
        same rung BEFORE any other answer — the mesh failing is not the
        device failing, so the same program re-runs unpartitioned (on the
        card, the card's kernels). Returns None on success, else the
        error the caller answers with."""
        self._note_shard_fallback(error, live)
        pending = [r for r in live if not r.event.is_set()]
        try:
            self._solve_group(self._single_device_key(key), pending)
            return None
        except Exception as single_error:  # noqa: BLE001
            if not self._stale():
                self._record_device_failure(pending)
            return single_error

    def _dispatch_group(
        self, key: tuple, requests: List[_Request], lone: bool = False
    ) -> None:
        live = self._filter_live(requests)
        if not live:
            return
        self.stats.last_coalesce_factor = len(live)
        self.stats.coalesced_batches += len(live) > 1
        self._g_coalesce.set("-", "-", float(len(live)))
        self._h_coalesce.observe("-", "-", float(len(live)))
        device_path = key[2] != "numpy"
        if device_path and not self._device_allowed():
            # FSM degraded, not this window's probe: answer the whole
            # batch without attempting the sick device
            self._answer_failed(live, SolverDeviceError(
                "solver backend degraded: no device attempt until the "
                "next probe"
            ))
            return
        try:
            self._solve_group(key, live, lone=lone)
            return
        except Exception as exc:  # noqa: BLE001 — device failure path
            error: BaseException = exc
            if device_path and not self._stale():
                self._record_device_failure(live)
        if self._shard_strategy(key) is not None and not self._stale():
            error = self._retry_unsharded(key, live, error)
            if error is None:
                return
        logger().warning(
            "solver device path failed (%s: %s); answering %d "
            "request(s) %s",
            type(error).__name__, error, len(live),
            "from numpy" if self._numpy_ladder else "with the error",
        )
        self._answer_failed(live, error)

    def _dispatch_span(self, name: str, live: List[_Request], **args):
        """The coalesced dispatch span (observability.tracing): opened
        on the worker thread, parented into the FIRST rider's trace for
        correlation, and LINKING every request span that rode the
        dispatch."""
        tracer = default_tracer()
        if not tracer.enabled:
            return tracer.span(name)  # the shared no-op span
        spans = [r.span for r in live if r.span is not None]
        return tracer.span(
            name,
            parent=spans[0] if spans else None,
            links=spans,
            n_requests=len(live),
            **args,
        )

    def _finish_device(self, request: _Request, result) -> None:
        """Answer one request from the device path. The FSM learns of the
        success BEFORE the caller is woken, so a caller that reads
        backend_health() after its answer sees the state that answer
        left (the reference records it after the whole group). A stale
        worker's late answer records nothing: the watchdog counted its
        hang, and finish() discards the answer."""
        if not self._stale():
            self._record_device_success()
        request.finish(result=result)

    def _answer_failed(
        self, live: List[_Request], error: BaseException
    ) -> None:
        """Answer requests whose device path failed, hung or was
        short-circuited: from numpy on the CPU (the ladder), with
        `error` on the card (module docstring)."""
        if self._numpy_ladder:
            self._finish_from_numpy(live)
            return
        for request in live:
            request.finish(error=error)

    def _finish_from_numpy(self, live: List[_Request]) -> None:
        for request in live:
            if request.event.is_set():
                # already answered (watchdog drain vs. stale-worker
                # unwind): don't burn a redundant host solve on a
                # result finish() would discard anyway
                continue
            try:
                request.finish(
                    result=self._numpy_fallback(
                        request.inputs, request.buckets
                    ),
                    degraded=True,
                )
            except Exception as numpy_error:  # noqa: BLE001
                request.finish(error=numpy_error, degraded=True)

    def _solve_group(
        self, key: tuple, live: List[_Request], lone: bool = False
    ) -> None:
        if key[0] == "forecast":
            self._forecast_group(key, live)
            return
        if key[0] == "preempt":
            self._preempt_group(key, live)
            return
        shape, buckets, backend = key[0], key[1], key[2]
        if backend == "numpy":
            # host program: no device dispatch, no padding, and no
            # fallback counting — this is the REQUESTED backend, not a
            # degradation. Completes inline, so in-flight device work
            # drains first to keep completion ordered.
            self._drain_inflight()
            with self._dispatch_span(
                "solver.dispatch", live, strategy="host"
            ):
                for request in live:
                    t0 = _time.perf_counter()
                    request.finish(
                        result=self._numpy_solve(request.inputs, buckets)
                    )
                    self._record_stage(
                        "dispatch", _time.perf_counter() - t0
                    )
            return
        # the device-dispatch injection point (faults/registry.py): an
        # error plan here exercises the per-request failure answer and
        # the FSM trip; a hang plan blocks inside a supervised device
        # section, exercising the watchdog restart + drain
        with self._device_section(live):
            inject("solver.dispatch")
        if self.device_solver is not None:
            self._drain_inflight()
            with self._device_section(live):
                for request in live:
                    t0 = _time.perf_counter()
                    out = self.device_solver(
                        request.inputs, buckets=buckets, backend=backend
                    )
                    self._record_stage(
                        "dispatch", _time.perf_counter() - t0
                    )
                    self._count_dispatch()
                    self._finish_device(request, out)
            return
        if self._shard_strategy(key) is not None:
            # mesh-partitioned dispatch: completes INLINE (two in-flight
            # fleet-scale batches would double peak memory, and a
            # synchronous failure is what lets _dispatch_group walk the
            # shard -> single-device ladder)
            self._drain_inflight()
            self._sharded_dispatch(shape, buckets, live, key)
            return
        if backend == "cuda":
            # the fused kernel has no batched entry; requests still
            # share the single worker (bounded device pressure).
            # Supervision happens per request inside.
            self._drain_inflight()
            self._solve_cuda(shape, buckets, live)
            return
        self._begin_pipelined_torch(
            shape, buckets, live, lone=lone,
            strategy=key[5] if len(key) > 5 else "map",
        )

    def _begin_pipelined_torch(
        self, shape, buckets: int, live: List[_Request], lone: bool,
        strategy: str = "map",
    ) -> None:
        """Dispatch a group, SPLITTING a lone batch into pipeline chunks:
        a lone coalesced batch with nothing in flight would dispatch
        once and drain immediately (closed-loop callers can't enqueue the
        next round until this one answers), so the double buffer never
        engaged. Chunking gives it the overlap: chunk k+1's
        pad/stack/dispatch runs while chunk k computes, and chunk k's
        fetch/scatter overlaps chunk k+1's compute. The batch loop runs
        its items one after another on the device either way, so
        splitting costs no device efficiency. A consolidation batch
        ("vmap") never splits: it is one dispatch by contract."""
        split = (
            strategy == "map"
            and lone
            and self.pipeline_depth > 0
            and not self._inflight
            and len(live) >= _PIPELINE_SPLIT_MIN
        )
        if not split:
            self._begin_batched_torch(shape, buckets, live, strategy)
            return
        n_chunks = min(self.pipeline_depth + 1, len(live) // 2)
        size = -(-len(live) // n_chunks)
        self.stats.pipeline_splits += 1
        for start in range(0, len(live), size):
            self._begin_batched_torch(
                shape, buckets, live[start:start + size]
            )

    def _solve_cuda(self, shape, buckets: int, live: List[_Request]) -> None:
        """The cuda rung (the reference's _solve_pallas): per request,
        upload the request's own operands (ops/binpack.on_device), then
        ops/binpack.solve(backend="cuda") on them, synchronised inside
        the supervised section, fetched once. No padding: the kernels
        take any shape. The "dispatch" stage covers the upload, the
        kernels and the sync, and is split into "upload", "launch" and
        "sync"; "device" is the events' span on the card (module
        docstring)."""
        from karpenter_tpu_torch.ops import binpack as B
        from karpenter_tpu_torch.ops import fused_assign as TF

        tracer = default_tracer()
        # the worker's own stream, never the whole device: a device-wide
        # sync would invalidate a fused-tick graph capture running on
        # another thread
        stream = torch.cuda.current_stream(self.device)
        began, ended = self._solve_events()
        cache_key = ("cuda", shape, buckets, live[0].key[3])
        fresh = self._count_key(cache_key)
        grace = COMPILE_GRACE_S if fresh else 0.0
        for request in live:
            with self._device_section([request], grace=grace):
                with self._dispatch_span(
                    "solver.dispatch", [request], strategy="cuda",
                    **self._span_cost_args(cache_key),
                ):
                    t0 = _time.perf_counter()
                    with tracer.span("solver.upload"):
                        resident = B.on_device(request.inputs, self.device)
                    t_resident = _time.perf_counter()
                    began.record(stream)
                    out = B.solve(
                        resident, buckets=buckets, backend="cuda",
                        device=self.device,
                    )
                    ended.record(stream)
                    t_launched = _time.perf_counter()
                with tracer.span("solver.sync", parent=request.span):
                    stream.synchronize()
                t_synced = _time.perf_counter()
            grace = 0.0  # only the first call of the batch is a first launch
            if self._stale():
                return  # the watchdog already answered these
            if fresh:
                fresh = False  # only the first call paid the first launch
                plane = self._introspect
                self._note_compile(
                    "solve", cache_key, _time.perf_counter() - t0,
                    [request],
                    cost_fn=(
                        functools.partial(
                            TF.solve_cost, request.inputs, buckets
                        )
                        if plane is not None and plane.enabled else None
                    ),
                )
            self._record_stage("dispatch", _time.perf_counter() - t0)
            self._record_stage("upload", t_resident - t0)
            self._record_stage("launch", t_launched - t_resident)
            self._record_stage("sync", t_synced - t_launched)
            self._record_stage("device", began.elapsed_time(ended) / 1e3)
            self._count_dispatch()
            t0 = _time.perf_counter()
            with tracer.span("solver.fetch", parent=request.span):
                host = _fetch_outputs(out)
            self._record_stage("fetch", _time.perf_counter() - t0)
            with tracer.span("solver.answer", parent=request.span):
                self._finish_device(request, host)

    def _solve_events(self):
        """The worker's two reusable timing events (CUDA events recorded
        on its stream around a Solve's work on the card), made on first
        use by each worker thread."""
        events = getattr(self._tls, "solve_events", None)
        if events is None:
            events = self._tls.solve_events = (
                torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True),
            )
        return events

    def _sharded_dispatch(
        self, shape, buckets: int, live: List[_Request], key: tuple
    ) -> None:
        """The shard route (the reference's _sharded_xla): on the cuda
        rung each request is one parallel/mesh.sharded_binpack on its own
        operands, whose shards launch the CUDA kernels (no padding but
        the mesh's); on the torch rung the group pads up the bucket
        ladder grown to mesh_aligned_shape, stacks (resident under the
        ("shard", extents) mode for a singleton), and runs the plain
        program on every shard per item. Completes inline; one fetch per
        request (cuda) or batch (torch)."""
        from karpenter_tpu_torch.parallel import mesh as MESH

        mesh = self._shard_mesh_for(key)
        backend, extents = key[2], key[6]
        strategy = "vmap" if key[5] == "vmap_shard" else "map"
        span_args = dict(strategy=strategy, devices=mesh.size)
        if backend == "cuda":
            cache_key = ("cuda", shape, buckets, key[3], "shard", extents)
            fresh = self._count_key(cache_key)
            grace = COMPILE_GRACE_S if fresh else 0.0
            for request in live:
                with self._dispatch_span(
                    "solver.dispatch.shard", [request], **span_args
                ):
                    with self._device_section([request], grace=grace):
                        t0 = _time.perf_counter()
                        with default_tracer().span("solver.shard"):
                            out = MESH.sharded_binpack(
                                mesh, request.inputs, buckets, backend="cuda"
                            )
                        _sync_mesh(mesh)
                grace = 0.0
                if self._stale():
                    return  # the watchdog already answered these
                if fresh:
                    fresh = False
                    self._note_compile(
                        "solve", cache_key, _time.perf_counter() - t0,
                        [request], extents=extents,
                    )
                self._record_stage("dispatch", _time.perf_counter() - t0)
                self._count_dispatch()
                self.stats.shard_dispatches += 1
                t0 = _time.perf_counter()
                host = _fetch_outputs(out)
                self._record_stage("fetch", _time.perf_counter() - t0)
                self._finish_device(request, host)
            return
        aligned = bucketing.mesh_aligned_shape(shape, extents)
        mode = ("shard", extents)
        resident = (
            self._resident_stack(aligned, live, mode)
            if strategy == "map" else None
        )
        if resident is not None:
            stacked, n_batch = resident, 1
        else:
            stacked, n_batch = self._stack_group(aligned, live)
        cache_key = (
            "torch", aligned, n_batch, buckets, key[3], key[4], strategy,
            "shard", extents,
        )
        fresh = self._count_key(cache_key)
        t0 = _time.perf_counter()
        with self._dispatch_span(
            "solver.dispatch.shard", live, batch=n_batch, **span_args
        ):
            with self._device_section(
                live, grace=COMPILE_GRACE_S if fresh else 0.0
            ):
                with default_tracer().span("solver.shard"):
                    if resident is None:
                        stacked = self._upload(stacked)
                    out = run_batched(stacked, buckets, functools.partial(
                        MESH.sharded_binpack, mesh, backend="torch"
                    ))
                    _sync_mesh(mesh)
        if self._stale():
            return  # the watchdog already answered these
        if fresh:
            self._note_compile(
                "solve", cache_key, _time.perf_counter() - t0, live,
                extents=extents,
            )
        self._record_stage("dispatch", _time.perf_counter() - t0)
        self._count_dispatch()
        self.stats.shard_dispatches += 1
        t0 = _time.perf_counter()
        host = _fetch_outputs(out)
        self._record_stage("fetch", _time.perf_counter() - t0)
        t0 = _time.perf_counter()
        for i, request in enumerate(live):
            self._finish_device(request, crop_outputs(
                _index_outputs(host, i), request.n_pods, request.n_groups,
            ))
        self._record_stage("scatter", _time.perf_counter() - t0)

    def _begin_batched_torch(
        self, shape, buckets: int, live: List[_Request],
        strategy: str = "map",
    ) -> None:
        """The coalesced path: pad each request to the shape bucket,
        stack along a new leading axis, pad the batch axis up its own
        ladder, dispatch ONE batched program — and DON'T wait for it.
        The dispatch joins the in-flight pipeline; its host-side fetch +
        crop + scatter are paid by _drain_one, which the worker calls
        after dispatching the NEXT batch (overlap) or when the queue
        goes idle (no result is ever held hostage to future traffic).

        The batched program runs the per-item plain program over the
        batch axis, one item after another, so outputs match direct
        calls element for element and peak memory stays at one item's
        working set (coalesced 100k-pod ticks must not pay a batch×
        amplification).

        Singleton groups first consult the DEVICE-RESIDENT fleet state
        (solver/resident.py): an identity hit or changed-row scatter
        skips the pad/stack/upload entirely."""
        resident = (
            self._resident_stack(shape, live) if strategy == "map" else None
        )
        if resident is not None:
            stacked, n_batch = resident, 1
        else:
            stacked, n_batch = self._stack_group(shape, live)
        cache_key = (
            "torch", shape, n_batch, buckets, live[0].key[3],
            live[0].key[4], strategy,
        )
        fresh = self._count_key(cache_key)
        t0 = _time.perf_counter()
        with self._dispatch_span(
            "solver.dispatch", live, strategy=strategy, batch=n_batch,
        ):
            with self._device_section(
                live, grace=COMPILE_GRACE_S if fresh else 0.0
            ):
                if resident is None:
                    stacked = self._upload(stacked)
                out = run_batched(stacked, buckets)
                done = _record_done(self.device)
        if self._stale():
            # superseded by a watchdog restart while dispatching: the
            # watchdog already answered these requests —
            # discard the late device results
            return
        if fresh:
            self._note_compile(
                "solve", cache_key, _time.perf_counter() - t0, live
            )
        if self._inflight:
            self.stats.pipeline_overlaps += 1
        self._inflight.append((out, live, t0, done))
        self._last_pipeline_depth = len(self._inflight)
        self._count_dispatch()
        # cap in-flight work at pipeline_depth, draining OLDEST first:
        # with depth 1 this is classic double buffering (batch k's fetch
        # is paid here, after batch k+1's dispatch); depth 0 restores
        # the serial dispatch→wait→scatter loop
        while len(self._inflight) > max(0, self.pipeline_depth):
            self._drain_one()

    def _stack_group(self, shape, live: List[_Request]):
        """(stacked host operands, batch bucket): pad each request to the
        shape bucket, stack along a new leading axis, pad the batch axis
        up its own ladder — batch padding replicates the first request,
        the cheapest valid filler (its outputs are computed and
        discarded). Records the "pad" stage."""
        t0 = _time.perf_counter()
        padded = [pad_to_bucket(r.inputs, shape) for r in live]
        n_batch = bucket_up(len(padded), 1)
        padded.extend(padded[:1] * (n_batch - len(padded)))
        stacked = _stack_inputs(padded)
        self._record_stage("pad", _time.perf_counter() - t0)
        return stacked, n_batch

    def _resident_stack(self, shape, live: List[_Request], mode=("single",)):
        """The device-resident serve path for a SINGLETON group: returns
        the resident stacked operands (batch axis 1), or None when
        residency does not apply — disabled, a coalesced multi-request
        batch (those stacks are ephemeral by nature), or an
        out-of-process device solver.

        kind accounting: a "hit" records a 0.0 upload sample (nothing
        crossed the link), a "scatter" records the scatter wall time
        under the resident_scatter stage + gauge (its host->device
        traffic is the changed-row blocks), and a "rebuild" billed its
        full upload through the normal _upload hook."""
        if (
            not self.resident_enabled
            or len(live) != 1
            or self.device_solver is not None
        ):
            return None
        request = live[0]
        t0 = _time.perf_counter()
        try:
            stacked, kind = self._resident.obtain(
                request.inputs, shape, mode, self._upload,
                tenant=request.tenant,
                now=self._clock(),
            )
        except Exception as error:  # noqa: BLE001 — optimization layer
            logger().warning(
                "resident fleet state unavailable (%s: %s); "
                "re-uploading the full operand stack",
                type(error).__name__, error,
            )
            return None
        if kind == "hit":
            self.stats.resident_hits += 1
            self._record_stage("upload", 0.0)
        elif kind == "scatter":
            self.stats.resident_scatters += 1
            self.stats.upload_bytes += self._resident.last_scatter_bytes
            elapsed = _time.perf_counter() - t0
            self._record_stage("resident_scatter", elapsed)
            self._g_resident_scatter.set("-", "-", elapsed * 1e3)
        else:
            self.stats.resident_rebuilds += 1
            self._c_resident_rebuilds.inc("-", "-")
        self.stats.resident_drops = self._resident.drops
        return stacked

    def _upload(self, stacked: BinPackInputs) -> BinPackInputs:
        """Place host operands on the service's device through
        ops/binpack.on_device (solve's own placement) and record the
        ISOLATED host->device transfer cost: compute waits on the
        transfer either way, so the sync point only moves the wait to
        where it can be measured."""
        t_up = _time.perf_counter()
        placed = on_device(stacked, self.device)
        leaves = (getattr(placed, f.name) for f in dataclasses.fields(placed))
        nbytes = sum(
            t.numel() * t.element_size() for t in leaves if t is not None
        )
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.stats.upload_bytes += nbytes
        self._record_stage("upload", _time.perf_counter() - t_up)
        return placed

    def _drain_one(self) -> None:
        """Complete the OLDEST in-flight dispatch: wait out its device
        work (the event recorded after it, so a later dispatch already
        enqueued is not waited for), fetch once, crop + scatter per
        request. Device-path failures surface here (asynchronous
        launches defer them to the wait) and are answered exactly like
        a sync failure (_answer_failed).

        Stage-metric caveat: under pipelining the "dispatch" sample is
        dispatch-to-drain WALL time — it includes whatever gather/pad
        work for the next batch overlapped the device compute, not pure
        device time."""
        with self._cond:
            # pop under the lock: the watchdog clears _inflight when it
            # supersedes a hung worker, and a stale worker must not
            # steal the NEW worker's in-flight batches
            if self._stale() or not self._inflight:
                return
            out, live, t_dispatch, done = self._inflight.popleft()
        try:
            with self._device_section(live):
                if done is not None:
                    done.synchronize()
            self._record_stage(
                "dispatch", _time.perf_counter() - t_dispatch
            )
            t0 = _time.perf_counter()
            host = _fetch_outputs(out)
            self._record_stage("fetch", _time.perf_counter() - t0)
            t0 = _time.perf_counter()
            for i, request in enumerate(live):
                self._finish_device(request, crop_outputs(
                    _index_outputs(host, i),
                    request.n_pods, request.n_groups,
                ))
            self._record_stage("scatter", _time.perf_counter() - t0)
        except Exception as error:  # noqa: BLE001 — device failure path
            if not self._stale():
                self._record_device_failure(live)
            logger().warning(
                "solver device path failed in flight (%s: %s); answering "
                "%d request(s) %s",
                type(error).__name__, error, len(live),
                "from numpy" if self._numpy_ladder else "with the error",
            )
            self._answer_failed(live, error)

    def _drain_inflight(self) -> None:
        while self._inflight:
            self._drain_one()

    def _count_key(self, cache_key: tuple) -> bool:
        """Count a dispatch key against the keys seen so far, under the
        reference's compile-cache counters (nothing is compiled per key
        here); True = first sight, and the following dispatch earns the
        watchdog's COMPILE_GRACE_S."""
        if cache_key in self._compile_seen:
            self.stats.compile_cache_hits += 1
            self._c_hits.inc("-", "-")
            return False
        self._compile_seen.add(cache_key)
        self.stats.compile_cache_misses += 1
        self._c_misses.inc("-", "-")
        return True

    def _count_dispatch(self) -> None:
        self.stats.dispatches += 1
        self._c_dispatch.inc("-", "-")

    def _on_expired(self, request: _Request) -> None:
        self.stats.deadline_expired += 1
        self._c_expired.inc("-", "-")

    def _numpy_fallback(self, inputs: BinPackInputs, buckets: int):
        self.stats.fallbacks += 1
        self._c_fallback.inc("-", "-")
        return self._numpy_solve(inputs, buckets)

    def _numpy_solve(self, inputs, buckets: int):
        from karpenter_tpu_torch.forecast import models as M

        if isinstance(inputs, M.ForecastInputs):
            # bit-identical mirror of the forecast program
            return M.forecast_numpy(inputs)
        from karpenter_tpu_torch.ops.preempt import PreemptInputs, preempt_numpy

        if isinstance(inputs, PreemptInputs):
            # bit-identical mirror of the eviction program
            return preempt_numpy(inputs)
        from karpenter_tpu_torch.ops.numpy_binpack import binpack_numpy

        return binpack_numpy(inputs, buckets=buckets)


def run_batched(
    stacked: BinPackInputs, buckets: int, program=None
) -> BinPackOutputs:
    """The torch rung's batched program: the plain per-item program
    (ops/binpack.binpack, what solve(backend="torch") runs, unless
    `program(item, buckets)` is given: the shard route's) over the
    leading batch axis, one item after another, outputs stacked along a
    new leading axis. No host sync: every op is enqueued on the current
    stream, so the worker can dispatch the next batch before this one
    finishes."""
    from karpenter_tpu_torch.ops import binpack as B

    program = program or B.binpack
    n_batch = stacked.pod_requests.shape[0]
    outs = []
    for i in range(n_batch):
        item = BinPackInputs(**{
            f.name: None if getattr(stacked, f.name) is None
            else getattr(stacked, f.name)[i]
            for f in dataclasses.fields(BinPackInputs)
        })
        outs.append(program(item, buckets))
    return BinPackOutputs(**{
        name: torch.stack([getattr(o, name) for o in outs])
        for name in _OUTPUT_FIELDS
    })


def _sync_mesh(mesh) -> None:
    """Wait for the current stream of every CUDA device of the mesh."""
    for device in {mesh.device_at(p) for p in mesh.local_positions()}:
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()


def _record_done(device: torch.device):
    """A CUDA event recorded after the work enqueued so far on the
    current stream (None on the CPU, where the work is already done)."""
    if device.type != "cuda":
        return None
    done = torch.cuda.Event()
    done.record()
    return done


def _stack_inputs(padded: List[BinPackInputs]) -> BinPackInputs:
    """Stack same-shaped requests along a new leading batch axis (host
    numpy; the upload happens inside the supervised dispatch).
    Optional operands are presence-consistent across the batch (the
    compatibility key includes the presence tuple)."""

    def stack(name: str):
        leaves = [getattr(p, name) for p in padded]
        if leaves[0] is None:
            return None
        return np.stack([np.asarray(leaf) for leaf in leaves], axis=0)

    return BinPackInputs(
        **{
            f.name: stack(f.name)
            for f in dataclasses.fields(BinPackInputs)
        }
    )


def _fetch_outputs(out):
    """Device outputs -> host numpy in ONE device->host copy: the five
    int32 leaves are flattened and concatenated on the device first.
    Host outputs pass through."""
    if not isinstance(out.assigned, torch.Tensor):
        return out
    leaves = [getattr(out, name) for name in _OUTPUT_FIELDS]
    packed = torch.cat([leaf.reshape(-1) for leaf in leaves]).cpu().numpy()
    host = {}
    offset = 0
    for name, leaf in zip(_OUTPUT_FIELDS, leaves):
        n = leaf.numel()
        host[name] = packed[offset:offset + n].reshape(tuple(leaf.shape))
        offset += n
    return dataclasses.replace(out, **host)


def _index_outputs(host, i: int):
    return dataclasses.replace(
        host,
        assigned=host.assigned[i],
        assigned_count=host.assigned_count[i],
        nodes_needed=host.nodes_needed[i],
        lp_bound=host.lp_bound[i],
        unschedulable=host.unschedulable[i],
    )


# -- pre-warm problem builders (prewarm docstring) ---------------------------


def _prewarm_solve_inputs() -> BinPackInputs:
    """1 pod x 1 group, weight present: pads up to the floor rung
    (256 x 8 x 4 x 32 x 64) inside the queue — the dispatch key a small
    fleet's first pendingCapacity solve hits."""
    return BinPackInputs(
        pod_requests=np.ones((1, 1), np.float32),
        pod_valid=np.ones(1, bool),
        pod_intolerant=np.zeros((1, 1), bool),
        pod_required=np.zeros((1, 1), bool),
        group_allocatable=np.full((1, 1), 8.0, np.float32),
        group_taints=np.zeros((1, 1), bool),
        group_labels=np.zeros((1, 1), bool),
        pod_weight=np.ones(1, np.int32),
    )


def _prewarm_decide_inputs() -> dict:
    """1 autoscaler x 1 metric at the decision program's smallest row
    bucket (ops/decision.pad_to), as numpy fields."""
    from karpenter_tpu_torch.ops import decision as D

    n = D.pad_to(1)
    zeros_i = np.zeros(n, np.int32)
    zeros_f = np.zeros(n, np.float32)
    col_i = np.zeros((n, 1), np.int32)
    col_b = np.zeros((n, 1), bool)
    return dict(
        metric_value=np.zeros((n, 1), np.float32),
        target_value=np.ones((n, 1), np.float32),
        target_type=np.full((n, 1), D.TYPE_AVERAGE_VALUE, np.int32),
        metric_valid=col_b.copy(),
        spec_replicas=zeros_i.copy(),
        status_replicas=zeros_i.copy(),
        min_replicas=zeros_i.copy(),
        max_replicas=np.ones(n, np.int32),
        up_window=zeros_i.copy(),
        down_window=zeros_i.copy(),
        up_policy=np.full(n, D.POLICY_MAX, np.int32),
        down_policy=np.full(n, D.POLICY_MAX, np.int32),
        last_scale_time=zeros_f.copy(),
        has_last_scale=np.zeros(n, bool),
        now=np.float32(0.0),
        up_ptype=col_i.copy(),
        up_pvalue=col_i.copy(),
        up_pperiod=np.ones((n, 1), np.int32),
        up_pvalid=col_b.copy(),
        down_ptype=col_i.copy(),
        down_pvalue=col_i.copy(),
        down_pperiod=np.ones((n, 1), np.int32),
        down_pvalid=col_b.copy(),
    )


def _prewarm_fused_inputs():
    """The fused tick with forecast, decide and cost engaged at the
    smallest rung of every shape ladder: 1 series x 1 sample (padded to
    8 x 16 inside fused_tick), the decide program's smallest row bucket,
    1 metric column."""
    from karpenter_tpu_torch.forecast.models import ForecastInputs
    from karpenter_tpu_torch.ops import decision as D
    from karpenter_tpu_torch.ops import fusedtick as FT

    dec = D.DecisionInputs(**_prewarm_decide_inputs())
    n = int(dec.spec_replicas.shape[0])
    return FT.FusedTickInputs(
        decision=dec,
        forecast=ForecastInputs(
            values=np.zeros((1, 1), np.float32),
            valid=np.zeros((1, 1), bool),
            times=np.zeros((1, 1), np.float32),
            weights=np.ones((1, 1), np.float32),
            horizon=np.ones(1, np.float32),
            step_s=np.ones(1, np.float32),
            model=np.zeros(1, np.int32),
            season=np.zeros(1, np.int32),
            alpha=np.full(1, 0.5, np.float32),
            beta=np.full(1, 0.1, np.float32),
            gamma=np.full(1, 0.1, np.float32),
        ),
        series_row=np.zeros(1, np.int32),
        series_col=np.zeros(1, np.int32),
        series_need=np.full(1, 2, np.int32),
        series_blend=np.zeros(1, bool),
        ha_min=np.zeros(n, np.int32),
        ha_max=np.ones(n, np.int32),
        unit_cost=np.zeros(n, np.float32),
        slo_weight=np.zeros(n, np.float32),
        max_hourly_cost=np.zeros(n, np.float32),
        slo_valid=np.zeros(n, bool),
        slo_target=np.ones((n, 1), np.float32),
        observed=np.zeros((n, 1), np.float32),
        demand_base_valid=np.zeros((n, 1), bool),
        prior_point=np.zeros((n, 1), np.float32),
        prior_sigma2=np.zeros((n, 1), np.float32),
        prior_valid=np.zeros((n, 1), bool),
    )


def _prewarm_cost_inputs():
    """The cost program at the decision program's smallest row bucket,
    1 metric column, no SLO rows."""
    from karpenter_tpu_torch.ops import cost as C
    from karpenter_tpu_torch.ops import decision as D

    n = D.pad_to(1)
    return C.CostInputs(
        base_desired=np.zeros(n, np.int32),
        min_replicas=np.zeros(n, np.int32),
        max_replicas=np.ones(n, np.int32),
        unit_cost=np.zeros(n, np.float32),
        slo_weight=np.zeros(n, np.float32),
        max_hourly_cost=np.zeros(n, np.float32),
        slo_valid=np.zeros(n, bool),
        slo_target=np.ones((n, 1), np.float32),
        demand_mu=np.zeros((n, 1), np.float32),
        demand_sigma=np.zeros((n, 1), np.float32),
        demand_valid=np.zeros((n, 1), bool),
    )


def _prewarm_poolgroup_inputs():
    """One group of two pools (the smallest pool bucket), 1 metric."""
    from karpenter_tpu_torch.ops import poolgroup as PG

    g, p, r = 1, PG.POOL_BUCKETS[0], PG.RATIO_SLOTS
    zi, zf, zb = (np.zeros((g, p), t) for t in (np.int32, np.float32, bool))
    return PG.PoolGroupInputs(
        base_desired=zi, min_replicas=zi.copy(), max_replicas=zi + 1,
        unit_cost=zf, slo_weight=zf.copy(), max_hourly_cost=zf.copy(),
        tier_penalty=zf.copy(), pool_valid=zb,
        slo_target=np.ones((g, p, 1), np.float32),
        demand_mu=np.zeros((g, p, 1), np.float32),
        demand_sigma=np.zeros((g, p, 1), np.float32),
        demand_valid=np.zeros((g, p, 1), bool),
        ratio_a=np.zeros((g, r), np.int32),
        ratio_b=np.zeros((g, r), np.int32),
        ratio_min_num=np.zeros((g, r), np.int32),
        ratio_min_den=np.ones((g, r), np.int32),
        ratio_max_num=np.zeros((g, r), np.int32),
        ratio_max_den=np.zeros((g, r), np.int32),
        ratio_valid=np.zeros((g, r), bool),
        group_budget=np.zeros(g, np.float32),
        group_valid=np.zeros(g, bool),
    )


# -- process-default service -------------------------------------------------
# simulate and the sidecar server share one service per process (the whole
# point: concurrent callers coalesce); a runtime builds its OWN instance
# so its gauges land in the runtime registry.

_default_lock = threading.Lock()
_default_service: Optional[SolverService] = None


def default_service() -> SolverService:
    """The process-shared service, on the CUDA card (it raises without
    one, through resolve_device)."""
    global _default_service
    with _default_lock:
        if _default_service is None:
            _default_service = SolverService()
        return _default_service


def reset_default_service() -> None:
    """Close and drop the process-default service (test isolation)."""
    global _default_service
    with _default_lock:
        if _default_service is not None:
            _default_service.close()
            _default_service = None


def reset_default_service_caches() -> None:
    """Invalidate the process-default service's caches WITHOUT closing
    it — the recovery-boot seam for the one solver instance that can
    outlive an in-process controller restart."""
    with _default_lock:
        if _default_service is not None:
            _default_service.reset_caches()
