"""Seeded, deterministic fault-injection registry.

The reference survives provider flakiness with an error taxonomy
(pkg/controllers/errors.go) but never EXERCISES those paths: nothing in
its test suite injects a throttled ASG mid-reconcile or a hung solver.
This registry makes failure a first-class test input. Production code is
instrumented with named injection points (`inject("cloud.set_replicas")`
— one global read + None check when no registry is installed, so the
hot path pays nothing), and a chaos suite installs plans against them:

  * error   — raise a configured exception (RetryableError by default,
              so the controller taxonomy is exercised end to end)
  * latency — sleep before proceeding (slow backend)
  * hang    — block until the registry releases (dead backend; the
              solver watchdog is expected to trip first)
  * flaky   — fail the first N matching attempts, then pass forever
              (times=N on an error plan)
  * crash   — raise ProcessCrash, a BaseException the tick's blanket
              `except Exception` handlers can NOT swallow: the injected
              analog of SIGKILL. The kill-and-restart chaos suite
              (tests/test_restart_chaos.py) catches it at harness level,
              abandons the incarnation, and reboots from the journal.

Determinism: every plan owns its own `random.Random` stream seeded from
(registry seed, plan index), so a plan's fire/skip sequence depends only
on its own attempt order — not on interleaving with other points — and
a chaos run replays exactly under a fixed seed.

Points instrumented across the stack (docs/resilience.md):

  solver.dispatch     device path of the shared solve service
  forecast.predict    device path of the batched forecast seam
  preempt.plan        device path of the eviction-planning seam
  cost.score          device path of the multi-objective cost/SLO
                      refinement (SolverService.cost) — failures make
                      the tick COST-BLIND, not mirror-served
                      (docs/cost.md degradation contract)
  fused.tick          the fused steady-state megakernel
                      (SolverService.fused_tick) — failures fall back
                      to the chained per-stage path, then numpy, and
                      feed the FSM (docs/solver-service.md "Fused
                      tick")
  poolgroup.solve     device path of the joint pool-group allocation
                      (SolverService.poolgroup) — failures degrade to
                      INDEPENDENT per-pool ladders for the tick
                      (ratios advisory, never-block) and feed the FSM
                      (docs/poolgroups.md)
  encoder.encode      snapshot -> solver-operand encode
  cloud.get_replicas  provider replica observation
  cloud.set_replicas  provider actuation
  metrics.query       metrics-client instant queries
  sidecar.rpc         gRPC solver client calls
  store.patch_status  controller status writes
  process.crash.*     kill points for the restart chaos suite — target a
                      site exactly, or the whole family via the glob:
                      .drain (consolidation actuation), .evict
                      (preemption mid-eviction-batch), .journal (the
                      recovery StateJournal, which flushes a REAL torn
                      half-record before dying)
  lease.acquire.*     lease acquisition CAS, per elector identity —
  lease.renew.*       error plans here are a partitioned/deposed
                      replica that cannot reach the lease store
                      (replication.chaos partition_plans builds the
                      pair)
  replica.crash.*     kill point at the top of a replica's tick
                      (ReplicatedControlPlane.on_tick) — a crash plan
                      here is that replica dying between lease rounds
                      (replication.chaos crash_plan; the failover
                      world's leader kill)

Registries also export `karpenter_faults_{attempts,injected}_total`
{name=<point>} when given a GaugeRegistry, so a chaos run's injection
volume is visible on the same /metrics surface as the resilience
counters it provokes.

The port's copy of karpenter_tpu/faults/registry.py. The port
instruments every point above, and simlab.step (the service's sim_step /
sim_rollout) and constraints.mask (the constraint encoder).
"""

from __future__ import annotations

import contextlib
import random
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.controllers.errors import RetryableError

SUBSYSTEM = "faults"

MODES = ("error", "latency", "hang", "flaky", "crash")


class FaultInjected(RetryableError):
    """The default injected error: retryable, coded, and typed so tests
    can tell an injected failure from an organic one."""


class ProcessCrash(BaseException):
    """The injected SIGKILL analog (mode "crash"). Deliberately NOT an
    Exception: the reconcile engine's blanket `except Exception` must
    not be able to absorb a simulated process death — it propagates out
    of the tick to the test harness, which abandons the incarnation and
    restarts from the journal."""


@dataclass
class FaultPlan:
    """One fault plan against one injection point (or a `prefix.*` glob).

    `times` bounds TOTAL firings (None = unlimited); mode "flaky" is an
    error plan whose firings are the FIRST `times` matching attempts —
    after N failures the point succeeds forever (the classic transient
    outage shape).
    """

    point: str
    mode: str = "error"
    probability: float = 1.0
    times: Optional[int] = None
    latency_s: float = 0.0
    retryable: bool = True
    code: str = "FaultInjected"
    message: str = ""
    # runtime state (owned by the registry)
    attempts: int = 0
    fired: int = 0
    _rng: random.Random = field(default_factory=random.Random, repr=False)

    def _exhausted(self) -> bool:
        return self.times is not None and self.fired >= self.times

    def _decide(self) -> bool:
        """Whether this attempt fires. Called under the registry lock;
        the plan-local RNG stream makes the sequence a pure function of
        this plan's attempt order."""
        if self._exhausted():
            return False
        if self.mode == "flaky":
            return True  # fail-first-N is deterministic by definition
        if self.probability >= 1.0:
            return True
        return self._rng.random() < self.probability

    def matches(self, point: str) -> bool:
        if self.point.endswith("*"):
            return point.startswith(self.point[:-1])
        return self.point == point


class FaultRegistry:
    """Installable set of fault plans + per-point counters.

    Use as a context manager (`with FaultRegistry(seed=7) as reg: ...`)
    or via faults.install()/uninstall(). Exiting releases any in-flight
    hangs so a failing test never wedges the suite.
    """

    def __init__(self, seed: int = 0, registry=None):
        self.seed = seed
        self._plans: List[FaultPlan] = []
        self._lock = threading.Lock()
        self._release = threading.Event()
        self.attempts: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}
        self._c_attempts = self._c_injected = None
        if registry is not None:
            self._c_attempts = registry.register(
                SUBSYSTEM, "attempts_total", kind="counter"
            )
            self._c_injected = registry.register(
                SUBSYSTEM, "injected_total", kind="counter"
            )

    # -- plan building ----------------------------------------------------

    def plan(self, point: str, **kwargs) -> FaultPlan:
        """Add a plan; its RNG stream is seeded from (registry seed,
        plan index) so runs replay deterministically."""
        plan = FaultPlan(point=point, **kwargs)
        if plan.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {plan.mode!r}")
        with self._lock:
            # int-combined (seed, plan-index) stream id: tuple seeding is
            # deprecated, and the plan index keeps sibling plans'
            # sequences independent under one registry seed
            plan._rng = random.Random(
                (self.seed * 1_000_003) ^ len(self._plans)
            )
            self._plans.append(plan)
        return plan

    def clear(self) -> None:
        """Drop all plans and release any in-flight hangs (the 'faults
        cleared' transition of a chaos scenario)."""
        with self._lock:
            self._plans = []
        self._release.set()
        self._release = threading.Event()

    def plans(self) -> List[FaultPlan]:
        with self._lock:
            return list(self._plans)

    # -- firing -----------------------------------------------------------

    def fire(self, point: str) -> None:
        """Evaluate all plans against one attempt at `point` — called
        from inject() on the instrumented code path."""
        with self._lock:
            self.attempts[point] = self.attempts.get(point, 0) + 1
            if self._c_attempts is not None:
                self._c_attempts.inc(point, "-")
            plan = None
            for candidate in self._plans:
                if not candidate.matches(point):
                    continue
                # EVERY matching plan records the attempt (and consumes
                # its RNG stream) so a plan's fire/skip sequence is a
                # pure function of the point's attempt order, not of
                # which other plan fired first
                candidate.attempts += 1
                fires = candidate._decide()
                if plan is None and fires:
                    plan = candidate
            if plan is None:
                return
            plan.fired += 1
            self.injected[point] = self.injected.get(point, 0) + 1
            if self._c_injected is not None:
                self._c_injected.inc(point, "-")
            release = self._release
        # flight-recorder breadcrumb BEFORE executing (a crash plan
        # raises out of _execute): the chaos timeline shows what was
        # injected where, backlinked to the reconcile trace it hit
        from karpenter_tpu_torch.observability import default_flight_recorder

        default_flight_recorder().record(
            "fault_injected", point=point, mode=plan.mode,
        )
        self._execute(plan, point, release)

    def _execute(
        self, plan: FaultPlan, point: str, release: threading.Event
    ) -> None:
        """Carry out a fired plan OUTSIDE the lock (latency/hang must
        not serialize unrelated points)."""
        if plan.mode == "latency":
            _time.sleep(plan.latency_s)
            return
        if plan.mode == "crash":
            raise ProcessCrash(f"injected process crash at {point}")
        if plan.mode == "hang":
            # block until the registry releases (clear()/uninstall/exit),
            # then surface as a retryable error: the stalled caller's
            # frame unwinds through the same degradation path a real
            # backend recovery would, instead of resuming as if nothing
            # happened with state the watchdog already reassigned.
            release.wait()
            raise FaultInjected(
                f"hang released at {point}", code="FaultHangReleased"
            )
        raise FaultInjected(
            plan.message or f"injected fault at {point}",
            code=plan.code,
            retryable=plan.retryable,
        )

    def release_hangs(self) -> None:
        self._release.set()
        self._release = threading.Event()

    def __enter__(self) -> "FaultRegistry":
        install(self)
        return self

    def __exit__(self, *exc) -> None:
        uninstall(self)


# -- module-level installation ------------------------------------------------

_active: Optional[FaultRegistry] = None


def install(registry: FaultRegistry) -> FaultRegistry:
    global _active
    _active = registry
    return registry


def uninstall(registry: Optional[FaultRegistry] = None) -> None:
    """Deactivate (the given registry, or whatever is active) and release
    its hangs so no injected stall outlives the scenario."""
    global _active
    target = registry or _active
    _active = None
    if target is not None:
        target.release_hangs()


def active() -> Optional[FaultRegistry]:
    return _active


@contextlib.contextmanager
def injected_faults(seed: int = 0, registry=None):
    """`with injected_faults(seed=7) as reg:` — scoped install."""
    reg = FaultRegistry(seed=seed, registry=registry)
    install(reg)
    try:
        yield reg
    finally:
        uninstall(reg)


def inject(point: str) -> None:
    """The injection point production code calls. No registry installed
    (the production default) is one global read + None check."""
    registry = _active
    if registry is not None:
        registry.fire(point)
