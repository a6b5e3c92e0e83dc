"""Supervised-degradation primitives: jittered backoff + circuit breaker.

The reference's failure handling is a taxonomy (errors.go) consumed by
one controller; requeues stay fixed-interval and a flapping provider is
retried forever at full cadence. These primitives are the ladder the
TPU build layers on top (docs/resilience.md):

  * DecorrelatedJitterBackoff — the engine's per-object requeue delay
    under repeated retryable failures. Monotone non-decreasing (each
    delay is drawn from [prev, prev*3], so retries never speed back up
    mid-outage) and bounded by `cap_s`; the jitter decorrelates a fleet
    of failing objects so recovery doesn't thundering-herd the provider.
  * CircuitBreaker — closed → open after `failure_threshold` consecutive
    failures → half-open after `reset_s` (one probe admitted) → closed
    on probe success / open again on probe failure. The SNG controller
    keeps one per node group so a flapping cloud API stops eating the
    reconcile tick.

Both are clock-injected and RNG-seeded: deterministic under test, which
is what lets the chaos suite assert exact ladder behavior.
"""

from __future__ import annotations

import random
import time as _time
from typing import Callable, Optional

SUBSYSTEM = "resilience"

# Circuit states, exported as gauge values on
# karpenter_resilience_circuit_state{name=<group>}
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"
CIRCUIT_STATE_VALUE = {CLOSED: 0.0, HALF_OPEN: 0.5, OPEN: 1.0}


class DecorrelatedJitterBackoff:
    """next(prev) draws the next retry delay.

    Variant of AWS's decorrelated jitter with a floor at the previous
    delay: delay_n = min(cap, uniform(prev_n-1, prev_n-1 * 3)), starting
    from uniform(base, base*3). The floor makes the sequence monotone
    non-decreasing (a property the engine's requeue ladder pins in
    tests) while keeping the spread that decorrelates concurrent
    failers.
    """

    def __init__(
        self, base_s: float = 1.0, cap_s: float = 60.0, seed: int = 0
    ):
        if base_s <= 0 or cap_s < base_s:
            raise ValueError(
                f"need 0 < base_s <= cap_s, got {base_s}/{cap_s}"
            )
        self.base_s = base_s
        self.cap_s = cap_s
        self._rng = random.Random(seed)

    def next(self, prev: float = 0.0) -> float:
        low = max(self.base_s, prev)
        return min(self.cap_s, self._rng.uniform(low, low * 3.0))


class CircuitBreaker:
    """Per-resource breaker around a flaky dependency.

    allow() gates the call: True in closed state, True once per
    `reset_s` window while open (the half-open probe), else False.
    Callers report outcomes with record_success()/record_failure(code).
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_s: float = 30.0,
        clock: Callable[[], float] = _time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_s = reset_s
        self.clock = clock
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self.last_error_code = ""
        self.opens_total = 0

    def allow(self) -> bool:
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self.clock() - (self.opened_at or 0.0) >= self.reset_s:
                self.state = HALF_OPEN
                return True  # the one probe this window
            return False
        # HALF_OPEN: a probe is already in flight this window; further
        # callers stay blocked until its outcome is recorded
        return False

    def record_success(self) -> None:
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at = None
        self.last_error_code = ""

    def record_failure(self, code: str = "") -> None:
        self.consecutive_failures += 1
        if code:
            self.last_error_code = code
        if self.state == HALF_OPEN:
            # failed probe: back to open for a fresh reset window
            self._open()
        elif (
            self.state == CLOSED
            and self.consecutive_failures >= self.failure_threshold
        ):
            self._open()

    def _open(self) -> None:
        self.state = OPEN
        self.opened_at = self.clock()
        self.opens_total += 1

    def retry_in(self) -> float:
        """Seconds until the next half-open probe is admitted (0 when
        not open) — surfaced in the ActuationCircuitOpen condition."""
        if self.state != OPEN or self.opened_at is None:
            return 0.0
        return max(0.0, self.reset_s - (self.clock() - self.opened_at))

    def state_value(self) -> float:
        return CIRCUIT_STATE_VALUE[self.state]
