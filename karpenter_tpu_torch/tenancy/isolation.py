"""Per-tenant failure isolation: breakers generalizing the fault ladder.

The solver's backend-health FSM (solver/service.py) answers "is the
DEVICE sick" — one verdict for the whole process. With a thousand
tenants behind one service that is the wrong granularity: one tenant's
poisoned operands (a corrupt snapshot, a fault-injected feed) must not
degrade the other 999. The TenantBreakerBoard here is the per-tenant
generalization of the fault registry's per-object circuit breakers
(resilience.py): K consecutive per-tenant failures OPEN that tenant's
breaker — its rows stop entering the shared concatenated dispatch and
serve from the family's bit-identical numpy mirror instead — while
healthy tenants keep riding the device batch. An open breaker admits
one PROBE attempt per reset window; a probe success closes it.

This is the isolation half of docs/multitenancy.md's contract; the
fencing half (per-tenant journal dirs and actuation generations) lives
in registry.py — a tenant's crash-recovery state is namespaced the same
way its dispatch health is.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict

CLOSED = "closed"
OPEN = "open"
# gate() verdicts: a PROBING tenant is dispatched in ISOLATION — its
# probe must never re-enter the shared batch, or the exact failure that
# opened the breaker would re-break every healthy tenant's round once
# per reset window
PROBE = "probe"


@dataclass
class _BreakerState:
    consecutive_failures: int = 0
    state: str = CLOSED
    next_probe: float = 0.0
    trips: int = 0


@dataclass
class TenantBreakerBoard:
    """One breaker per tenant id (module docstring).

    `threshold` consecutive failures open a tenant's breaker;
    `reset_s` is the open window before a probe attempt is admitted."""

    threshold: int = 3
    reset_s: float = 30.0
    clock: Callable[[], float] = _time.monotonic
    _tenants: Dict[str, _BreakerState] = field(default_factory=dict)

    def _state(self, tenant: str) -> _BreakerState:
        state = self._tenants.get(tenant)
        if state is None:
            state = self._tenants[tenant] = _BreakerState()
        return state

    def gate(self, tenant: str) -> str:
        """This tenant's admission verdict for one round: CLOSED (full
        shared-batch member), PROBE (breaker open but the probe window
        elapsed — ONE isolated recovery attempt; the next probe is
        scheduled immediately so consecutive rounds don't all probe),
        or OPEN (serve from the mirror, no attempt)."""
        state = self._state(tenant)
        if state.state == CLOSED:
            return CLOSED
        now = self.clock()
        if now >= state.next_probe:
            state.next_probe = now + self.reset_s
            return PROBE
        return OPEN

    def allow(self, tenant: str) -> bool:
        """Convenience over gate(): may this tenant attempt ANY device
        work this round (shared membership or an isolated probe)?"""
        return self.gate(tenant) != OPEN

    def record_failure(self, tenant: str) -> bool:
        """Count one per-tenant failure; returns True when this failure
        TRIPPED the breaker (closed -> open)."""
        state = self._state(tenant)
        state.consecutive_failures += 1
        if (
            state.state == CLOSED
            and state.consecutive_failures >= self.threshold
        ):
            state.state = OPEN
            state.next_probe = self.clock() + self.reset_s
            state.trips += 1
            return True
        return False

    def record_success(self, tenant: str) -> bool:
        """Reset the failure run; returns True when this success CLOSED
        an open breaker (a probe recovered the tenant)."""
        state = self._state(tenant)
        state.consecutive_failures = 0
        recovered = state.state == OPEN
        state.state = CLOSED
        return recovered

    def is_open(self, tenant: str) -> bool:
        state = self._tenants.get(tenant)
        return state is not None and state.state == OPEN

    def trips(self, tenant: str) -> int:
        state = self._tenants.get(tenant)
        return 0 if state is None else state.trips

    def forget(self, tenant: str) -> None:
        """Drop a deleted tenant's breaker state."""
        self._tenants.pop(tenant, None)
