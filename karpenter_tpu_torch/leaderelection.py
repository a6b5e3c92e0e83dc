"""Leader election over the object store's optimistic concurrency.

reference: cmd/controller/main.go:58-59 enables controller-runtime's
lease-based leader election (lease RBAC at config/rbac/role.yaml:62-71) so
exactly one controller replica reconciles at a time. Here the lease is an
object in the store (the apiserver-bus analog), acquired and renewed with
compare-and-swap semantics: a stale resourceVersion loses the race, so two
candidates can never both hold the lease — same invariant, same transport
as all other cross-controller coordination.

Clock discipline (docs/resilience.md "Replicated control plane"): the
`renew_time` stamped INTO the lease is wall-clock (it is shared state other
candidates read), but every LOCAL freshness judgement runs on a monotonic
clock — our own leadership lapses `lease_duration` of monotonic time after
our last successful renew, and another holder's lease is aged by how long
WE have watched the same (holder, renew_time) stamp stand still. A wall
clock stepped backward therefore cannot extend a stale lease (the
monotonic observation keeps aging it), and a wall clock stepped forward by
less than `skew_tolerance` cannot prematurely expire a fresh one.

Chaos seams: each election round passes through the fault-injection points
`lease.acquire.<identity>` / `lease.renew.<identity>` (faults/registry.py)
— an injected retryable error is a store partition for that candidate (the
round fails, leadership lapses when renews keep failing), a crash plan is
the replica dying mid-round.

The port's copy of karpenter_tpu/leaderelection.py.
"""

from __future__ import annotations

import time as _time
import uuid
from dataclasses import dataclass, field
from typing import Optional, Tuple

from karpenter_tpu_torch.api.core import ObjectMeta
from karpenter_tpu_torch.controllers.errors import RetryableError
from karpenter_tpu_torch.faults import inject
from karpenter_tpu_torch.store.store import ConflictError, Store

DEFAULT_LEASE_NAME = "karpenter-leader"
DEFAULT_LEASE_NAMESPACE = "kube-system"
DEFAULT_LEASE_DURATION = 15.0
# slack added to another holder's expiry before we contend for takeover:
# a wall clock stepped forward by less than this cannot steal a lease the
# holder is still renewing on time
DEFAULT_SKEW_TOLERANCE = 1.0


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease analog."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder: str = ""
    renew_time: float = 0.0
    lease_duration: float = DEFAULT_LEASE_DURATION


class LeaderElector:
    """Acquire-or-renew on every tick; leadership is only ever held for one
    lease_duration past the last successful renew (monotonic — module
    docstring)."""

    def __init__(
        self,
        store: Store,
        identity: Optional[str] = None,
        name: str = DEFAULT_LEASE_NAME,
        namespace: str = DEFAULT_LEASE_NAMESPACE,
        lease_duration: float = DEFAULT_LEASE_DURATION,
        clock=_time.time,
        monotonic=None,
        skew_tolerance: float = DEFAULT_SKEW_TOLERANCE,
    ):
        self.store = store
        self.identity = identity or f"karpenter-{uuid.uuid4().hex[:8]}"
        self.name = name
        self.namespace = namespace
        self.lease_duration = lease_duration
        self.clock = clock
        # scripted clocks (tests, SimLab) double as the monotonic source
        # — only the real wall clock needs a separate monotonic reading
        if monotonic is None:
            monotonic = _time.monotonic if clock is _time.time else clock
        self.monotonic = monotonic
        self.skew_tolerance = skew_tolerance
        # monotonic timestamp of OUR last successful acquire/renew: the
        # only input to our own freshness — a stepped wall clock cannot
        # stretch (or clip) how long we believe we lead
        self._renewed_mono: Optional[float] = None
        # last (holder, renew_time) stamp seen on the lease + the
        # monotonic time we FIRST saw it: ages another holder's lease on
        # our own clock, so a backward wall step cannot keep it fresh
        self._observed: Optional[Tuple[Tuple[str, float], float]] = None

    # -- freshness ---------------------------------------------------------

    def _holding(self, now_mono: float) -> bool:
        """Whether WE believe we hold the lease right now (monotonic)."""
        return (
            self._renewed_mono is not None
            and now_mono - self._renewed_mono <= self.lease_duration
        )

    def _expired(self, lease: Lease, now: float, now_mono: float) -> bool:
        """Whether ANOTHER holder's lease has lapsed. Wall expiry (with
        the skew margin) is the fast path a fresh candidate needs to
        take over after a real death; the monotonic observation age is
        the backstop a stepped wall clock cannot fake."""
        stamp = (lease.holder, lease.renew_time)
        if self._observed is None or self._observed[0] != stamp:
            self._observed = (stamp, now_mono)
        observed_age = now_mono - self._observed[1]
        margin = lease.lease_duration + self.skew_tolerance
        # inclusive: a challenger observing exactly margin-old evidence
        # may steal — the margin IS the grace, not one tick more
        return now >= lease.renew_time + margin or observed_age >= margin

    # -- the election round ------------------------------------------------

    def try_acquire(self) -> bool:
        """One election round: returns True iff this identity holds the
        lease after the round. Safe to call every tick."""
        now = self.clock()
        now_mono = self.monotonic()
        verb = "renew" if self._holding(now_mono) else "acquire"
        try:
            inject(f"lease.{verb}.{self.identity}")
        except RetryableError:
            # injected partition: this candidate cannot reach the store
            # this round — it neither renews nor contends
            return False
        lease = self.store.try_get("Lease", self.namespace, self.name)
        if lease is None:
            return self._create_fresh(now, now_mono)
        held_by_other = lease.holder != self.identity
        if held_by_other and not self._expired(lease, now, now_mono):
            return False
        # already ours and fresh: skip the write until a third of the lease
        # has elapsed (k8s renewDeadline posture) — renewing every tick
        # churns the store bus with resourceVersion bumps + watch events
        if (
            not held_by_other
            and self._renewed_mono is not None
            and now_mono - self._renewed_mono < self.lease_duration / 3
        ):
            return True
        # renew (ours) or take over (expired): CAS via resourceVersion
        lease.holder = self.identity
        lease.renew_time = now
        try:
            self.store.update(lease)
            self._renewed_mono = now_mono
            return True
        except ConflictError:
            return False  # lost the race this round

    def _create_fresh(self, now: float, now_mono: float) -> bool:
        """No Lease object yet: first creator wins."""
        try:
            self.store.create(
                Lease(
                    metadata=ObjectMeta(
                        name=self.name, namespace=self.namespace
                    ),
                    holder=self.identity,
                    renew_time=now,
                    lease_duration=self.lease_duration,
                )
            )
            self._renewed_mono = now_mono
            return True
        except ConflictError:
            return False  # another candidate created it first

    def release(self) -> None:
        """Graceful surrender: zero the holder so a successor takes over
        without waiting out the lease. Best-effort — losing the CAS (or
        never having held) just leaves expiry to do the work."""
        self._renewed_mono = None
        lease = self.store.try_get("Lease", self.namespace, self.name)
        if lease is None or lease.holder != self.identity:
            return
        lease.holder = ""
        lease.renew_time = 0.0
        try:
            self.store.update(lease)
        except ConflictError:
            pass

    def is_leader(self) -> bool:
        lease = self.store.try_get("Lease", self.namespace, self.name)
        return (
            lease is not None
            and lease.holder == self.identity
            and self._holding(self.monotonic())
        )
