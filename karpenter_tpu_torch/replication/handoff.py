"""TenantHandoff: the fenced adoption of ONE tenant by a new owner.

The exactly-once contract across a handoff is three moves, all riding
the recovery machinery (recovery/) against the tenant's own journal dir
(tenancy/registry.py `journal_dir_for`, `<root>/tenants/<id>`):

  1. CLAIM — construct the tenant's RecoveryManager: it bumps the
     journaled fence generation durably (flock'd read-modify-write of
     `<dir>/FENCE`) BEFORE anything can actuate, and arms the zombie
     self-fence on the journal — the deposed owner's journal handle
     goes read-only the moment the claim lands.
  2. REPLAY — the same construction replays checkpoint + journal into
     the per-subsystem tables, so the new owner resumes the deposed
     owner's in-flight intent instead of re-deriving it. The provider's
     FenceValidator is seeded with the fresh generation: the deposed
     owner's in-flight `set_replicas`, stamped with the old generation,
     is rejected with `FenceRejected` — not applied.
  3. WARM-UP — the conservative hold: `allow_disruption()` stays False
     (and `ready()` reports warming) until `warmup_ticks` full ticks
     confirm fleet state, exactly the restarted-controller posture.

Without a journal dir (fencing not configured) adoption degrades to
the bookkeeping-only form: no generation, no replay, warm-up still held
— the unfenced deployment keeps its pre-replication semantics.

The port's copy of karpenter_tpu/replication/handoff.py.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Optional

from karpenter_tpu_torch.recovery.fence import FenceToken


class TenantHandoff:
    """One tenant's ownership record on ONE replica: claim -> replay ->
    warm-up -> serving, then `release()` when the partition moves."""

    def __init__(
        self,
        tenant: str,
        journal_dir: Optional[str] = None,
        validator=None,
        warmup_ticks: int = 1,
        clock: Callable[[], float] = _time.time,
    ):
        self.tenant = tenant
        self.journal_dir = journal_dir
        self.released = False
        self.recovery = None
        self.replay_seconds = 0.0
        t0 = _time.perf_counter()
        if journal_dir:
            from karpenter_tpu_torch.recovery import RecoveryManager

            # the claim: fence bump + journal replay + warm-up arming,
            # all in construction (recovery/manager.py boot sequence)
            self.recovery = RecoveryManager(
                journal_dir, clock=clock, warmup_ticks=warmup_ticks
            )
            self.replay_seconds = _time.perf_counter() - t0
            if validator is not None:
                validator.observe(self.recovery.fence.generation)
            self._warmup_remaining = self.recovery.warmup_remaining
        else:
            # unfenced: hold the conservative warm-up anyway — the new
            # owner has observed zero ticks of this tenant's fleet
            self._warmup_remaining = max(0, int(warmup_ticks))

    @property
    def generation(self) -> int:
        return self.recovery.fence.generation if self.recovery else 0

    def token(self) -> Optional[FenceToken]:
        """The stamp this owner's actuations carry (None when
        unfenced)."""
        return self.recovery.fence.token() if self.recovery else None

    def on_tick(self) -> None:
        """One full serving tick completed: advance the warm-up."""
        if self.recovery is not None:
            self.recovery.on_tick()
            self._warmup_remaining = self.recovery.warmup_remaining
        elif self._warmup_remaining > 0:
            self._warmup_remaining -= 1

    @property
    def warmup_remaining(self) -> int:
        return self._warmup_remaining

    def ready(self) -> bool:
        """Fully serving: warm-up drained, not released."""
        return not self.released and self._warmup_remaining <= 0

    def allow_disruption(self) -> bool:
        """The per-tenant disruption gate (consolidation/preemption must
        not plan against a fleet this owner has not yet confirmed)."""
        return self.ready()

    @property
    def state(self) -> str:
        if self.released:
            return "released"
        return "serving" if self._warmup_remaining <= 0 else "warmup"

    def release(self) -> None:
        """The partition moved away (or the replica is shutting down):
        checkpoint + close the journal so the successor replays one
        compact file. Idempotent."""
        if self.released:
            return
        self.released = True
        if self.recovery is not None:
            self.recovery.close()
