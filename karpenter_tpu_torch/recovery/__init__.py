"""Crash-safe controller state (docs/resilience.md "Crash recovery").

The reference Karpenter keeps all reconcile state in the kube-apiserver,
so a controller restart is harmless. This build accumulated rich
in-process PROTECTIVE state — the consolidation cordon→verify→drain FSM,
preemption holds and eviction-budget spend, actuation circuit breakers,
per-object requeue backoff, and the forecast history/skill — that a
crash would erase, turning a restart into exactly the
disruption-amplification event those safety layers exist to prevent.
This package makes that state durable:

  * StateJournal (journal.py) — a write-ahead journal + periodic
    checkpoint for protective state, bounded by compaction, with a pure
    deterministic replay fold (property-pinned: replaying a journal
    twice is a no-op, and checkpoint+tail == full journal);
  * ActuationFence / FenceValidator (fence.py) — a monotonic generation
    token stamped into every cloud set_replicas call and verified by
    the provider before apply, so a restarted (or split-brain
    duplicate) controller cannot replay a stale decision;
  * RecoveryManager (manager.py) — boot orchestration: replay the
    journal, hand each subsystem its restored state, invalidate
    identity-keyed device caches, and hold a conservative WARM-UP
    (no scale-down or eviction) until one full reconcile tick has
    confirmed fleet state.

Wired through runtime.Options (`--journal-dir`,
`--recovery-warmup-ticks`) and exercised by the seeded kill-and-restart
chaos suite (`make test-recovery`).

The port's copy of karpenter_tpu/recovery/__init__.py.
"""

from karpenter_tpu_torch.recovery.fence import (
    ActuationFence,
    FenceRejectedError,
    FenceToken,
    FenceValidator,
)
from karpenter_tpu_torch.recovery.journal import (
    JournalHandle,
    StateJournal,
    key_str,
    key_tuple,
    replay,
)
from karpenter_tpu_torch.recovery.manager import RecoveryManager

__all__ = [
    "ActuationFence",
    "FenceRejectedError",
    "FenceToken",
    "FenceValidator",
    "JournalHandle",
    "RecoveryManager",
    "StateJournal",
    "key_str",
    "key_tuple",
    "replay",
]
