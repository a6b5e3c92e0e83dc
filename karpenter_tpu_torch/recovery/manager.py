"""RecoveryManager: boot-time replay, warm-up, and the checkpoint loop.

One per runtime (built when `--journal-dir` is set). Construction does
the crash-recovery boot sequence:

  1. claim a fresh fence generation (durably, BEFORE anything can
     actuate — fence.py);
  2. replay checkpoint + journal into per-subsystem state tables (the
     pure fold in journal.py), timing it for the
     karpenter_recovery_replay_seconds gauge;
  3. if anything was recovered (or the fence shows a prior
     incarnation), arm the WARM-UP: `allow_disruption()` stays False
     until `warmup_ticks` full manager ticks have completed — the
     consolidation and preemption engines gate their planning on it, so
     a freshly restarted controller confirms fleet state before any
     scale-down or eviction.

The runtime then hands each subsystem its table (`table(sub)`) to
restore from, registers live-state snapshot providers
(`register_snapshot`), and calls `finish_boot()` — which writes a
compacted checkpoint of the replayed state, so a restart STORM cannot
grow the journal (every boot re-bounds it).

Subsystems not running this incarnation (e.g. consolidation toggled
off) keep their replayed tables verbatim in every checkpoint — their
state survives a feature toggle across restarts instead of being
silently dropped.

The port's copy of karpenter_tpu/recovery/manager.py.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Dict, Optional

from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.recovery.fence import ActuationFence, read_generation
from karpenter_tpu_torch.recovery.journal import JournalHandle, StateJournal, replay
from karpenter_tpu_torch.utils.log import logger

SUBSYSTEM = "recovery"

REPLAY_SECONDS = "replay_seconds"
JOURNAL_BYTES = "journal_bytes"
WARMUP_TICKS_REMAINING = "warmup_ticks_remaining"
FENCE_REJECTIONS = "fence_rejections_total"


class RecoveryManager:
    def __init__(
        self,
        journal_dir: str,
        registry: Optional[GaugeRegistry] = None,
        clock: Callable[[], float] = _time.time,
        warmup_ticks: int = 1,
        fsync: bool = False,
        compact_every: int = 4096,
    ):
        self.clock = clock
        self.journal = StateJournal(
            journal_dir, fsync=fsync, compact_every=compact_every
        )
        self.fence = ActuationFence(journal_dir)
        # zombie self-fence: once a NEWER incarnation claims the dir,
        # this journal goes read-only — a stale overlapping incarnation
        # (rolling restart, split brain) cannot override the live
        # incarnation's records or overwrite its checkpoint at close
        generation = self.fence.generation
        self.journal.owner_check = (
            lambda: read_generation(journal_dir) == generation
        )
        t0 = _time.perf_counter()
        checkpoint, records = self.journal.recover()
        self.state: Dict[str, dict] = replay(checkpoint, records)
        self.replay_seconds = _time.perf_counter() - t0
        # a prior incarnation existed iff there was anything to replay
        # or the fence file already carried a generation; first boot
        # (nothing recovered) skips the warm-up — there is no pre-crash
        # state whose confirmation could be pending
        self.recovered = bool(
            checkpoint is not None or records or self.fence.generation > 1
        )
        self.warmup_total = max(0, int(warmup_ticks))
        self.warmup_remaining = self.warmup_total if self.recovered else 0
        # live-state snapshot providers: sub -> () -> {key_str: value};
        # checkpoints merge these OVER the replayed tables
        self._snapshots: Dict[str, Callable[[], dict]] = {}
        self.journal.checkpoint_provider = self._gather_state
        # every journaled record also folds into self.state, so
        # checkpoints capture live appends even for subsystems that
        # never register a snapshot provider
        self.journal.mirror = self.state
        self._g_replay = self._g_bytes = self._g_warmup = None
        self._c_fence_rejections = None
        if registry is not None:
            reg = registry.register
            self._g_replay = reg(SUBSYSTEM, REPLAY_SECONDS)
            self._g_bytes = reg(SUBSYSTEM, JOURNAL_BYTES)
            self._g_warmup = reg(SUBSYSTEM, WARMUP_TICKS_REMAINING)
            self._c_fence_rejections = reg(
                SUBSYSTEM, FENCE_REJECTIONS, kind="counter"
            )
            self._g_replay.set("-", "-", self.replay_seconds)
            self._g_warmup.set("-", "-", float(self.warmup_remaining))
        if self.recovered:
            logger().info(
                "recovery: replayed %d protective-state table(s) in "
                "%.3fs (fence generation %d); warm-up holds disruption "
                "for %d tick(s)",
                len(self.state), self.replay_seconds,
                self.fence.generation, self.warmup_remaining,
            )

    # -- state surface -----------------------------------------------------

    def handle(self, sub: str) -> JournalHandle:
        """The append surface a subsystem journals through."""
        return self.journal.handle(sub)

    def table(self, sub: str) -> dict:
        """The replayed {key_str: value} table a subsystem restores
        from (empty dict when nothing was journaled for it)."""
        return self.state.get(sub, {})

    def register_snapshot(self, sub: str, fn: Callable[[], dict]) -> None:
        """Register a live-state provider for checkpoints: `fn()`
        returns the subsystem's CURRENT full table."""
        self._snapshots[sub] = fn

    def _gather_state(self) -> dict:
        state = {
            sub: dict(table)
            for sub, table in self.state.items()
            if sub not in self._snapshots
        }
        for sub, fn in self._snapshots.items():
            try:
                state[sub] = fn()
            except Exception:  # noqa: BLE001 — a failing snapshot must
                # not lose the subsystem's previous state wholesale
                logger().exception(
                    "recovery: snapshot provider for %r failed; "
                    "checkpoint keeps the replayed table", sub,
                )
                state[sub] = dict(self.state.get(sub, {}))
        return state

    def finish_boot(self) -> None:
        """Compact after replay: every boot re-bounds the journal, so a
        restart storm cannot grow it without bound."""
        self.journal.checkpoint()
        if self._g_bytes is not None:
            self._g_bytes.set(
                "-", "-", float(self.journal.journal_bytes())
            )

    # -- warm-up -----------------------------------------------------------

    def allow_disruption(self) -> bool:
        """The disruption gate the consolidation and preemption engines
        consult: False while warm-up ticks remain."""
        return self.warmup_remaining <= 0

    def on_tick(self) -> None:
        """Manager tick hook: one full reconcile pass completed —
        advance the warm-up and refresh the point-in-time gauges."""
        if self.warmup_remaining > 0:
            self.warmup_remaining -= 1
            if self.warmup_remaining == 0:
                logger().info(
                    "recovery: warm-up complete; disruption "
                    "(consolidation/preemption) re-enabled"
                )
        if self._g_warmup is not None:
            self._g_warmup.set("-", "-", float(self.warmup_remaining))
        if self._g_bytes is not None:
            self._g_bytes.set(
                "-", "-", float(self.journal.journal_bytes())
            )

    def count_fence_rejection(self) -> None:
        """Fed by the ScalableNodeGroup controller when a provider
        rejects a stale stamp (karpenter_recovery_fence_rejections_total)."""
        if self._c_fence_rejections is not None:
            self._c_fence_rejections.inc("-", "-")
        # a fence rejection means THIS incarnation is the stale one —
        # exactly the post-mortem a flight-recorder dump should explain
        from karpenter_tpu_torch.observability import default_flight_recorder

        default_flight_recorder().record(
            "fence_rejection", generation=self.fence.generation
        )

    def close(self) -> None:
        """Graceful shutdown: checkpoint the live state (a clean restart
        then replays one compact file) and release the journal."""
        try:
            self.journal.checkpoint()
        except Exception:  # noqa: BLE001 — closing must not raise past
            # the runtime teardown; the journal alone still recovers
            logger().exception("recovery: final checkpoint failed")
        self.journal.close()
