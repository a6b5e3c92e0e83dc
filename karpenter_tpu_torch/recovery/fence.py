"""Actuation fencing: monotonic generation tokens on cloud writes (the
port's copy of karpenter_tpu/recovery/fence.py, which the fake provider's
FenceValidator needs).

The failure this closes: a controller crashes mid-actuation, restarts
(or worse, a split-brain duplicate keeps running), and REPLAYS a stale
scale decision against the cloud — undoing what the live incarnation
decided since. Borrowed from fencing tokens in distributed lock
services: every incarnation boots with a generation strictly greater
than any before it (persisted + fsynced in the journal dir BEFORE any
actuation), stamps that generation into every `set_replicas`/eviction
call, and the PROVIDER verifies the stamp before applying — a call
carrying a superseded generation is rejected with `FenceRejectedError`
instead of applied.

Two halves:

  * ActuationFence — controller side. One per incarnation; `token()`
    mints the stamp the ScalableNodeGroup controller passes to the
    provider. The generation is claimed durably at construction: a
    crash between boot and first actuation still burns the generation,
    so no later incarnation can ever be outranked by an earlier one.
  * FenceValidator — provider side (the fake, AWS, and TPU factories
    each own one). Tracks the highest generation it has admitted;
    `admit()` rejects anything older. Unstamped calls (token None)
    pass through — fencing is opt-in via `--journal-dir`, and an
    unfenced deployment keeps the old behavior.

`FenceRejectedError` is a RetryableError (code "FenceRejected"): the
stale incarnation's reconcile fails softly — the resource stays Active,
the breaker eventually opens on the zombie — while the live
incarnation, holding the newest generation, is never blocked.
"""

from __future__ import annotations

import fcntl
import os
import threading
from typing import NamedTuple, Optional

from karpenter_tpu_torch.controllers.errors import RetryableError

_FENCE_FILE = "FENCE"
_FENCE_LOCK = "FENCE.lock"


def read_generation(journal_dir: str) -> int:
    """The generation currently claimed in `journal_dir` (0 when none).
    The journal's zombie self-fence polls this: a stale incarnation
    detects it has been superseded and stops writing."""
    try:
        with open(
            os.path.join(journal_dir, _FENCE_FILE), encoding="utf-8"
        ) as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return 0

FENCE_REJECTED_CODE = "FenceRejected"


class FenceToken(NamedTuple):
    """The stamp on one actuation: which incarnation decided it."""

    generation: int


class FenceRejectedError(RetryableError):
    """An actuation carried a superseded fence generation: a stale
    (restarted-over or split-brain) controller tried to replay a dead
    decision. The provider did NOT apply it."""

    def __init__(self, message: str):
        super().__init__(message, code=FENCE_REJECTED_CODE)


class ActuationFence:
    """Controller-side generation source (module docstring).

    With `journal_dir`, the generation is read from / persisted to
    `<dir>/FENCE` and fsynced before __init__ returns — claiming the
    generation is durable BEFORE any actuation can carry it. Without a
    dir (tests, ephemeral runs) the generation is whatever `generation`
    says (default 1)."""

    def __init__(
        self,
        journal_dir: Optional[str] = None,
        generation: Optional[int] = None,
    ):
        if generation is not None:
            self.generation = int(generation)
            self.path = None
            return
        if journal_dir is None:
            self.generation = 1
            self.path = None
            return
        os.makedirs(journal_dir, exist_ok=True)
        self.path = os.path.join(journal_dir, _FENCE_FILE)
        from karpenter_tpu_torch.recovery.journal import atomic_write

        # the claim is a read-modify-write: serialize concurrent boots
        # under an exclusive flock, or two simultaneous starts would
        # claim EQUAL generations and neither would ever be fenced
        with open(
            os.path.join(journal_dir, _FENCE_LOCK), "w"
        ) as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            self.generation = read_generation(journal_dir) + 1
            atomic_write(self.path, str(self.generation))
            # flock releases when lock_file closes

    def token(self) -> FenceToken:
        return FenceToken(generation=self.generation)


class FenceValidator:
    """Provider-side fence enforcement (module docstring). One per
    provider factory — the cloud is shared infrastructure, so every
    controller incarnation actuating through one factory races against
    the same highest-seen generation.

    Scope: the validator's memory is per factory INSTANCE, so
    cross-process enforcement requires either a shared factory (the
    in-process store-as-apiserver deployment and the chaos harness) or
    seeding: the runtime calls `observe(generation)` with its freshly
    claimed fence generation at boot, so a restarted process's own
    provider immediately outranks every earlier incarnation without
    waiting for a first actuation. A REAL cloud binding that spans
    machines should additionally translate the token into the cloud's
    own conditional-write/lease primitive; the SPI carries the token to
    the provider edge exactly so a binding can."""

    def __init__(self):
        self._lock = threading.Lock()
        self.highest_seen = 0
        self.rejections = 0

    def observe(self, generation: int) -> None:
        """Record a known-live generation WITHOUT an actuation: raises
        the floor so stamps older than `generation` are rejected even
        before the new incarnation's first provider write."""
        with self._lock:
            self.highest_seen = max(self.highest_seen, int(generation))

    def admit(self, token: Optional[FenceToken]) -> None:
        """Verify one actuation's stamp BEFORE applying it. Raises
        FenceRejectedError for a superseded generation; records the
        generation otherwise. token=None (unfenced caller) is admitted
        unchecked."""
        if token is None:
            return
        with self._lock:
            if token.generation < self.highest_seen:
                self.rejections += 1
                raise FenceRejectedError(
                    f"actuation fence rejected generation "
                    f"{token.generation} (provider has admitted "
                    f"generation {self.highest_seen}): stale controller "
                    "incarnation replaying a dead decision"
                )
            self.highest_seen = token.generation
