"""Write-ahead journal + checkpoint for controller protective state.

The store's own DurableStore (store/persistence.py) is the etcd analog:
it persists API OBJECTS. This journal persists what etcd never sees —
the in-process protective state controllers build ON TOP of those
objects (FSM phases, holds, budget spend, breaker/backoff state,
forecast rings). Same durability discipline, different payload:

  * records append as JSONL, flushed to the OS per append (survives
    process crash — the failure mode that matters for a leader-elected
    control plane); `fsync=True` additionally fsyncs, BATCHED every
    `fsync_every` appends so the sync cost stays off the per-append
    hot path;
  * every `compact_every` appends the journal checkpoints: the full
    current state (gathered from a provider callable) is written
    atomically and the journal truncates, so on-disk size is bounded
    by fleet size, not uptime;
  * recovery tolerates a TORN final record (crash mid-append): the
    fragment is discarded and the file truncated back to a record
    boundary, exactly like the store WAL.

Replay is a PURE FOLD (`replay`) over a tiny op vocabulary every
subsystem shares — `set`/`del` on a keyed table, bounded `append` for
ring samples — so determinism properties are structural: replaying the
same journal twice yields identical state, and checkpoint + journal
tail equals the full journal (both property-pinned in
tests/test_recovery.py).

Keys are tuples on the subsystem side and JSON strings on disk:
`key_str`/`key_tuple` round-trip them (nested tuples included).

The port's copy of karpenter_tpu/recovery/journal.py.
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

from karpenter_tpu_torch.faults import ProcessCrash, inject
from karpenter_tpu_torch.utils.log import logger

_CHECKPOINT = "state-checkpoint.json"
_JOURNAL = "state-journal.jsonl"

OPS = ("set", "del", "append")

# appends between zombie self-fence polls (journal docstring): bounds a
# superseded incarnation's stale-append window without paying a FENCE
# file read on every hot-path append
_OWNER_CHECK_EVERY = 64


def atomic_write(path: str, text: str, dir_fsync: bool = True) -> None:
    """Durably replace `path` with `text`: tmp write + fsync + rename +
    directory fsync, so a crash at any point leaves either the old file
    or the new one, never a torn mix. Shared by the checkpoint writer
    and the fence-generation claim — one copy of the durability-critical
    sequence to keep correct."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if dir_fsync:
        dir_fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)


def key_str(key: tuple) -> str:
    """Tuple key -> canonical JSON string (nested tuples become lists)."""

    def listify(x):
        if isinstance(x, (tuple, list)):
            return [listify(e) for e in x]
        return x

    return json.dumps(listify(key), sort_keys=True, separators=(",", ":"))


def key_tuple(s: str) -> tuple:
    """JSON string key -> tuple (nested lists become tuples)."""

    def tupleize(x):
        if isinstance(x, list):
            return tuple(tupleize(e) for e in x)
        return x

    return tupleize(json.loads(s))


def apply_record(state: Dict[str, dict], record: dict) -> None:
    """One pure fold step. Unknown subsystems create their table on
    first sight; unknown ops are ignored (forward compatibility — an
    older binary replaying a newer journal keeps what it understands)."""
    op = record.get("op")
    if op not in OPS:
        return
    table = state.setdefault(record["sub"], {})
    k = record["k"]
    if op == "set":
        table[k] = record["v"]
    elif op == "del":
        table.pop(k, None)
    else:  # append: bounded ring sample [t, value]
        ring = table.get(k)
        if not isinstance(ring, list):
            ring = table[k] = []  # last-write-wins on a key whose type changed
        ring.append([record["t"], record["v"]])
        cap = int(record.get("cap", 0))
        if cap and len(ring) > cap:
            del ring[: len(ring) - cap]


def replay(
    checkpoint: Optional[dict], records: List[dict]
) -> Dict[str, dict]:
    """Pure replay: fold `records` over the checkpoint state. Inputs are
    not mutated, so replaying the same journal twice from the same
    checkpoint yields identical state by construction."""
    state: Dict[str, dict] = copy.deepcopy(
        (checkpoint or {}).get("state", {})
    )
    for record in records:
        apply_record(state, record)
    return state


class JournalHandle:
    """A subsystem's bound append surface: `set`/`delete`/`append_sample`
    against its own table, stamped with the subsystem name."""

    __slots__ = ("_journal", "_sub")

    def __init__(self, journal: "StateJournal", sub: str):
        self._journal = journal
        self._sub = sub

    def set(self, key: tuple, value) -> None:
        self._journal.record(
            {"sub": self._sub, "op": "set", "k": key_str(key), "v": value}
        )

    def delete(self, key: tuple) -> None:
        self._journal.record(
            {"sub": self._sub, "op": "del", "k": key_str(key)}
        )

    def append_sample(
        self, key: tuple, t: float, value: float, cap: int = 0
    ) -> None:
        self._journal.record(
            {
                "sub": self._sub,
                "op": "append",
                "k": key_str(key),
                "t": float(t),
                "v": float(value),
                "cap": int(cap),
            }
        )


class StateJournal:
    """Append-only protective-state journal with periodic checkpoints
    (module docstring). `record()` never raises on I/O failure — memory
    stays authoritative and the journal marks itself dirty, healing via
    a full checkpoint on the next successful write (the DurableStore
    posture). The one deliberate exception: an injected `process.crash`
    fault (faults/registry.py) propagates after flushing HALF the
    encoded record, producing a REAL torn tail for the kill-and-restart
    chaos suite to recover through."""

    def __init__(
        self,
        journal_dir: str,
        fsync: bool = False,
        fsync_every: int = 64,
        compact_every: int = 4096,
        compact_min_interval_s: float = 30.0,
    ):
        self.journal_dir = journal_dir
        self.fsync = fsync
        self.fsync_every = max(1, int(fsync_every))
        self.compact_every = max(1, int(compact_every))
        # auto-compaction floor: per-tick journal traffic scales with
        # fleet size, so a pure record-count trigger would checkpoint
        # every few ticks on a large fleet — serializing the FULL state
        # (all forecast rings) under the journal lock on the reconcile
        # hot path. Count AND interval must both be exceeded; explicit
        # checkpoint()/boot/shutdown compactions are not throttled.
        self.compact_min_interval_s = compact_min_interval_s
        self._last_checkpoint = float("-inf")
        # gathered at compaction time by the RecoveryManager: () -> the
        # full {sub: {key_str: value}} state to checkpoint
        self.checkpoint_provider: Optional[Callable[[], dict]] = None
        # optional live fold: every successful record also applies into
        # this state dict (the RecoveryManager points it at its replayed
        # state), so checkpoints capture subsystems that journal through
        # a handle without registering a snapshot provider
        self.mirror: Optional[Dict[str, dict]] = None
        # zombie self-fence (the RecoveryManager wires it): returns True
        # while this incarnation still owns the journal dir. A stale
        # incarnation overlapping a rolling restart must stop writing —
        # its appends would override the live journal's records and its
        # close-time checkpoint would overwrite live state with stale
        # state. Polled every _OWNER_CHECK_EVERY appends (bounding a
        # zombie's damage window) and at EVERY checkpoint (the
        # destructive operation is checked exactly).
        self.owner_check: Optional[Callable[[], bool]] = None
        self._superseded = False
        self._since_owner_check = 0
        self._lock = threading.Lock()
        self._count = 0  # records since the last checkpoint
        self._since_fsync = 0
        self._dirty = False
        self._bytes = 0
        self._closed = False
        os.makedirs(journal_dir, exist_ok=True)
        self._file = open(self._journal_path, "a", encoding="utf-8")

    # -- paths -------------------------------------------------------------

    @property
    def _journal_path(self) -> str:
        return os.path.join(self.journal_dir, _JOURNAL)

    @property
    def _checkpoint_path(self) -> str:
        return os.path.join(self.journal_dir, _CHECKPOINT)

    def handle(self, sub: str) -> JournalHandle:
        return JournalHandle(self, sub)

    def journal_bytes(self) -> int:
        """Bytes appended since the last checkpoint (the
        karpenter_recovery_journal_bytes gauge)."""
        with self._lock:
            return self._bytes

    # -- append ------------------------------------------------------------

    def record(self, record: dict) -> None:
        with self._lock:
            if self._closed or self._superseded:
                return  # dead incarnation's handle: no-op
            if not self._ensure_file_locked():
                return  # reopen failed; retried on the next record
            if self._owner_lost_locked():
                return  # superseded mid-life: zombie goes read-only
            line = json.dumps(record, sort_keys=True) + "\n"
            self._crash_point(line)
            if self.mirror is not None:
                # fold BEFORE the write attempt: memory stays
                # authoritative even when the append below fails (the
                # heal checkpoint then carries the mirrored state)
                apply_record(self.mirror, record)
            try:
                self._append_locked(line)
            except OSError:
                self._dirty = True
                logger().exception(
                    "state journal append failed — protective-state "
                    "durability degraded until the next checkpoint"
                )

    def _ensure_file_locked(self) -> bool:
        """Reopen the append handle if a previous checkpoint's reopen
        failed (fd exhaustion, late ENOSPC). Without this, one failed
        reopen would silently end ALL protective-state journaling for
        the process lifetime — each record retries instead."""
        if self._file is not None and not self._file.closed:
            return True
        try:
            self._file = open(self._journal_path, "a", encoding="utf-8")
            return True
        except OSError:
            self._dirty = True
            logger().exception(
                "state journal reopen failed — retrying on the next "
                "record"
            )
            return False

    def _owner_lost_locked(self) -> bool:
        """Poll the zombie self-fence every _OWNER_CHECK_EVERY appends
        (and on the first): once a newer incarnation owns the dir, this
        journal goes permanently read-only."""
        if self.owner_check is None:
            return False
        self._since_owner_check -= 1
        if self._since_owner_check > 0:
            return False
        self._since_owner_check = _OWNER_CHECK_EVERY
        if self.owner_check():
            return False
        self._superseded = True
        if self._file is not None and not self._file.closed:
            self._file.close()
        logger().warning(
            "state journal superseded by a newer incarnation; this "
            "(stale) incarnation stops journaling"
        )
        return True

    def _crash_point(self, line: str) -> None:
        """The kill-and-restart chaos point: an injected crash flushes a
        REAL torn half-record (what a kernel page flush mid-write leaves
        behind) before the 'process dies'."""
        try:
            inject("process.crash.journal")
        except ProcessCrash:
            try:
                self._file.write(line[: max(1, len(line) // 2)])
                self._file.flush()
            except OSError:
                pass
            raise

    def _heal_locked(self) -> bool:
        """A previous append failed: the journal has a gap, so only a
        full checkpoint restores integrity. Heal from the provider or
        the mirror fold; with NEITHER there is no full-state source —
        keep appending (recovery still folds what landed) and stay
        dirty rather than claiming a heal that never happened."""
        state = None
        if self.checkpoint_provider is not None:
            state = self.checkpoint_provider()
        elif self.mirror is not None:
            state = {
                sub: dict(table) for sub, table in self.mirror.items()
            }
        if state is None:
            return False
        self._checkpoint_locked(state)
        self._dirty = False
        logger().warning("state journal healed via full checkpoint")
        return True

    def _append_locked(self, line: str) -> None:
        if self._dirty and self._heal_locked():
            return
        self._file.write(line)
        self._file.flush()
        self._count += 1
        self._bytes += len(line)
        self._since_fsync += 1
        if self.fsync and self._since_fsync >= self.fsync_every:
            os.fsync(self._file.fileno())
            self._since_fsync = 0
        if (
            self._count >= self.compact_every
            and self.checkpoint_provider is not None
            and _time.monotonic() - self._last_checkpoint
            >= self.compact_min_interval_s
        ):
            self._checkpoint_locked()

    # -- checkpoint --------------------------------------------------------

    def checkpoint(self, state: Optional[dict] = None) -> None:
        """Write a full checkpoint (from `state`, or the provider) and
        truncate the journal."""
        with self._lock:
            self._checkpoint_locked(state)
            self._dirty = False

    def _checkpoint_locked(self, state: Optional[dict] = None) -> None:
        if self._superseded:
            return
        if self.owner_check is not None and not self.owner_check():
            # EXACT check before the destructive op: a zombie's
            # checkpoint would overwrite live state with stale state
            # and truncate the live incarnation's journal
            self._superseded = True
            logger().warning(
                "state journal superseded by a newer incarnation; "
                "skipping this (stale) incarnation's checkpoint"
            )
            return
        if state is None:
            if self.checkpoint_provider is None:
                return
            state = self.checkpoint_provider()
        # atomic_write makes the rename durable BEFORE the journal
        # truncation below (else a power loss could pair the OLD
        # checkpoint with an empty journal)
        atomic_write(
            self._checkpoint_path,
            json.dumps({"state": state}, sort_keys=True),
        )
        # post-mortem breadcrumb (observability.flightrecorder): a
        # compaction re-bounds the journal — record how much it folded
        # so a restart-storm timeline shows journal growth vs re-bounds
        from karpenter_tpu_torch.observability import default_flight_recorder

        default_flight_recorder().record(
            "journal_compaction",
            records=self._count,
            bytes=self._bytes,
            tables=len(state),
        )
        self._last_checkpoint = _time.monotonic()
        if self._file is not None and not self._file.closed:
            self._file.close()
        try:
            self._file = open(self._journal_path, "w", encoding="utf-8")
        except OSError:
            # the truncating reopen failed: leave no handle and let the
            # next record() retry — journaling must not silently end
            self._file = None
            self._dirty = True
            logger().exception(
                "state journal reopen after checkpoint failed"
            )
            return
        if self.fsync:
            os.fsync(self._file.fileno())
        self._count = 0
        self._bytes = 0
        self._since_fsync = 0

    # -- recovery ----------------------------------------------------------

    def recover(self) -> Tuple[Optional[dict], List[dict]]:
        """(checkpoint doc or None, journal records) — torn-tail
        tolerant. Reads the files fresh, so it can be called on a
        journal another (crashed) incarnation wrote."""
        checkpoint = None
        if os.path.exists(self._checkpoint_path):
            with open(self._checkpoint_path, encoding="utf-8") as f:
                checkpoint = json.load(f)
        records = self._read_journal()
        return checkpoint, records

    def _read_journal(self) -> List[dict]:
        if not os.path.exists(self._journal_path):
            return []
        records: List[dict] = []
        valid_end = 0
        torn = False
        with open(self._journal_path, "rb") as f:
            for raw in f:
                line = raw.decode("utf-8", errors="replace").strip()
                if not line:
                    valid_end += len(raw)
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    # torn final append (crash mid-write): everything
                    # before it is intact — records are written whole
                    # under the journal lock
                    logger().warning(
                        "state journal: discarding torn record tail"
                    )
                    torn = True
                    break
                valid_end += len(raw)
        self._repair_tail(torn, valid_end)
        with self._lock:
            self._count = len(records)
            try:
                self._bytes = os.path.getsize(self._journal_path)
            except OSError:
                self._bytes = 0
            # reopen: recovery may have truncated under the append handle
            if self._file is not None and not self._file.closed:
                self._file.close()
            self._file = open(self._journal_path, "a", encoding="utf-8")
        return records

    def _repair_tail(self, torn: bool, valid_end: int) -> None:
        if torn:
            with open(self._journal_path, "rb+") as f:
                f.truncate(valid_end)
            return
        # repair a missing final newline (full record, torn terminator)
        # so the next append starts on a record boundary
        with open(self._journal_path, "rb+") as f:
            f.seek(0, os.SEEK_END)
            if f.tell() > 0:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._file is not None and not self._file.closed:
                try:
                    self._file.flush()
                    if self.fsync:
                        os.fsync(self._file.fileno())
                except OSError:
                    pass
                self._file.close()
