"""Durable store: write-ahead log + snapshot, the etcd role.

The reference has no custom persistence because all durable state lives in
CRD spec/status *in etcd* — controllers are stateless and resume by
re-listing on start (reference: SURVEY.md §5 checkpoint/resume;
controller-runtime informers re-list; the only memory between ticks is
status fields like LastScaleTime, pkg/autoscaler/autoscaler.go:111).

The TPU build's in-memory Store (store/store.py) replaces the apiserver bus,
so it must also replace etcd's durability: DurableStore journals every
mutation to a JSONL write-ahead log and periodically compacts into a full
snapshot, both under the store lock so the on-disk order is exactly the
resourceVersion order. Recovery = load snapshot, replay WAL, tolerate a
torn final record (crash mid-append). Controllers then resume by re-listing,
exactly the reference's posture — nothing outside spec/status survives.

Record encoding reuses the manifest codec (api/serialization.py) plus the
internal identity fields (uid/resourceVersion/creationTimestamp) that
to_dict deliberately omits from user-facing manifests; from_dict hydrates
them back because they are real ObjectMeta fields.

The port's copy of karpenter_tpu/store/persistence.py.
"""

from __future__ import annotations

import fcntl
import json
import os
import threading
from typing import Optional

from karpenter_tpu_torch.api.serialization import (
    KINDS,
    from_dict,
    from_manifest,
    to_dict,
)
from karpenter_tpu_torch.store.store import DELETED, Store, _key, _kind_of
from karpenter_tpu_torch.utils.log import logger

log = logger()

_SNAPSHOT = "snapshot.json"
_WAL = "wal.jsonl"

# Kinds that live in the store but are not user-facing manifest kinds
# (the apiserver has these too — e.g. coordination.k8s.io Leases — and
# etcd persists them all the same).
_EXTRA_KINDS: dict = {}


def register_persistent_kind(kind: str, cls: type) -> None:
    _EXTRA_KINDS[kind] = cls


def _builtin_extra_kinds() -> None:
    from karpenter_tpu_torch.leaderelection import Lease

    register_persistent_kind("Lease", Lease)


_builtin_extra_kinds()


def encode_object(obj) -> dict:
    """Manifest dict + internal identity, sufficient to reconstruct exactly."""
    doc = to_dict(obj)
    doc.setdefault("kind", _kind_of(obj))
    meta = doc.setdefault("metadata", {})
    meta["uid"] = obj.metadata.uid
    meta["resourceVersion"] = obj.metadata.resource_version
    meta["creationTimestamp"] = obj.metadata.creation_timestamp
    return doc


def decode_object(doc: dict):
    kind = doc.get("kind")
    if kind in KINDS:
        return from_manifest(doc)
    cls = _EXTRA_KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown persisted kind {kind!r}")
    body = {k: v for k, v in doc.items() if k not in ("apiVersion", "kind")}
    return from_dict(cls, body)


class DurableStore(Store):
    """Store with etcd-grade durability on a local data directory.

    fsync=True fsyncs every WAL append (slow, survives power loss);
    fsync=False (default) flushes to the OS on every append (survives
    process crash, the failure mode that matters for a leader-elected
    control plane — a peer takes over on machine loss, reference:
    cmd/controller/main.go:58-59).
    """

    def __init__(
        self,
        data_dir: str,
        fsync: bool = False,
        compact_every: int = 4096,
    ):
        super().__init__()
        self.data_dir = data_dir
        self.fsync = fsync
        self.compact_every = max(1, int(compact_every))
        self._wal_count = 0
        self._wal_file = None
        self._wal_dirty = False  # an append failed; WAL has a gap
        self._io_lock = threading.Lock()
        os.makedirs(data_dir, exist_ok=True)
        # exclusive data-dir lock: two processes appending to one WAL would
        # interleave records and corrupt the journal (leader election does
        # NOT protect against this — each process's lease lives in its own
        # store); fail fast like etcd does on a locked member dir
        self._lock_file = open(os.path.join(data_dir, "LOCK"), "w")
        try:
            fcntl.flock(self._lock_file, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lock_file.close()
            raise RuntimeError(
                f"data dir {data_dir} is locked by another process"
            ) from None
        self._recovering = True
        try:
            self._recover()
        finally:
            self._recovering = False
        self._wal_file = open(self._wal_path, "a", encoding="utf-8")

    # -- paths -------------------------------------------------------------

    @property
    def _snapshot_path(self) -> str:
        return os.path.join(self.data_dir, _SNAPSHOT)

    @property
    def _wal_path(self) -> str:
        return os.path.join(self.data_dir, _WAL)

    # -- recovery ----------------------------------------------------------

    def _recover(self) -> None:
        restored = 0
        if os.path.exists(self._snapshot_path):
            with open(self._snapshot_path, encoding="utf-8") as f:
                snap = json.load(f)
            self._rv = int(snap.get("rv", 0))
            for doc in snap.get("objects", []):
                self._restore(decode_object(doc))
                restored += 1
        replayed = self._replay_wal()
        if restored or replayed:
            log.info(
                "recovered %d objects (snapshot=%d, wal=%d) rv=%d from %s",
                len(self._objects), restored, replayed, self._rv, self.data_dir,
            )

    def _replay_wal(self) -> int:
        if not os.path.exists(self._wal_path):
            return 0
        replayed = 0
        valid_end = 0
        torn = False
        with open(self._wal_path, "rb") as f:
            for raw in f:
                line = raw.decode("utf-8", errors="replace").strip()
                if not line:
                    valid_end += len(raw)
                    continue
                try:
                    record = json.loads(line)
                except json.JSONDecodeError:
                    # torn final append from a crash — everything before it
                    # is intact because records are written atomically in
                    # rv order under the store lock
                    log.warning("wal: discarding torn record tail")
                    torn = True
                    break
                self._apply(record)
                replayed += 1
                valid_end += len(raw)
        if torn:
            # drop the fragment so the next append starts on a record
            # boundary rather than concatenating onto the torn line
            with open(self._wal_path, "rb+") as f:
                f.truncate(valid_end)
        else:
            # a crash can also persist a full valid record minus its
            # trailing newline; repair the boundary or the next append
            # would concatenate onto that line and a later recovery would
            # discard BOTH acknowledged records as one torn tail
            with open(self._wal_path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() > 0:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        f.write(b"\n")
        self._wal_count = replayed
        return replayed

    def _apply(self, record: dict) -> None:
        event = record["event"]
        obj = decode_object(record["object"])
        key = (
            record["object"]["kind"],
            obj.metadata.namespace,
            obj.metadata.name,
        )
        if event == DELETED:
            stored = self._objects.pop(key, None)
            if stored is not None:
                self._index_remove(stored)
        else:
            self._restore(obj)
        if isinstance(obj.metadata.resource_version, int):
            self._rv = max(self._rv, obj.metadata.resource_version)

    def _restore(self, obj) -> None:
        key = _key(obj)
        stored = self._objects.get(key)
        if stored is not None:
            self._index_remove(stored)
        self._objects[key] = obj
        self._index_add(obj)
        if isinstance(obj.metadata.resource_version, int):
            self._rv = max(self._rv, obj.metadata.resource_version)

    # -- write-time restorability gate -------------------------------------

    def _check_restorable(self, obj) -> None:
        """Fail at WRITE time if this kind could not be decoded at
        recovery: journaling an unregistered custom kind (easy to do —
        the scale subresource duck-types any spec.replicas object)
        would otherwise succeed silently and crash the NEXT process
        start inside _recover, far from the mistake."""
        kind = _kind_of(obj)
        if kind not in KINDS and kind not in _EXTRA_KINDS:
            raise ValueError(
                f"kind {kind!r} cannot be journaled durably: recovery "
                "could not decode it. Call store.persistence."
                f"register_persistent_kind({kind!r}, "
                f"{type(obj).__name__}) before storing it in a durable "
                "store."
            )

    def create(self, obj):
        self._check_restorable(obj)
        return super().create(obj)

    def update(self, obj):
        self._check_restorable(obj)
        return super().update(obj)

    def apply_event(self, event: str, obj) -> None:
        # every journaling entry path is gated, DELETED included: a
        # delete record of an unknown kind is decoded at recovery too
        self._check_restorable(obj)
        super().apply_event(event, obj)

    # -- journaling --------------------------------------------------------

    def _notify(self, event: str, obj) -> None:
        # called under the store lock at every mutation, with the stored
        # (post-mutation) object — journal BEFORE watchers observe, so a
        # crash between the two replays a superset of what watchers saw
        if not self._recovering:
            self._append({"event": event, "object": encode_object(obj)})
        super()._notify(event, obj)

    def _append(self, record: dict) -> None:
        """Journal one record. Never raises: memory is authoritative and
        watchers must observe exactly what memory holds, so an I/O failure
        degrades durability (loudly) instead of leaving the caller with a
        mutation that is half-acknowledged. A failed append leaves a gap in
        the WAL, so the store marks itself dirty and self-heals by writing
        a FULL snapshot (which supersedes the gappy WAL) as soon as I/O
        succeeds again."""
        with self._io_lock:
            try:
                if self._wal_dirty:
                    self._compact_locked()  # snapshot == full current state
                    self._wal_dirty = False
                    log.warning("wal: journal healed via full snapshot")
                    return
                self._wal_file.write(
                    json.dumps(record, sort_keys=True) + "\n"
                )
                self._wal_file.flush()
                if self.fsync:
                    os.fsync(self._wal_file.fileno())
                self._wal_count += 1
                if self._wal_count >= self.compact_every:
                    self._compact_locked()
            except OSError:
                self._wal_dirty = True
                log.exception(
                    "wal: append failed — durability degraded until the "
                    "next successful snapshot"
                )

    def _compact_locked(self) -> None:
        """Write a full snapshot atomically, then truncate the WAL.
        Caller holds _io_lock; the store lock is already held by the
        mutating caller, so the object map is consistent."""
        snap = {
            "rv": self._rv,
            "objects": [encode_object(o) for o in self._objects.values()],
        }
        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snapshot_path)
        # make the rename durable BEFORE truncating the WAL: if power is
        # lost with the truncation on disk but the rename not, recovery
        # would pair the OLD snapshot with an empty WAL and lose every
        # record since the previous compaction
        dir_fd = os.open(self.data_dir, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        self._wal_file.close()
        self._wal_file = open(self._wal_path, "w", encoding="utf-8")
        if self.fsync:
            os.fsync(self._wal_file.fileno())
        self._wal_count = 0

    def compact(self) -> None:
        """Force a snapshot + WAL truncation (tests, graceful shutdown)."""
        with self._lock, self._io_lock:
            self._compact_locked()

    def close(self) -> None:
        with self._io_lock:
            if self._wal_file is not None and not self._wal_file.closed:
                self._wal_file.flush()
                self._wal_file.close()
            if not self._lock_file.closed:
                self._lock_file.close()  # releases the flock


def open_store(data_dir: Optional[str], **kwargs) -> Store:
    """Factory: durable when a data dir is configured, in-memory otherwise."""
    if data_dir:
        return DurableStore(data_dir, **kwargs)
    return Store()
