"""Metric history store: bounded columnar ring buffers per series.

The reference reads one instantaneous value per reconcile and throws it
away; forecasting needs the trajectory. This store is the retention
layer: each series (an HA's metric, or a raw client query) owns a
fixed-capacity ring of (timestamp, value) columns — appends are O(1)
array writes, snapshots are two slice copies, and memory is bounded by
construction (capacity × max_series), so a fleet of thousands of
autoscalers costs megabytes, not growth.

Keys are tuples; the two producers in the stack use:

  ("ha", namespace, name, metric_index)   BatchAutoscaler snapshot path
  ("q", metric_name, sorted-label-tuple)  metrics-client observation path

The query-keyed series double as a WARM POOL: a freshly created HA whose
query was already being observed (by another HA, or by earlier client
reads) seeds its own series from the query series instead of starting
cold (`seed`), so forecasting starts `min_samples` ticks sooner.

Lifecycle: the store lives on the runtime (it survives engine requeues
and controller deactivation/reactivation by construction); `prune`
drops every series of a deleted HorizontalAutoscaler — wired through the
HA controller's on_deleted hook. When max_series is exceeded the
least-recently-appended series is evicted, so leaked keys (renamed
queries) age out instead of accumulating.

The port's copy of karpenter_tpu/forecast/history.py, changed only in
its imports.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np


class _Ring:
    __slots__ = ("ts", "values", "start", "count")

    def __init__(self, capacity: int):
        # f64 timestamps: epoch seconds lose sub-second precision in f32
        self.ts = np.zeros(capacity, np.float64)
        self.values = np.zeros(capacity, np.float32)
        self.start = 0
        self.count = 0

    def append(self, t: float, value: float) -> None:
        cap = self.ts.shape[0]
        if self.count < cap:
            i = (self.start + self.count) % cap
            self.count += 1
        else:
            i = self.start
            self.start = (self.start + 1) % cap
        self.ts[i] = t
        self.values[i] = value

    def chronological(self) -> Tuple[np.ndarray, np.ndarray]:
        cap = self.ts.shape[0]
        idx = (self.start + np.arange(self.count)) % cap
        return self.ts[idx], self.values[idx]

    def last(self) -> Optional[Tuple[float, float]]:
        if self.count == 0:
            return None
        cap = self.ts.shape[0]
        i = (self.start + self.count - 1) % cap
        return float(self.ts[i]), float(self.values[i])


class MetricHistoryStore:
    """Thread-safe map of series key -> bounded ring (module docstring)."""

    def __init__(self, capacity: int = 64, max_series: int = 4096):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = capacity
        self.max_series = max_series
        self._rings: Dict[tuple, _Ring] = {}
        self._touched: Dict[tuple, float] = {}  # key -> last append time
        self._lock = threading.Lock()
        # crash safety (karpenter_tpu/recovery): a JournalHandle
        # recording appends (bounded by the ring capacity — the journal
        # fold keeps only the newest `cap` samples per key), so forecast
        # history survives a controller restart instead of cold-starting
        # every series
        self.journal = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._rings)

    def append(self, key: tuple, t: float, value: float) -> None:
        """Record one observation. Non-finite values are dropped — a NaN
        in the window would poison every downstream recurrence."""
        if not np.isfinite(value):
            return
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = _Ring(self.capacity)
                if len(self._rings) > self.max_series:
                    self._evict_oldest_locked()
            ring.append(float(t), float(value))
            self._touched[key] = float(t)
        if self.journal is not None:
            self.journal.append_sample(
                key, float(t), float(value), cap=self.capacity
            )

    def _evict_oldest_locked(self) -> None:
        victim = min(self._touched, key=self._touched.get, default=None)
        if victim is not None:
            self._rings.pop(victim, None)
            self._touched.pop(victim, None)

    def series(self, key: tuple) -> Tuple[np.ndarray, np.ndarray]:
        """(timestamps f64, values f32) in chronological order; empty
        arrays for an unknown key."""
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                return np.zeros(0, np.float64), np.zeros(0, np.float32)
            return ring.chronological()

    def last(self, key: tuple) -> Optional[Tuple[float, float]]:
        """Newest (timestamp, value), or None."""
        with self._lock:
            ring = self._rings.get(key)
            return None if ring is None else ring.last()

    def count(self, key: tuple) -> int:
        with self._lock:
            ring = self._rings.get(key)
            return 0 if ring is None else ring.count

    def seed(self, key: tuple, from_key: tuple) -> bool:
        """Copy `from_key`'s ring into an EMPTY `key` (the warm-pool
        path for a fresh HA over an already-observed query)."""
        with self._lock:
            if self._rings.get(key) is not None:
                return False
            src = self._rings.get(from_key)
            if src is None or src.count == 0:
                return False
            ring = _Ring(self.capacity)
            ts, vs = src.chronological()
            for t, v in zip(ts, vs):
                ring.append(float(t), float(v))
            self._rings[key] = ring
            self._touched[key] = self._touched.get(from_key, float(ts[-1]))
            if len(self._rings) > self.max_series:
                # same bound append() enforces: seeding must not grow
                # the store past capacity x max_series
                self._evict_oldest_locked()
            return True

    def prune(self, *prefix) -> int:
        """Drop every series whose key starts with `prefix` (e.g.
        prune("ha", namespace, name) on HA deletion); returns the count
        dropped."""
        with self._lock:
            victims = [
                k for k in self._rings if k[: len(prefix)] == tuple(prefix)
            ]
            for k in victims:
                del self._rings[k]
                self._touched.pop(k, None)
        if self.journal is not None:
            for k in victims:
                self.journal.delete(k)
        return len(victims)

    # -- crash-safe snapshot/restore (karpenter_tpu/recovery) --------------

    def snapshot_rings(self) -> Dict[str, list]:
        """Columnar checkpoint of every ring: {key_str: [[t, v], ...]}
        in chronological order — the recovery checkpoint format (the
        journal fold produces the same shape from appends)."""
        from karpenter_tpu_torch.recovery.journal import key_str

        with self._lock:
            items = [
                (key, ring.chronological())
                for key, ring in self._rings.items()
            ]
        return {
            key_str(key): [
                [float(t), float(v)] for t, v in zip(ts, vs)
            ]
            for key, (ts, vs) in items
        }

    def restore_ring(self, key: tuple, samples: list) -> None:
        """Rebuild one series from replayed [t, value] samples WITHOUT
        re-journaling them (the caller just read them from the journal)."""
        if not samples:
            return
        with self._lock:
            ring = _Ring(self.capacity)
            for t, v in samples[-self.capacity:]:
                ring.append(float(t), float(v))
            self._rings[key] = ring
            self._touched[key] = float(samples[-1][0])
            if len(self._rings) > self.max_series:
                self._evict_oldest_locked()

    # -- batched snapshot --------------------------------------------------

    def matrix(
        self, keys: List[tuple], now: float, length: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Right-aligned [K, L] snapshot of `keys` for the batched
        forecaster: (values f32, valid bool, times f32 relative to
        `now`, step_s f32 mean spacing). L defaults to the ring
        capacity; series shorter than L are left-padded invalid — the
        layout forecast/models.py is specified against."""
        L = self.capacity if length is None else length
        K = len(keys)
        values = np.zeros((K, L), np.float32)
        valid = np.zeros((K, L), bool)
        times = np.zeros((K, L), np.float32)
        step_s = np.zeros(K, np.float32)
        for i, key in enumerate(keys):
            ts, vs = self.series(key)
            n = min(len(vs), L)
            if n == 0:
                continue
            ts, vs = ts[-n:], vs[-n:]
            values[i, L - n:] = vs
            valid[i, L - n:] = True
            times[i, L - n:] = (ts - float(now)).astype(np.float32)
            if n >= 2:
                step_s[i] = np.float32((ts[-1] - ts[0]) / (n - 1))
        return values, valid, times, step_s
