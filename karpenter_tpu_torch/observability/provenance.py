"""Decision provenance ledger: WHY did this group scale to N this tick?

The control plane's decisions are multi-stage — reactive decide ->
forecast blend (docs/forecasting.md) -> cost/SLO refinement with
movement-bound clamps (docs/cost.md) -> warm pools -> per-tenant
admission and breaker rungs (docs/multitenancy.md) — but until this
layer an operator asking "why did tenant X's group scale to N?" had to
reconstruct the answer from trace spans and scattered gauges. The
DecisionLedger records, for every HorizontalAutoscaler decision, the
full input chain as ONE structured record:

  observed metric values | forecast value/skill + whether the blend won
  | the cost-ladder candidate chosen with its risk/cost score and any
  budget/movement-bound clamp | warm-pool headroom | the solver backend
  + degradation rung actually used (device/sidecar/shard/numpy/mirror/
  floor) | tenant id + admission round | the reconcile trace id as a
  backlink into --trace-export / /debug/traces.

Storage discipline is the forecast history store's (forecast/history.py):
a BOUNDED COLUMNAR RING — preallocated numpy arrays per column, batch
appends as O(columns) slice assignments per *batched dispatch*, never
O(decisions) Python objects on the reconcile hot path. Python dicts are
only built at QUERY time (/debug/decisions, the JSONL export, the
--simulate "why" report), off the hot path.

Annotation model (mirrors the tracer's TLS threading): the subsystem
that OWNS a batch begins a staging LedgerBatch — the BatchAutoscaler for
the single-tenant fleet pass, the MultiTenantScheduler for cross-tenant
batches — and every subsystem the batch flows through annotates its own
slice where the arrays already are: the decide kernel outputs, the
forecast pass, CostEngine.adjust, the SolverService dispatch, the
tenancy scatter. In-thread code reaches the current batch through
`default_ledger().current()` with no parameter threading.

Posture matches tracing: DEFAULT OFF (`--provenance` enables). A
disabled ledger costs one attribute read per site and records nothing —
decisions are byte-identical with the ledger on or off (the ledger only
observes; tests/test_provenance.py property-pins both), and `make
bench-provenance` publishes the enabled-vs-disabled tick overhead
(<=5% target, docs/BENCHMARKS.md).

The port's copy of karpenter_tpu/observability/provenance.py, changed
only in its imports.
"""

from __future__ import annotations

import json
import math
import threading
import time as _time
from typing import Dict, List, Optional, Sequence

import numpy as np

SUBSYSTEM = "provenance"

# fixed width of the per-record observed-metric-values slice: a columnar
# ring cannot carry ragged rows, and fleets past 4 metrics per HA are
# vanishingly rare (observed_n records how many were real)
OBSERVED_WIDTH = 4

# winning-stage vocabulary (docs/observability.md "Decision provenance"):
# the single stage that best explains the final desired count, computed
# at commit with this precedence (first match wins)
STAGE_COST_BLIND = "cost_blind"
STAGE_COST_RAISE = "cost_raise"
STAGE_COST_CLAMP = "cost_clamp"
STAGE_FORECAST_BLEND = "forecast_blend"
STAGE_DEGRADED_FLOOR = "degraded_floor"
STAGE_ADMISSION_DEFERRAL = "admission_deferral"
STAGE_REACTIVE = "reactive"
# the full vocabulary in precedence order — the stable label index
# space consumers (simlab/labels.py label_stream) encode against
STAGES = (
    STAGE_COST_BLIND,
    STAGE_COST_RAISE,
    STAGE_COST_CLAMP,
    STAGE_FORECAST_BLEND,
    STAGE_DEGRADED_FLOOR,
    STAGE_ADMISSION_DEFERRAL,
    STAGE_REACTIVE,
)

# column schema: name -> (dtype, fill). Object columns hold interned
# strings (names that already exist elsewhere); numeric fills mark
# "never annotated" (NaN / -1) so queries can render them as null.
_NUMERIC_COLUMNS = (
    ("ts", np.float64, 0.0),
    ("seq", np.int64, 0),
    ("observed_n", np.int16, 0),
    ("prev_replicas", np.int32, -1),
    ("base_desired", np.int32, -1),
    ("final_desired", np.int32, -1),
    ("forecast_value", np.float32, np.nan),
    ("forecast_skill", np.float32, np.nan),
    ("forecast_blend", bool, False),
    ("forecast_active", bool, False),
    ("slo_opted", bool, False),
    ("cost_candidate", np.int32, -1),
    ("cost_risk", np.float32, np.nan),
    ("cost_hourly", np.float32, np.nan),
    ("cost_score", np.float32, np.nan),
    ("budget_clamped", bool, False),
    ("movement_clamped", bool, False),
    ("cost_blind", bool, False),
    ("pool_grouped", bool, False),
    ("pool_joint_repair", bool, False),
    ("warm_headroom", np.int32, -1),
    ("admission_round", np.int16, -1),
    ("deferred", bool, False),
)
_OBJECT_COLUMNS = (
    ("kind", ""),
    ("tenant", ""),
    ("namespace", ""),
    ("name", ""),
    ("group", ""),
    ("trace", ""),
    ("solver_backend", ""),
    ("solver_rung", ""),
    ("winning_stage", ""),
)
_COLUMN_FILLS: Dict[str, object] = {
    **{name: fill for name, _dtype, fill in _NUMERIC_COLUMNS},
    **dict(_OBJECT_COLUMNS),
}


class LedgerBatch:
    """Staging area for one batched dispatch's records: plain numpy
    columns of length `n`, committed to the ring in O(columns) slice
    assignments. `autosolver=True` marks a batch whose solver
    backend/rung annotation comes from inside SolverService.decide/cost
    (the BatchAutoscaler flow); the MultiTenantScheduler stamps rungs
    per tenant slice itself and leaves it False."""

    __slots__ = ("n", "cols", "autosolver")

    def __init__(self, n: int, autosolver: bool = False):
        self.n = n
        self.cols: Dict[str, object] = {}
        self.autosolver = autosolver

    def annotate(self, **columns) -> None:
        """Set whole-batch columns: each value is a scalar (broadcast)
        or a length-n sequence/array."""
        self.cols.update(columns)

    def _materialize(self, name: str) -> np.ndarray:
        """The column as a writable length-n array: a scalar (or
        absent) column broadcasts into a full array first, so partial
        writes compose with whole-batch annotations in either order."""
        staged = self.cols.get(name)
        if isinstance(staged, np.ndarray) and staged.shape:
            return staged
        fill = staged if staged is not None else _COLUMN_FILLS.get(name, 0)
        if isinstance(fill, (list, tuple)):
            staged = np.asarray(
                fill, object if any(
                    isinstance(v, str) for v in fill
                ) else None
            )
        elif isinstance(fill, str):
            staged = np.empty(self.n, object)
            staged[:] = fill
        else:
            staged = np.full(self.n, fill)
        self.cols[name] = staged
        return staged

    def annotate_rows(self, rows: Sequence[int], **columns) -> None:
        """Scatter values into a subset of rows (e.g. the SLO-opted
        rows of a cost pass); `columns` values are scalars or arrays
        indexed LIKE THE BATCH (length n — the cost outputs are already
        row-aligned with the decide batch)."""
        idx = np.asarray(list(rows), np.int64)
        for name, value in columns.items():
            staged = self._materialize(name)
            value = np.asarray(value)
            staged[idx] = value[idx] if value.shape else value

    def annotate_slice(self, start: int, stop: int, **columns) -> None:
        """Set columns on a contiguous row slice (the tenancy scatter:
        one tenant's rows inside a concatenated batch); values are
        scalars or length-(stop-start) arrays."""
        for name, value in columns.items():
            self._materialize(name)[start:stop] = value


class DecisionLedger:
    """Bounded columnar provenance ring (module docstring)."""

    def __init__(
        self,
        capacity: int = 4096,
        clock=_time.time,
        enabled: bool = False,
    ):
        self.enabled = enabled
        self.capacity = capacity
        self._clock = clock
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._head = 0  # next write slot
        self._size = 0  # valid records in the ring
        self._seq = 0
        self.records_total = 0
        self.records_dropped = 0
        self._rings: Dict[str, np.ndarray] = {}
        for name, dtype, fill in _NUMERIC_COLUMNS:
            self._rings[name] = np.full(capacity, fill, dtype)
        for name, fill in _OBJECT_COLUMNS:
            ring = np.empty(capacity, object)
            ring[:] = fill
            self._rings[name] = ring
        self._rings["observed"] = np.zeros(
            (capacity, OBSERVED_WIDTH), np.float32
        )
        self._c_records = self._c_dropped = None

    def bind_registry(self, registry) -> None:
        """karpenter_provenance_{records,dropped}_total."""
        self._c_records = registry.register(
            SUBSYSTEM, "records_total", kind="counter"
        )
        self._c_dropped = registry.register(
            SUBSYSTEM, "dropped_total", kind="counter"
        )

    # -- staging -----------------------------------------------------------

    def begin(
        self,
        kind: str,
        count: int,
        autosolver: bool = False,
        **columns,
    ) -> Optional[LedgerBatch]:
        """Open the staging batch for one batched dispatch and make it
        this thread's CURRENT batch (annotation sites reach it through
        current()). None when disabled — callers guard on `enabled`
        first, so the disabled hot path is one attribute read."""
        if not self.enabled or count <= 0:
            return None
        batch = LedgerBatch(count, autosolver=autosolver)
        batch.annotate(kind=kind, **columns)
        trace = _current_trace_id()
        if trace and "trace" not in columns:
            batch.annotate(trace=trace)
        self._tls.batch = batch
        return batch

    def current(self) -> Optional[LedgerBatch]:
        if not self.enabled:
            return None
        return getattr(self._tls, "batch", None)

    def abort(self, batch: Optional[LedgerBatch] = None) -> None:
        if getattr(self._tls, "batch", None) is (batch or self.current()):
            self._tls.batch = None

    # -- commit (the columnar append) --------------------------------------

    def commit(self, batch: Optional[LedgerBatch] = None) -> int:  # lint: allow-complexity — the columnar append: one arm per column class (ts/seq/staged/fill)
        """Append the staged batch to the ring: one (wrap-aware) slice
        assignment per column. Returns the records written."""
        if batch is None:
            batch = self.current()
        if batch is None:
            return 0
        if getattr(self._tls, "batch", None) is batch:
            self._tls.batch = None
        n = batch.n
        cols = batch.cols
        if "winning_stage" not in cols:
            cols["winning_stage"] = self._winning_stages(batch)
        now = self._clock()
        if n == 1:
            # the common single-HA tick: per-item writes skip the
            # slice-assignment broadcast machinery (~4x cheaper per
            # column, and the bench-provenance <=5% budget is paid in
            # exactly this shape)
            return self._commit_single(cols, now)
        with self._lock:
            keep = min(n, self.capacity)
            skip = n - keep  # oversized batch: oldest rows drop
            head = self._head
            for name, ring in self._rings.items():
                if name == "ts":
                    self._ring_write(ring, head, keep, now)
                elif name == "seq":
                    self._ring_write(
                        ring, head, keep,
                        np.arange(
                            self._seq + 1 + skip,
                            self._seq + 1 + n,
                            dtype=np.int64,
                        ),
                    )
                else:
                    value = cols.get(name, _COLUMN_FILLS.get(name, 0))
                    if isinstance(value, (list, tuple, np.ndarray)):
                        value = np.asarray(value)
                        if value.shape and value.shape[0] == n and skip:
                            value = value[skip:]
                    self._ring_write(ring, head, keep, value)
            dropped = max(
                0, self._size + keep - self.capacity
            ) + skip
            self._head = (head + keep) % self.capacity
            self._size = min(self.capacity, self._size + keep)
            self._seq += n
            self.records_total += n
            self.records_dropped += dropped
        if self._c_records is not None:
            self._c_records.inc("-", "-", float(n))
            if dropped:
                self._c_dropped.inc("-", "-", float(dropped))
        return n

    def _commit_single(self, cols: Dict[str, object], now: float) -> int:  # lint: allow-complexity — per-item ring write: one guard per value class

        fills = _COLUMN_FILLS
        with self._lock:
            head = self._head
            for name, ring in self._rings.items():
                if name == "ts":
                    ring[head] = now
                    continue
                if name == "seq":
                    ring[head] = self._seq + 1
                    continue
                value = cols.get(name)
                if value is None:
                    value = fills.get(name, 0)
                elif isinstance(value, (list, tuple)):
                    value = value[0]
                elif isinstance(value, np.ndarray) and value.ndim >= 1:
                    value = value[0]
                ring[head] = value
            dropped = 1 if self._size == self.capacity else 0
            self._head = (head + 1) % self.capacity
            self._size = min(self.capacity, self._size + 1)
            self._seq += 1
            self.records_total += 1
            self.records_dropped += dropped
        if self._c_records is not None:
            self._c_records.inc("-", "-", 1.0)
            if dropped:
                self._c_dropped.inc("-", "-", 1.0)
        return 1

    @staticmethod
    def _ring_write(ring, head: int, n: int, value) -> None:
        """Write `value` (scalar broadcast or length-n array) into the
        ring at [head, head+n) with wraparound — at most two slice
        assignments."""
        cap = ring.shape[0]
        first = min(n, cap - head)
        scalar = not (
            isinstance(value, np.ndarray) and value.shape
        )
        if scalar:
            ring[head:head + first] = value
            if n > first:
                ring[: n - first] = value
        else:
            ring[head:head + first] = value[:first]
            if n > first:
                ring[: n - first] = value[first:]

    def _winning_stages(self, batch: LedgerBatch):
        """The single stage that best explains each final count
        (precedence in the module constants' order). Small batches take
        the scalar path: a typical tick commits a handful of rows, and
        a dozen tiny-array numpy ops cost ~100us of fixed overhead the
        <=5% bench budget cannot afford; the vectorized path serves the
        multi-tenant thousands-of-rows commits."""
        if batch.n <= 32:
            return self._winning_stages_scalar(batch)
        return self._winning_stages_vector(batch)

    @staticmethod
    def _winning_stages_scalar(batch: LedgerBatch) -> list:  # lint: allow-complexity — the stage-precedence ladder, one arm per stage
        cols = batch.cols

        def get(name, i, default):
            value = cols.get(name, default)
            if isinstance(value, (np.ndarray, list, tuple)):
                return value[i]
            return value

        stages = []
        for i in range(batch.n):
            base = int(get("base_desired", i, -1))
            final = int(get("final_desired", i, -1))
            if get("cost_blind", i, False):
                stages.append(STAGE_COST_BLIND)
            elif final >= 0 and base >= 0 and final > base:
                stages.append(STAGE_COST_RAISE)
            elif final >= 0 and base >= 0 and final < base:
                stages.append(STAGE_COST_CLAMP)
            elif get("forecast_blend", i, False):
                stages.append(STAGE_FORECAST_BLEND)
            elif get("solver_rung", i, "") == "floor":
                stages.append(STAGE_DEGRADED_FLOOR)
            elif get("deferred", i, False):
                stages.append(STAGE_ADMISSION_DEFERRAL)
            else:
                stages.append(STAGE_REACTIVE)
        return stages

    def _winning_stages_vector(self, batch: LedgerBatch) -> np.ndarray:
        n = batch.n

        def col(name):
            value = batch.cols.get(name, _COLUMN_FILLS.get(name))
            if isinstance(value, (list, tuple, np.ndarray)):
                return np.asarray(value)
            return np.full(n, value)

        base = col("base_desired").astype(np.int64)
        final = col("final_desired").astype(np.int64)
        delta = np.where((final >= 0) & (base >= 0), final - base, 0)
        rung = col("solver_rung").astype(object)
        stages = np.empty(n, object)
        stages[:] = STAGE_REACTIVE
        stages[col("deferred").astype(bool)] = STAGE_ADMISSION_DEFERRAL
        stages[rung == "floor"] = STAGE_DEGRADED_FLOOR
        stages[col("forecast_blend").astype(bool)] = STAGE_FORECAST_BLEND
        stages[delta < 0] = STAGE_COST_CLAMP
        stages[delta > 0] = STAGE_COST_RAISE
        stages[col("cost_blind").astype(bool)] = STAGE_COST_BLIND
        return stages

    # -- queries (off the hot path) ----------------------------------------

    def clear(self) -> None:
        with self._lock:
            self._head = 0
            self._size = 0

    def _order(self) -> np.ndarray:
        """Ring indices oldest-first (caller holds the lock)."""
        if self._size < self.capacity:
            return np.arange(self._size)
        return np.arange(self._head, self._head + self.capacity) % (
            self.capacity
        )

    def query(
        self,
        kind: Optional[str] = None,
        tenant: Optional[str] = None,
        group: Optional[str] = None,
        name: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> List[dict]:
        """Filtered records, oldest-first (most recent last). Dicts are
        built HERE, not at record time — the hot path stays columnar."""
        with self._lock:
            order = self._order()
            snapshot = {
                col: ring[order] for col, ring in self._rings.items()
            }
        mask = np.ones(len(order), bool)
        for column, wanted in (
            ("kind", kind), ("tenant", tenant),
            ("group", group), ("name", name),
        ):
            if wanted is not None:
                mask &= snapshot[column] == wanted
        idx = np.nonzero(mask)[0]
        if limit is not None and limit >= 0:
            idx = idx[-limit:] if limit else idx[:0]
        return [self._record(snapshot, int(i)) for i in idx]

    @staticmethod
    def _record(snapshot: Dict[str, np.ndarray], i: int) -> dict:  # lint: allow-complexity — JSON shaping: one guard per value class

        record: dict = {}
        for column, values in snapshot.items():
            if column == "observed":
                n = int(snapshot["observed_n"][i])
                record["observed"] = [
                    round(float(v), 6) for v in values[i][:n]
                ]
                continue
            if column == "observed_n":
                continue
            value = values[i]
            if isinstance(value, (np.floating, float)):
                value = None if math.isnan(float(value)) else round(
                    float(value), 6
                )
            elif isinstance(value, (np.bool_, bool)):
                value = bool(value)
            elif isinstance(value, np.integer):
                value = int(value)
            record[column] = value
        # sentinel numerics render as null: "never annotated" must not
        # read as a real count of -1
        for column in (
            "prev_replicas", "base_desired", "final_desired",
            "cost_candidate", "warm_headroom", "admission_round",
        ):
            if record.get(column) == -1:
                record[column] = None
        return record

    def export_jsonl(self, path: str) -> int:
        """Dump the ring as JSONL (one record per line), crash-safely —
        the recovery journal's tmp + fsync + rename. Written next to
        the --trace-export trace by the runtime/simulate wiring; the
        `trace` field of each record backlinks into that file's span
        `cat` ids. Returns the record count."""
        from karpenter_tpu_torch.recovery.journal import atomic_write

        records = self.query()
        atomic_write(
            path,
            "".join(
                json.dumps(record, sort_keys=True) + "\n"
                for record in records
            ),
        )
        return len(records)


def decisions_export_path(trace_export: str) -> str:
    """The ledger JSONL path derived from a --trace-export path:
    trace.jsonl -> trace.decisions.jsonl (same directory, so the trace
    and the decisions it backlinks travel together)."""
    import os.path

    root, ext = os.path.splitext(trace_export)
    return f"{root}.decisions{ext or '.jsonl'}"


def export_next_to_trace(ledger: DecisionLedger, trace_export: str):
    """Dump `ledger` as the decisions JSONL sibling of a trace export
    (the one export contract every caller shares — the CLI exit hook,
    the simulate replays). Returns (path, record_count)."""
    path = decisions_export_path(trace_export)
    return path, ledger.export_jsonl(path)


def _current_trace_id() -> Optional[str]:
    from karpenter_tpu_torch.observability.tracing import default_tracer

    return default_tracer().current_trace_id()


# -- process default ----------------------------------------------------------
# One ledger per process like the tracer/flight recorder: annotation
# sites read it through default_ledger() so provenance context crosses
# module boundaries with no parameter threading. DEFAULT OFF — the
# runtime enables it under --provenance.

_default = DecisionLedger()


def default_ledger() -> DecisionLedger:
    return _default


def set_default_ledger(ledger: DecisionLedger) -> DecisionLedger:
    global _default
    _default = ledger
    return ledger


def reset_default_ledger(enabled: bool = False) -> DecisionLedger:
    """Swap in a fresh default ledger (test isolation / the simulate
    replays)."""
    return set_default_ledger(DecisionLedger(enabled=enabled))
