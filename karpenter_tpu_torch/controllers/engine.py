"""Reconcile engine: the standardized controller workflow + manager.

reference: pkg/controllers/controller.go:33-97 (Controller/Object interfaces,
GenericController workflow) and pkg/controllers/manager.go:40-79.

Workflow per object (controller.go:67-97): get fresh copy → keep persisted
base → validate (failure marks Active false but still patches status) →
domain reconcile (failure marks Active false; success true) → status
merge-patch → requeue after the controller's interval.

Redesign: the manager tick is BATCH-FIRST. A controller may implement
reconcile_batch(objects) → {name: error}; the manager then hands it every
due object of its kind in one call (the HA controller turns this into a
single device kernel invocation for the whole fleet). Controllers without a
batch path get the per-object workflow. Watch events requeue immediately
(the reference's watch-driven actuation, DESIGN.md:435).

Failure ladder (docs/resilience.md): the fixed-interval requeue applies
only to SUCCESSFUL reconciles. A failed one is classified through
errors.is_retryable —

  retryable     → requeue on per-object decorrelated-jitter exponential
                  backoff (monotone, bounded by backoff_cap_s): a flaky
                  dependency is retried promptly at first, then ever
                  slower, and the jitter keeps a fleet of failers from
                  herding the dependency's recovery;
  non-retryable → DEACTIVATE: Active=False is persisted and the object
                  is not requeued at all until a watch event (spec edit,
                  external patch) revives it — a poisoned spec stops
                  consuming ticks instead of failing forever.

A failed status patch itself backs off too (the store is a dependency
like any other).

EVENT-DRIVEN RECONCILE (docs/solver-service.md "Event-driven
reconcile"): with `event_driven=True` a watch event no longer waits for
the next tick. `_on_event` marks the key DIRTY and schedules a
COALESCED EVENT PASS — after a short debounce window (so an event storm
batches into one pass, not one pass per event) a partial reconcile_all
runs over only the dirty keys that are actually due. The periodic tick
is demoted to a RESYNC BACKSTOP: it still runs every interval for drift
repair, interval-driven requeues, backoff/deactivation revival, the
tick hook consumers (recovery warm-up counting, self-SLO evaluation)
and gauge publication — none of which fire per event. Invariants:

  * one pass at a time: ticks and event passes serialize on one lock,
    and dueness is re-checked under it, so a key reconciled by the tick
    (and requeued at now+interval) is skipped by a racing event pass —
    never double-reconciled;
  * the ladder holds: a key parked on retryable backoff or DEACTIVATED
    is revived by a DIRECT watch event exactly as before (due=0), and a
    failure inside an event pass walks the same _requeue ladder a tick
    failure does;
  * the watch callback thread never blocks: marking dirty is a set-add
    + signal; the pass itself runs on the manager's event thread (or
    whoever calls run_event_pass in simulated-time harnesses);
  * controllers may additionally declare `event_routes() -> (kinds,)`:
    events on those kinds mark the controller's OWN objects dirty
    (a pending Pod wakes the pendingCapacity producers; a refreshed
    producer wakes the autoscalers) — routed dirtying never revives
    backoff/deactivated keys, only a direct event does.

With event_driven=False (the default) none of this machinery is built
and the loop is byte-identical to the tick-paced engine.

The port's copy of karpenter_tpu/controllers/engine.py.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Dict, List, Optional, Protocol

from karpenter_tpu_torch.api import conditions as cond
from karpenter_tpu_torch.controllers.errors import is_retryable
from karpenter_tpu_torch.observability import default_tracer
from karpenter_tpu_torch.resilience import DecorrelatedJitterBackoff
from karpenter_tpu_torch.store import Store
from karpenter_tpu_torch.utils.log import logger

_NEVER = float("inf")  # the deactivated requeue time


class Controller(Protocol):
    def kind(self) -> str:
        """Kind of the resource this controller owns."""
        ...

    def interval(self) -> float:
        """Seconds between reconciles (reference: controller.go:37-41)."""
        ...

    def reconcile(self, obj) -> None:
        """Domain reconcile; raise to mark the resource not Active."""
        ...


class Manager:
    def __init__(
        self, store: Store, clock=_time.time, registry=None,
        solver_service=None,
        backoff_base_s: float = 1.0,
        backoff_cap_s: float = 60.0,
        backoff_seed: int = 0,
        tick_hook=None,
        recovery_journal=None,
        event_driven: bool = False,
        event_debounce_s: float = 0.05,
        event_thread: bool = True,
    ):
        self.store = store
        self.clock = clock
        # crash safety (karpenter_tpu/recovery): `recovery_journal` is a
        # JournalHandle persisting per-object backoff state — without
        # it, a crash-looping object restarts its ladder at the base
        # delay every controller restart, defeating the backoff exactly
        # when it matters. `tick_hook` fires after each full
        # reconcile_all pass (the recovery warm-up counts ticks on it).
        self._tick_hook = tick_hook
        self._journal = recovery_journal
        # shared solve service (solver/service.py): the manager refreshes
        # its point-in-time gauges (queue depth, coalesce factor, stage
        # percentiles) every tick, so /metrics shows them alongside the
        # runtime series with no extra wiring in __main__.py
        self._solver_service = solver_service
        self._controllers: List[Controller] = []
        # kinds whose controller ACKS the e2e lead-time mark
        # (`acks_e2e = True`, the SNG controller): marks are only
        # stamped for these — stamping every kind would be per-object
        # tracer-lock traffic on the hot path that no ack ever reads
        self._e2e_kinds: set = set()
        # (kind, namespace, name) -> next due time; 0 = due now,
        # inf = deactivated (revived only by a watch event)
        self._due: Dict[tuple, float] = {}
        # per-object retryable-failure ladder: key -> previous delay
        self._backoff = DecorrelatedJitterBackoff(
            base_s=backoff_base_s, cap_s=backoff_cap_s, seed=backoff_seed
        )
        self._backoff_prev: Dict[tuple, float] = {}
        # event-driven reconcile (module docstring): the dirty-key set
        # feeding coalesced event passes, the lock serializing passes
        # (tick AND event) and the debounce/scheduler state. All of it
        # is inert when event_driven is False.
        self.event_driven = event_driven
        self.event_debounce_s = event_debounce_s
        self._own_event_thread = event_thread
        self._dirty: set = set()
        self._dirty_lock = threading.Lock()
        # mid-reconcile event race (event-driven mode only): a watch
        # event landing while a pass is BETWEEN fetching a key's object
        # and requeueing it acted on state the reconcile never saw —
        # and the interval requeue would overwrite the event's due-now
        # stamp, parking the key until the backstop tick. Each external
        # event bumps the key's sequence; the pass snapshots it at
        # collection time and a changed sequence at requeue time keeps
        # the key due-now + dirty instead.
        self._event_seq: Dict[tuple, int] = {}
        self._pass_seq: Dict[tuple, int] = {}
        self._dirty_since: Optional[float] = None
        self._pass_lock = threading.Lock()
        self._event_signal = threading.Event()
        self._event_worker: Optional[threading.Thread] = None
        self._closed = False
        # the key whose status THIS thread is currently patching inside
        # _finish: its own watch echo must not re-stamp a just-retired
        # e2e mark (or schedule an event pass) — see _on_event
        self._patching = threading.local()
        # self-observability (the reference gets controller-runtime's
        # metrics for free; here the manager publishes its own):
        # karpenter_runtime_{tick_seconds,reconciles_total,
        # reconcile_errors_total}{name=<kind>|manager}
        self._tick_gauge = self._count_gauge = self._error_gauge = None
        self._backoff_gauge = self._deactivated_gauge = None
        self._event_pass_gauge = self._event_keys_gauge = None
        self._event_debounce_gauge = None
        if registry is not None:
            self._tick_gauge = registry.register("runtime", "tick_seconds")
            self._count_gauge = registry.register(
                "runtime", "reconciles_total", kind="counter"
            )
            self._error_gauge = registry.register(
                "runtime", "reconcile_errors_total", kind="counter"
            )
            # event-pass observability (module docstring): passes that
            # dispatched >= 1 due key, the keys they carried, and the
            # last pass's measured debounce gather (first dirty mark ->
            # pass start) — the coalescing signal an operator tunes
            # --event-debounce against
            self._event_pass_gauge = registry.register(
                "runtime", "event_passes_total", kind="counter"
            )
            self._event_keys_gauge = registry.register(
                "runtime", "event_pass_keys_total", kind="counter"
            )
            self._event_debounce_gauge = registry.register(
                "runtime", "event_debounce_ms"
            )
            # ladder observability: the last requeue backoff per kind and
            # how many objects have been deactivated by non-retryable
            # errors (karpenter_resilience_* — docs/resilience.md)
            self._backoff_gauge = registry.register(
                "resilience", "requeue_backoff_seconds"
            )
            self._deactivated_gauge = registry.register(
                "resilience", "deactivated_total", kind="counter"
            )

    def _count(self, gauge, name: str, delta: float = 1.0) -> None:
        # process-level series: namespace "-" keeps them distinct from
        # object-namespace-labeled producer gauges on dashboards
        if gauge is not None:
            gauge.inc(name, "-", delta)

    def register(self, *controllers: Controller) -> "Manager":
        """reference: manager.go:59-71"""
        for controller in controllers:
            self._controllers.append(controller)
            if getattr(controller, "acks_e2e", False):
                self._e2e_kinds.add(controller.kind())
            self.store.watch(controller.kind(), self._on_event)
            self._register_routes(controller)
        return self

    def _register_routes(self, controller) -> None:
        """Event-driven mode only: a controller's `event_routes()` names
        EXTRA kinds whose events make the controller's own objects dirty
        (module docstring). Tick-paced mode registers nothing — routed
        kinds see zero new callbacks and behavior stays byte-identical."""
        if not self.event_driven:
            return
        routes = getattr(controller, "event_routes", None)
        if routes is None:
            return
        from functools import partial

        for kind in routes():
            self.store.watch(
                kind, partial(self._on_routed_event, controller)
            )

    def _on_routed_event(self, controller, event: str, obj) -> None:
        """A routed kind changed (a Pod appeared, a producer refreshed):
        mark the controller's own objects dirty so the next event pass
        re-evaluates them against the fresh signal. Routed dirtying is
        WEAKER than a direct watch event: it only pulls due times
        FORWARD for keys on the plain interval schedule — keys riding
        the retryable-backoff ladder or DEACTIVATED stay parked (only a
        direct event on the object itself revives, preserving the
        failure ladder under routed churn). Deletes route too — a
        removed pod frees capacity, which is as much a signal as a new
        one. The ladder guard and the due-now stamp are ONE critical
        section on the dirty lock — the ladder's own due writes
        (_requeue_backoff, _deactivate) take the same lock, so this
        check can never interleave with a parking write and erase it."""
        keys = self.store.keys(controller.kind())
        marked = False
        with self._dirty_lock:
            for key in keys:
                if key in self._backoff_prev:
                    continue  # parked on the retryable ladder
                if self._due.get(key, 0.0) == _NEVER:
                    continue  # deactivated
                self._due[key] = 0.0
                self._event_seq[key] = self._event_seq.get(key, 0) + 1
                self._mark_dirty_locked(key)
                marked = True
        if marked:
            self._wake_event_worker()

    def _on_event(self, event: str, obj) -> None:
        key = (obj.KIND, obj.metadata.namespace, obj.metadata.name)
        if event == "Deleted":
            self._due.pop(key, None)
            self._drop_backoff(key)
            self._event_seq.pop(key, None)
            self._pass_seq.pop(key, None)
            default_tracer().drop_observed(key)
            # controllers may keep per-object state of their own (the
            # SNG controller's circuit breakers + gauge series): give
            # them the same pruning signal the engine's maps get
            for controller in self._controllers:
                hook = getattr(controller, "on_deleted", None)
                if hook is not None and controller.kind() == obj.KIND:
                    hook(obj)
        elif (
            self.event_driven
            and getattr(self._patching, "key", None) == key
        ):
            # the engine's OWN status-patch echo (fired synchronously
            # from inside _finish, on this thread): _requeue — running
            # immediately after — owns this key's due time, and
            # re-stamping the e2e mark the reconcile just retired would
            # measure the NEXT divergence from our own write instead of
            # from its triggering event (the staleness that dominated
            # sub-second event passes). External writes racing the
            # patch arrive on other threads and are untouched. Gated on
            # event_driven: tick-paced mode keeps the pre-PR echo
            # semantics byte for byte (the wire-compat contract).
            return
        else:
            # watch events trigger immediate reconcile on the next tick,
            # overriding any scheduled requeue (the reference's watch-driven
            # actuation, DESIGN.md:435) — including the inf requeue of a
            # DEACTIVATED object: an external edit is the revival signal
            self._due[key] = 0.0
            # event-observed stamp for the end-to-end lead-time
            # histogram (karpenter_reconcile_e2e_seconds), only for
            # kinds whose controller acks it. overwrite=False: EVERY
            # store write notifies here — including this engine's own
            # per-reconcile status patches — so a pending mark must
            # survive re-notification or a multi-tick actuation would
            # be measured from its last self-patch (~one tick) instead
            # of the triggering event. The earliest stamp since the
            # mark was last retired IS the divergence observation: the
            # SNG controller acks the mark on actuation and drops it
            # on every converged reconcile, and the validation/
            # deactivation paths drop it too, so a stamp never
            # predates the divergence by more than one reconcile
            # interval
            if obj.KIND in self._e2e_kinds:
                default_tracer().mark_observed(key, overwrite=False)
            # event-driven mode: schedule the coalesced event pass and
            # bump the key's event sequence so a reconcile racing this
            # event detects it at requeue time (_note_event and the
            # _requeue re-check serialize on the dirty lock, so the
            # bump and the due-now stamp are atomic vs the re-check)
            if self.event_driven:
                self._note_event(key)

    # -- event passes (module docstring) -----------------------------------

    def _mark_dirty_locked(self, key: tuple) -> None:
        """Set-add only (caller holds the dirty lock): the writer
        thread never waits on reconcile work."""
        self._dirty.add(key)
        if self._dirty_since is None:
            self._dirty_since = self.clock()

    def _wake_event_worker(self) -> None:
        self._event_signal.set()
        if self._own_event_thread:
            self._ensure_event_worker()

    def _note_event(self, key: tuple) -> None:
        """Record one external event on `key`: due-now stamp, sequence
        bump, dirty mark — all under the dirty lock, so the bump can
        never land between _requeue's staleness comparison and its
        interval due-write (which would let the interval overwrite the
        event's due-now stamp and park the key until the backstop)."""
        with self._dirty_lock:
            self._due[key] = 0.0
            self._event_seq[key] = self._event_seq.get(key, 0) + 1
            self._mark_dirty_locked(key)
        self._wake_event_worker()

    def _ensure_event_worker(self) -> None:
        if self._event_worker is not None or self._closed:
            return
        with self._dirty_lock:
            if self._event_worker is not None or self._closed:
                return
            self._event_worker = threading.Thread(
                target=self._event_loop,
                name="manager-event-pass",
                daemon=True,
            )
            self._event_worker.start()

    def _event_loop(self) -> None:
        """The debounced scheduler: wake on the first dirty mark, sleep
        the debounce window out (events landing meanwhile join the same
        pass), run ONE coalesced pass, repeat."""
        while not self._closed:
            self._event_signal.wait()
            if self._closed:
                return
            self._event_signal.clear()
            _time.sleep(self.event_debounce_s)
            try:
                self.run_event_pass()
            except Exception:  # noqa: BLE001 — the backstop tick repairs
                logger().exception("event pass failed; tick will resync")

    def dirty_count(self) -> int:
        """Keys awaiting an event pass (simulated-time harnesses poll
        this to drive run_event_pass without the wall-clock thread)."""
        with self._dirty_lock:
            return len(self._dirty)

    def run_event_pass(self) -> int:
        """One coalesced event pass: swap out the dirty set, reconcile
        the dirty keys that are DUE, return how many were dispatched.

        Dueness is re-checked under the pass lock — a key the tick (or
        a previous pass) just reconciled was requeued at now+interval
        and is skipped here, which is the no-double-reconcile guarantee.
        Tick consumers (tick_hook, solver gauge publication) explicitly
        do NOT run: they stay on the tick cadence."""
        with self._dirty_lock:
            if not self._dirty:
                return 0
            dirty, self._dirty = self._dirty, set()
            since, self._dirty_since = self._dirty_since, None
        with self._pass_lock:
            now = self.clock()
            # a dirty key only ever becomes due via an event's due-now
            # stamp — a MISSING entry means the object was deleted after
            # dirtying (the Deleted handler pops _due), so it must not
            # default to due-now and inflate the pass gauges
            due = {
                k for k in dirty
                if (d := self._due.get(k)) is not None and d <= now
            }
            if not due:
                return 0
            if self._event_debounce_gauge is not None and since is not None:
                self._event_debounce_gauge.set(
                    "manager", "-", max(0.0, now - since) * 1e3
                )
            with default_tracer().trace(
                "reconcile.event_pass", keys=len(due)
            ):
                for controller in self._controllers:
                    self._reconcile_controller(controller, now, keys=due)
        self._count(self._event_pass_gauge, "manager")
        self._count(self._event_keys_gauge, "manager", float(len(due)))
        return len(due)

    def close(self) -> None:
        """Stop the event-pass thread (idempotent; a tick-paced manager
        has nothing to stop)."""
        self._closed = True
        self._event_signal.set()
        worker = self._event_worker
        if worker is not None:
            worker.join(timeout=5.0)
            self._event_worker = None

    # -- the generic workflow (reference: controller.go:67-97) -------------

    def _finish(self, controller, obj, error: Optional[Exception]) -> None:
        mgr = obj.status_conditions()
        if error is not None and obj.KIND in self._e2e_kinds:
            # a failed reconcile proved nothing about convergence: keep
            # the mark and a converged-but-flapping object would carry
            # it into a much later actuation's karpenter_reconcile_e2e_
            # seconds sample. Dropping under-reports lead during fault
            # windows instead — the conservative direction (degraded-
            # path visibility is the flight recorder's job)
            default_tracer().drop_observed(self._key_of(obj))
        if error is not None:
            mgr.mark_false(cond.ACTIVE, "", str(error))
            logger().error(
                "Controller failed to reconcile kind %s %s: %s",
                obj.KIND,
                obj.metadata.name,
                error,
            )
        else:
            mgr.mark_true(cond.ACTIVE)
        self._count(self._count_gauge, obj.KIND)
        if error is not None:
            self._count(self._error_gauge, obj.KIND)
        self._patching.key = self._key_of(obj)
        try:
            patched = self.store.patch_status(obj)
        except KeyError:
            return  # deleted mid-reconcile
        except Exception as patch_error:  # noqa: BLE001 — store hiccup
            # the store is a dependency like the provider: a failed
            # status write requeues on the retryable ladder (the write
            # is redone wholesale by the next reconcile) and NEVER
            # deactivates — the conditions were not persisted, so a
            # deactivation here would strand the object invisibly
            logger().warning(
                "status patch failed for %s %s: %s; requeueing with "
                "backoff", obj.KIND, obj.metadata.name, patch_error,
            )
            self._count(self._error_gauge, obj.KIND)
            self._requeue_backoff(self._key_of(obj))
            return
        finally:
            self._patching.key = None
        self._requeue(controller, self._key_of(obj), error, patched)

    @staticmethod
    def _key_of(obj) -> tuple:
        return (obj.KIND, obj.metadata.namespace, obj.metadata.name)

    def _requeue(
        self, controller, key, error: Optional[Exception], patched=None
    ) -> None:
        """The supervised requeue ladder: interval on success, jittered
        backoff on retryable failure, deactivation on non-retryable."""
        observed_seq = self._pass_seq.pop(key, None)
        if error is None:
            self._drop_backoff(key)
            self._requeue_success(controller, key, observed_seq)
        elif is_retryable(error):
            self._requeue_backoff(key)
        else:
            self._deactivate(key, patched)

    def _requeue_success(self, controller, key, observed_seq) -> None:
        """Interval requeue after a successful reconcile — unless a
        watch event raced it (landed after the object was fetched): the
        state just acted on is already stale, so the key stays due-now
        + dirty and the next pass re-reconciles, instead of the
        interval requeue silently swallowing the event until the
        backstop tick (the _deactivate resourceVersion re-check,
        generalized to the success path). Comparison and due-write are
        one critical section with _note_event: a bump can never land
        between them unseen."""
        if not self.event_driven:
            self._due[key] = self.clock() + controller.interval()
            return
        with self._dirty_lock:
            if (
                observed_seq is not None
                and self._event_seq.get(key, 0) != observed_seq
            ):
                self._due[key] = 0.0
                self._mark_dirty_locked(key)
                raced = True
            else:
                self._due[key] = self.clock() + controller.interval()
                raced = False
        if raced:
            self._wake_event_worker()

    def _deactivate(self, key, patched) -> None:
        """DEACTIVATE: no requeue until a watch event revives the
        object (_on_event). Exactly-once by construction — the object
        is never due again, so _finish cannot re-run. Concurrency
        guard: an EXTERNAL write landing during this reconcile fired
        its revival event before we got here and due=inf would silently
        discard it — detectable because the stored resourceVersion has
        moved past our own status patch. Reconcile once more instead of
        deactivating."""
        current = self.store.try_get(*key)
        if (
            current is not None
            and patched is not None
            and current.metadata.resource_version
            != patched.metadata.resource_version
        ):
            self._due[key] = 0.0
            return
        # the journaled ladder is dropped too: a crash-restart must not
        # revive a DEACTIVATED object through a stale finite due time
        # restored from the journal
        self._drop_backoff(key)
        # a deactivated object will not actuate until revived: retire
        # any pending e2e mark so the revival's actuation measures from
        # the reviving edit, not from before the deactivation. The due
        # write takes the dirty lock so the routed-event guard cannot
        # interleave and erase the inf stamp (_on_routed_event).
        default_tracer().drop_observed(key)
        with self._dirty_lock:
            self._due[key] = _NEVER
        if self._deactivated_gauge is not None:
            self._deactivated_gauge.inc(key[0], "-")

    def _drop_backoff(self, key) -> None:
        """Retire an object's backoff ladder, in memory AND in the
        journal (one idiom for success, deletion, and deactivation)."""
        if (
            self._backoff_prev.pop(key, None) is not None
            and self._journal is not None
        ):
            self._journal.delete(key)

    def _requeue_backoff(self, key) -> None:
        delay = self._backoff.next(self._backoff_prev.get(key, 0.0))
        # under the dirty lock: the routed-event guard reads the ladder
        # (_on_routed_event) and must never interleave between these
        # two writes — it would revive a key the ladder is parking
        with self._dirty_lock:
            self._backoff_prev[key] = delay
            self._due[key] = self.clock() + delay
        if self._journal is not None:
            self._journal.set(
                key, {"prev": delay, "due": self._due[key]}
            )
        if self._backoff_gauge is not None:
            self._backoff_gauge.set(key[0], "-", delay)

    def snapshot_backoff(self) -> Dict[str, dict]:
        """Live backoff table for the recovery checkpoint."""
        from karpenter_tpu_torch.recovery.journal import key_str

        return {
            key_str(key): {"prev": prev, "due": self._due.get(key, 0.0)}
            for key, prev in self._backoff_prev.items()
        }

    def restore_backoff(self, entries: dict) -> None:
        """Rebuild the per-object backoff ladder from a replayed journal
        table, so a crash-looping object cannot reset its ladder by
        crashing the controller. Restored due times are CAPPED at
        now + backoff cap: an object journaled long before the outage
        ended must come due within one max-backoff window, never stay
        parked on a stale far-future (or inf) stamp."""
        from karpenter_tpu_torch.recovery.journal import key_tuple

        now = self.clock()
        restored = 0
        # snapshot the items: `entries` aliases the journal's live
        # mirror table, and the delete below folds back into it —
        # iterating the dict itself would crash the recovery boot
        for k, doc in list(entries.items()):
            key = key_tuple(k)
            if self.store.try_get(*key) is None:
                # deleted while we were down: no Deleted event will
                # ever fire for it — drop the entry now or it would
                # re-persist through every future checkpoint
                if self._journal is not None:
                    self._journal.delete(key)
                continue
            prev = min(float(doc["prev"]), self._backoff.cap_s)
            self._backoff_prev[key] = prev
            self._due[key] = min(
                float(doc["due"]), now + self._backoff.cap_s
            )
            restored += 1
        if restored:
            logger().info(
                "engine: restored backoff state for %d object(s) from "
                "the journal", restored,
            )

    def _due_objects(self, kind: str, now: float, keys) -> list:
        """Due objects of `kind`: the full key sweep on a tick, the
        dirty-key slice on an event pass. Dueness is decided on keys so
        idle ticks never deep-copy the fleet; only due objects are
        fetched."""
        candidates = (
            self.store.keys(kind)
            if keys is None
            else [k for k in keys if k[0] == kind]
        )
        due_objs = []
        for key in candidates:
            if self._due.get(key, 0.0) > now:
                continue
            if self.event_driven:
                # snapshot the event sequence BEFORE fetching: an event
                # landing after the snapshot (even mid-fetch) shows up
                # as a seq change at requeue time and re-reconciles. The
                # reverse order would fold a mid-collection event into
                # the snapshot and let the interval requeue swallow it —
                # spurious re-reconciles are safe, swallowed events are
                # not (_requeue_success re-checks).
                self._pass_seq[key] = self._event_seq.get(key, 0)
            obj = self.store.try_get(*key)
            if obj is not None:
                due_objs.append(obj)
        return due_objs

    def _validate(self, obj) -> Optional[Exception]:
        try:
            obj.validate()
            return None
        except Exception as e:  # noqa: BLE001
            return e

    def _reconcile_controller(
        self, controller, now: float, keys=None
    ) -> None:
        """One controller's slice of the pass: collect due objects,
        validate, dispatch. `keys=None` is the full tick sweep; an event
        pass restricts the sweep to its dirty keys (already filtered for
        dueness, re-filtered here for the kind)."""
        kind = controller.kind()
        due_objs = self._due_objects(kind, now, keys)
        if not due_objs:
            return

        tracer = default_tracer()
        e2e = kind in self._e2e_kinds
        valid_objs = []
        for obj in due_objs:
            error = self._validate(obj)
            if error is not None:
                # _finish retires any pending e2e mark on the error
                # path: an invalid object cannot actuate, and an
                # hours-later revival must not measure its lead time
                # from a stamp that predates the fix
                self._finish(controller, obj, error)
            else:
                if e2e:
                    # interval-driven reconciles have no watch event:
                    # the tick entry IS the observation point for the
                    # e2e lead time (stamped AFTER validation — a
                    # failing object never accrues a mark). setdefault
                    # semantics — an earlier event stamp wins.
                    tracer.mark_observed(
                        self._key_of(obj), overwrite=False
                    )
                valid_objs.append(obj)
        with tracer.span(
            f"reconcile.{kind}", objects=len(valid_objs)
        ):
            self._dispatch(controller, valid_objs)

    def _dispatch(self, controller, valid_objs) -> None:
        """Batch path when the controller offers one, else per-object."""
        batch = getattr(controller, "reconcile_batch", None)
        if batch is not None and valid_objs:
            obj_key = lambda o: (o.metadata.namespace, o.metadata.name)
            try:
                errors = batch(valid_objs)
            except Exception as e:  # noqa: BLE001 - batch-wide failure
                errors = {obj_key(o): e for o in valid_objs}
            for obj in valid_objs:
                self._finish(controller, obj, errors.get(obj_key(obj)))
        else:
            for obj in valid_objs:
                try:
                    controller.reconcile(obj)
                    error = None
                except Exception as e:  # noqa: BLE001
                    error = e
                self._finish(controller, obj, error)

    def reconcile_all(self) -> None:
        """One manager tick: every due object of every controller.

        The tick is a reconcile-trace entry point (docs/observability.md):
        a trace id is minted here and every span opened inside — the
        per-kind reconcile, the HA fleet decide, solver requests, SNG
        actuation — inherits it through the tracer's thread-local
        stack, so one trace connects a watch event to the coalesced
        dispatch to the provider write it caused."""
        start = _time.perf_counter()
        # one pass at a time: a tick and an event pass must never
        # reconcile concurrently (run_event_pass holds the same lock);
        # with event_driven off the lock is always uncontended
        with self._pass_lock:
            now = self.clock()
            with default_tracer().trace("reconcile.tick"):
                for controller in self._controllers:
                    self._reconcile_controller(controller, now)
        if self._solver_service is not None:
            # per-tick dispatch accounting BEFORE the gauges publish:
            # note_tick closes this tick's window (dispatches since the
            # last tick -> karpenter_solver_dispatches_per_tick), the
            # number the fused tick collapses from 3+ to 1
            self._solver_service.note_tick()
            self._solver_service.publish_gauges()
        if self._tick_hook is not None:
            self._tick_hook()
        if self._tick_gauge is not None:
            self._tick_gauge.set(
                "manager", "-", _time.perf_counter() - start
            )

    def run(self, duration: float, tick: float = 0.1) -> None:
        """Drive reconcile_all on a wall-clock loop for `duration` seconds."""
        deadline = self.clock() + duration
        while self.clock() < deadline:
            self.reconcile_all()
            _time.sleep(tick)

    def converge(self, ticks: int = 5) -> None:
        """Run N immediate ticks ignoring intervals (test convergence helper,
        the ExpectEventuallyHappy analog — expectations.go:51-61)."""
        for _ in range(ticks):
            self._due = {k: 0.0 for k in self._due}
            self.reconcile_all()
