"""Consolidation engine: safety gates, state machine, actuation (the
port's copy of karpenter_tpu/consolidation/engine.py).

The planner (planner.py) answers the pure fit question — which nodes'
pods re-pack onto the remainder. This module wraps that verdict in the
operational safety a production drain needs:

  * DO-NOT-DISRUPT: a node, or any pod on it, annotated
    `karpenter.sh/do-not-disrupt: "true"` is never a candidate.
  * COOLDOWN / HYSTERESIS: a node whose bound-pod set changed within
    `cooldown_s` is not a candidate — a node that just received pods is
    exactly the node the scheduler is actively using, and draining it
    would thrash. First sight of a node starts its clock (conservative:
    a restarted engine waits out one cooldown before touching anything).
  * DISRUPTION BUDGETS: at most `budget_per_group` nodes of one group
    are in flight (cordoned/draining) at a time, so consolidation can
    never take a group below quorum in one sweep.
  * TWO-PHASE cordon → verify → drain: a drainable candidate is first
    CORDONED (spec.unschedulable, so the scheduler stops adding pods and
    the next plan's receiver mask excludes it), then RE-VERIFIED against
    fresh cluster state for `verify_s` before the drain is approved. A
    verdict that flips during the soak un-cordons the node and counts a
    veto — the cluster changed under us, and the safe answer is to put
    the node back.

Actuation is intent-based, riding the existing control flow rather than
bypassing it: an approved drain decrements the owning ScalableNodeGroup's
spec.replicas through the store's scale subresource (the same door the
HorizontalAutoscaler writes), and the ScalableNodeGroup controller's
normal spec-vs-observed loop performs the provider call. The controller
reports the scale-down back (`on_scale_down`), at which point the engine
finalizes: the drained Node object is deleted and the FSM entry retires.

Metrics (subsystem "consolidation", published through the runtime
registry): candidates evaluated, drains planned/vetoed/actuated, nodes
in flight, and the batched-eval latency.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Dict, List, Optional

from karpenter_tpu_torch.consolidation import planner as P
from karpenter_tpu_torch.faults import inject
from karpenter_tpu_torch.metrics.registry import GaugeRegistry, default_registry
from karpenter_tpu_torch.utils.log import logger

SUBSYSTEM = "consolidation"

CANDIDATES_EVALUATED = "candidates_evaluated_total"
DRAINS_PLANNED = "drains_planned_total"
DRAINS_VETOED = "drains_vetoed_total"
DRAINS_ACTUATED = "drains_actuated_total"
IN_FLIGHT = "in_flight"
BATCH_EVAL_MS = "batch_eval_ms"
BATCH_CANDIDATES = "batch_candidates"

# FSM phases
CORDONED = "cordoned"  # unschedulable, soaking through verify_s
APPROVED = "approved"  # re-verified; waiting for the controller to scale
DRAINING = "draining"  # spec.replicas decremented; provider call pending
UNCORDONING = "uncordoning"  # veto'd but the uncordon write failed: a
# node must never stay unschedulable because one store write conflicted
# (e.g. a status heartbeat landing mid-update), so the entry lingers in
# this phase and every plan retries the write until it lands

STATE_ANNOTATION = "karpenter.sh/consolidation-state"


@dataclass
class ConsolidationConfig:
    plan_interval_s: float = 30.0
    cooldown_s: float = 300.0
    verify_s: float = 60.0
    budget_per_group: int = 1
    max_candidates: int = 64
    buckets: int = 32
    backend: Optional[str] = None  # None = the service's default
    # how long a DRAINING node may wait for its scale-down to be
    # observed before the drain is vetoed and the node returned to
    # service. Bounds two failure loops: a concurrent spec writer (an
    # HPA targeting the same group) repeatedly reverting the replica
    # decrement, and a provider that never converges — either would
    # otherwise hold the node cordoned and the group's budget slot
    # forever.
    drain_timeout_s: float = 600.0


@dataclass
class _InFlight:
    node: str
    group: tuple  # (namespace, producer, ref)
    phase: str
    since: float


class ConsolidationEngine:
    """Owns the plan cadence and the per-node drain state machine."""

    def __init__(
        self,
        store,
        solver_service,
        registry: Optional[GaugeRegistry] = None,
        config: Optional[ConsolidationConfig] = None,
        clock=None,
    ):
        self.store = store
        self.service = solver_service
        # optional coordination seam: a callable returning node names
        # some OTHER disruption engine currently owns (the preemption
        # engine's active_nodes — runtime.py wires it). Guarded nodes
        # are never consolidation candidates, so the two engines cannot
        # fight over one node (docs/preemption.md "Coordination").
        self.node_guard = None
        # crash safety (karpenter_tpu/recovery, docs/resilience.md):
        # `journal` is a JournalHandle recording every FSM transition so
        # a restarted controller resumes each node's phase instead of
        # re-cordoning; `disruption_gate` is the recovery warm-up gate —
        # while it returns False (fleet state unconfirmed after a
        # restart) no planning happens at all
        self.journal = None
        self.disruption_gate = None
        self.config = config or ConsolidationConfig()
        self.registry = (
            registry if registry is not None else default_registry()
        )
        self.clock = clock or _time.monotonic
        self._in_flight: Dict[str, _InFlight] = {}
        # node -> (bound-pod-set signature, last-churn timestamp)
        self._churn: Dict[str, tuple] = {}
        self._last_plan: Optional[float] = None
        reg = self.registry.register
        self._c_evaluated = reg(SUBSYSTEM, CANDIDATES_EVALUATED,
                                kind="counter")
        self._c_planned = reg(SUBSYSTEM, DRAINS_PLANNED, kind="counter")
        self._c_vetoed = reg(SUBSYSTEM, DRAINS_VETOED, kind="counter")
        self._c_actuated = reg(SUBSYSTEM, DRAINS_ACTUATED, kind="counter")
        self._g_in_flight = reg(SUBSYSTEM, IN_FLIGHT)
        self._g_eval_ms = reg(SUBSYSTEM, BATCH_EVAL_MS)
        self._g_candidates = reg(SUBSYSTEM, BATCH_CANDIDATES)

    # -- plan cadence ------------------------------------------------------

    def maybe_plan(self, now: Optional[float] = None) -> None:
        """Plan at most once per `plan_interval_s`; the ScalableNodeGroup
        controller calls this every reconcile, so the cadence is bounded
        here rather than in the caller."""
        now = self.clock() if now is None else now
        if (
            self._last_plan is not None
            and now - self._last_plan < self.config.plan_interval_s
        ):
            return
        self.plan(now)

    def plan(self, now: Optional[float] = None) -> Dict[str, bool]:
        """One full planning round: snapshot, advance the FSM, evaluate
        new candidates in one batched solver call, cordon the drainable
        ones. Returns {candidate: verdict} for observability/tests."""
        now = self.clock() if now is None else now
        if self.disruption_gate is not None and not self.disruption_gate():
            # recovery warm-up: fleet state is unconfirmed after a
            # restart — plan nothing, and do NOT stamp _last_plan so the
            # first post-warm-up reconcile plans immediately
            return {}
        self._last_plan = now
        groups = P.discover_groups(self.store)
        view = P.cluster_view(self.store, groups)
        by_name = view.by_name()
        self._update_churn(view, now)
        self._drop_vanished(by_name)
        self._retry_uncordons()
        self._expire_stale_drains(now)

        reverify = [
            s.node for s in self._in_flight.values()
            if s.phase == CORDONED and s.node in by_name
        ]
        fresh = self._generate_candidates(view, now)
        names = reverify + fresh
        if not names:
            self._publish(0, 0.0)
            return {}

        t0 = _time.perf_counter()
        verdicts = P.evaluate(
            view, names, self.service,
            buckets=self.config.buckets, backend=self.config.backend,
        )
        eval_ms = (_time.perf_counter() - t0) * 1e3
        self._c_evaluated.inc("-", "-", float(len(names)))

        self._advance_cordoned(reverify, verdicts, now)
        self._cordon_drainable(view, fresh, verdicts, now)
        self._publish(len(names), eval_ms)
        return verdicts

    # -- candidate generation ---------------------------------------------

    def _update_churn(self, view: P.ClusterView, now: float) -> None:
        for nv in view.nodes:
            signature = frozenset(
                (p.metadata.namespace, p.metadata.name) for p in nv.pods
            )
            previous = self._churn.get(nv.name)
            if previous is None or previous[0] != signature:
                self._churn[nv.name] = (signature, now)
        live = {nv.name for nv in view.nodes}
        for name in [n for n in self._churn if n not in live]:
            del self._churn[name]

    def _drop_vanished(self, by_name) -> None:
        for name in [n for n in self._in_flight if n not in by_name]:
            # the node left the cluster out from under the FSM (a manual
            # delete, another actor): nothing left to drain
            del self._in_flight[name]
            self._journal_del(name)

    # -- crash-safe FSM journal (karpenter_tpu/recovery) -------------------

    def _journal_set(self, state: _InFlight) -> None:
        if self.journal is not None:
            self.journal.set(
                ("node", state.node),
                {
                    "group": list(state.group),
                    "phase": state.phase,
                    "since": state.since,
                },
            )

    def _journal_del(self, name: str) -> None:
        if self.journal is not None:
            self.journal.delete(("node", name))

    def snapshot_state(self) -> Dict[str, dict]:
        """Full FSM table for the recovery checkpoint (same layout the
        journal folds to)."""
        from karpenter_tpu_torch.recovery.journal import key_str

        return {
            key_str(("node", s.node)): {
                "group": list(s.group),
                "phase": s.phase,
                "since": s.since,
            }
            for s in self._in_flight.values()
        }

    def restore_state(self, entries: dict, now: Optional[float] = None) -> None:
        """Rebuild the in-flight FSM from a replayed journal table: a
        cordoned node resumes its phase (and its verify soak) instead of
        being re-cordoned from scratch. Restored `since` stamps are
        capped at `now` — the shared clock is wall time, but a skewed
        stamp must never fast-forward a soak."""
        from karpenter_tpu_torch.recovery.journal import key_tuple

        now = self.clock() if now is None else now
        for k, v in entries.items():
            name = key_tuple(k)[1]
            self._in_flight[name] = _InFlight(
                node=name,
                group=tuple(v["group"]),
                phase=v["phase"],
                since=min(float(v["since"]), now),
            )
        if self._in_flight:
            self._publish_in_flight()
            logger().info(
                "consolidation: restored %d in-flight drain(s) from "
                "the journal: %s",
                len(self._in_flight),
                {s.node: s.phase for s in self._in_flight.values()},
            )
        self._release_orphan_cordons()

    def _release_orphan_cordons(self) -> None:
        """Uncordon nodes carrying OUR state annotation with no restored
        FSM entry — a crash between the durable cordon write and its
        journal append leaves exactly this orphan, and the candidate
        gate would otherwise exclude it forever (a cordoned node is
        nobody's receiver). The invariant stands: a node is never left
        unschedulable with nobody owning it."""
        for key in list(self.store.keys("Node")):
            name = key[2]
            if name in self._in_flight:
                continue
            node = self.store.try_get(*key)
            if (
                node is None
                or STATE_ANNOTATION not in node.metadata.annotations
            ):
                continue
            logger().warning(
                "consolidation: releasing orphan cordon on %s (state "
                "annotation present, no journaled FSM entry — crash "
                "between cordon and journal append)", name,
            )
            if not self._uncordon(name):
                # the uncordon write conflicted: adopt the node in
                # UNCORDONING so every plan retries until it lands
                self._in_flight[name] = _InFlight(
                    node=name, group=("", "", ""),
                    phase=UNCORDONING, since=self.clock(),
                )
                self._journal_set(self._in_flight[name])

    @staticmethod
    def _budget_key(group: tuple) -> tuple:
        # budgets bind to the actuation target (namespace, ref) — two
        # producers pointing one ScalableNodeGroup share one budget
        return (group[0], group[2])

    def _budget_left(self, group: tuple) -> int:
        key = self._budget_key(group)
        in_flight = sum(
            1 for s in self._in_flight.values()
            if self._budget_key(s.group) == key
        )
        return self.config.budget_per_group - in_flight

    def _eligible(
        self, nv: P.NodeView, now: float, guarded=frozenset()
    ) -> bool:
        """All the pre-solve gates: in-flight, another engine's node
        hold, actuatability (a group with a ScalableNodeGroup ref),
        schedulability (cordoned nodes are someone's in-progress
        intent), do-not-disrupt, pod-churn cooldown, and the group's
        disruption budget."""
        if nv.name in self._in_flight or nv.do_not_disrupt:
            return False
        if nv.name in guarded:
            return False  # another disruption engine owns this node
        if nv.group is None or not nv.group[2]:
            return False  # no ScalableNodeGroup to shrink: unactuatable
        if not nv.receiver:
            return False  # already cordoned (by us or anyone)
        churn = self._churn.get(nv.name)
        if churn is None or now - churn[1] < self.config.cooldown_s:
            return False
        return self._budget_left(nv.group) > 0

    def _generate_candidates(
        self, view: P.ClusterView, now: float
    ) -> List[str]:
        """Eligible fresh candidates, emptiest-first (the cheapest drains
        evaluate and actuate first), capped at max_candidates."""
        # one guard snapshot per planning round, not per candidate
        guarded = (
            self.node_guard() if self.node_guard is not None
            else frozenset()
        )
        eligible = [
            nv
            for nv in view.nodes
            if self._eligible(nv, now, guarded)
        ]
        eligible.sort(key=lambda nv: (len(nv.pods), nv.name))
        return [nv.name for nv in eligible[: self.config.max_candidates]]

    # -- state machine -----------------------------------------------------

    def _retry_uncordons(self) -> None:
        for name in [
            s.node for s in self._in_flight.values()
            if s.phase == UNCORDONING
        ]:
            self._release(name)

    def _expire_stale_drains(self, now: float) -> None:
        """A DRAINING node whose scale-down is never observed — a
        concurrent spec writer reverting the decrement, a provider that
        never converges — is vetoed past drain_timeout_s and returned
        to service; the replica intent stays whatever its writers last
        wrote (re-raising it here would just be another writer fight)."""
        for name in [
            s.node for s in self._in_flight.values()
            if s.phase == DRAINING
            and now - s.since >= self.config.drain_timeout_s
        ]:
            self._veto(name, "scale-down never observed before timeout")

    def _veto(self, name: str, reason: str) -> None:
        self._c_vetoed.inc("-", "-")
        logger().info("consolidation veto: %s (%s)", name, reason)
        self._release(name)

    def _release(self, name: str) -> None:
        """Uncordon and retire the FSM entry. A failed store write keeps
        the entry in UNCORDONING so the next plan retries — a node must
        never be left unschedulable with nobody owning it."""
        if self._uncordon(name):
            self._in_flight.pop(name, None)
            self._journal_del(name)
            return
        state = self._in_flight.get(name)
        if state is not None:
            state.phase = UNCORDONING
            state.since = self.clock()
            self._journal_set(state)

    def _advance_cordoned(self, reverify, verdicts, now: float) -> None:
        for name in reverify:
            state = self._in_flight[name]
            if not verdicts.get(name, False):
                # the cluster changed under the soak: put the node back
                self._veto(name, "no longer drainable")
            elif now - state.since >= self.config.verify_s:
                state.phase = APPROVED
                self._actuate(state)

    def _cordon_drainable(self, view, fresh, verdicts, now: float) -> None:
        by_name = view.by_name()
        for name in fresh:
            if not verdicts.get(name, False):
                continue
            nv = by_name[name]
            if self._budget_left(nv.group) <= 0:
                continue  # an earlier candidate took the budget slot
            if not self._cordon(name):
                continue
            state = self._in_flight[name] = _InFlight(
                node=name, group=nv.group, phase=CORDONED, since=now
            )
            self._journal_set(state)
            self._c_planned.inc("-", "-")
            logger().info(
                "consolidation: cordoned %s (group %s/%s), verifying "
                "for %.0fs", name, nv.group[0], nv.group[2],
                self.config.verify_s,
            )

    def _cordon(self, name: str) -> bool:
        return self._set_schedulable(name, False)

    def _uncordon(self, name: str) -> bool:
        return self._set_schedulable(name, True)

    def _node_key(self, name: str):
        """Nodes are cluster-scoped but stored under whatever namespace
        their ObjectMeta carries; resolve by name across the kind."""
        for key in self.store.keys("Node"):
            if key[2] == name:
                return key
        return None

    def _set_schedulable(self, name: str, schedulable: bool) -> bool:
        key = self._node_key(name)
        node = self.store.try_get(*key) if key else None
        if node is None:
            return False
        node.spec.unschedulable = not schedulable
        if schedulable:
            node.metadata.annotations.pop(STATE_ANNOTATION, None)
        else:
            node.metadata.annotations[STATE_ANNOTATION] = CORDONED
        try:
            self.store.update(node)
            return True
        except Exception as e:  # noqa: BLE001 — racing writers: next
            # plan retries from fresh state rather than crashing the tick
            logger().warning("consolidation cordon %s failed: %s", name, e)
            return False

    # -- actuation ---------------------------------------------------------

    def _actuate(self, state: _InFlight) -> None:
        """Decrement the owning ScalableNodeGroup's spec.replicas through
        the scale subresource — the same intent door the autoscaler
        writes; the ScalableNodeGroup controller's spec-vs-observed loop
        then performs the provider call.

        The DRAINING transition is journaled WRITE-AHEAD (before the
        scale write): a crash between the journal record and the store
        write restores to DRAINING whose scale-down is never observed —
        drain_timeout_s then vetoes it safely. The reverse order would
        restore to APPROVED after a landed decrement and decrement
        AGAIN on the next plan: one drain, two replicas gone."""
        namespace, _, ref = state.group
        state.phase = DRAINING
        state.since = self.clock()  # drain_timeout_s measures THIS phase
        self._journal_set(state)
        inject("process.crash.drain")  # the mid-drain kill point
        try:
            scale = self.store.get_scale(
                "ScalableNodeGroup", namespace, ref
            )
            current = (
                scale.spec_replicas
                if scale.spec_replicas is not None
                else scale.status_replicas
            )
            if current is None or current <= 0:
                raise RuntimeError(
                    f"group {namespace}/{ref} has no replicas to shed"
                )
            scale.spec_replicas = current - 1
            self.store.update_scale("ScalableNodeGroup", scale)
        except Exception as e:  # noqa: BLE001 — a missing/conflicted
            # group vetoes the drain: uncordon and retry from scratch
            self._veto(
                state.node,
                f"actuation failed ({type(e).__name__}: {e})",
            )
            return
        logger().info(
            "consolidation: draining %s (scaled %s/%s to %d)",
            state.node, namespace, ref, current - 1,
        )

    def pending_drains(self, namespace: str, group_name: str) -> List[str]:
        """Nodes in the DRAINING phase for one ScalableNodeGroup — what
        the controller reports in its scale-down condition."""
        return sorted(
            s.node for s in self._in_flight.values()
            if s.phase == DRAINING
            and s.group[0] == namespace
            and s.group[2] == group_name
        )

    def on_scale_down(
        self, namespace: str, group_name: str, count: int = 1
    ) -> List[str]:
        """The ScalableNodeGroup controller observed an actuated
        scale-down of this group: finalize up to `count` draining nodes
        (delete the Node object — the provider is removing the capacity)
        and retire their FSM entries. Returns the finalized node names."""
        finalized = []
        for name in self.pending_drains(namespace, group_name)[:count]:
            try:
                key = self._node_key(name)
                if key is not None:
                    self.store.delete(*key)
            except Exception:  # noqa: BLE001 — already gone is fine
                pass
            del self._in_flight[name]
            self._journal_del(name)
            self._c_actuated.inc("-", "-")
            finalized.append(name)
            logger().info("consolidation: drained %s", name)
        if finalized:
            self._publish_in_flight()
        return finalized

    # -- metrics -----------------------------------------------------------

    def in_flight(self) -> Dict[str, str]:
        """{node: phase} — observability and test surface."""
        return {s.node: s.phase for s in self._in_flight.values()}

    def _publish_in_flight(self) -> None:
        self._g_in_flight.set("-", "-", float(len(self._in_flight)))

    def _publish(self, candidates: int, eval_ms: float) -> None:
        self._publish_in_flight()
        self._g_candidates.set("-", "-", float(candidates))
        if candidates:
            self._g_eval_ms.set("-", "-", eval_ms)
