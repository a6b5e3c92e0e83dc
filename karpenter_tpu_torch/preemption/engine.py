"""Preemption engine: budgets, conflict resolution, eviction actuation
(the port's copy of karpenter_tpu/preemption/engine.py).

The planner (planner.py) and kernel (ops/preempt.py) answer the pure
question — for each high-priority pending pod, the cheapest eviction
set that admits it. This module wraps those plans in the operational
safety a production eviction needs, deliberately mirroring the
consolidation engine's posture (consolidation/engine.py) so the two
disruption subsystems behave — and coordinate — alike:

  * DO-NOT-DISRUPT: pods (or nodes) annotated
    `karpenter.sh/do-not-disrupt: "true"` are never victims — folded
    into the kernel's evictable mask by the planner.
  * NODE COORDINATION: nodes the consolidation FSM currently owns
    (cordoned / verifying / draining) are excluded from preemption —
    forbidden as receivers AND protected as victims — and nodes a
    preemption plan just targeted are HELD for `hold_s`, which the
    consolidation engine's candidate gate consults (its `node_guard`
    seam). The two engines can never disrupt one node at once.
  * DISRUPTION BUDGETS (PDB-style): at most `budget_per_group`
    evictions may be charged against one ScalableNodeGroup's nodes
    inside a hold window — per-group override via
    spec.eviction_budget. Plans that would exceed the budget are
    DEFERRED to a later round, not trimmed (a partial eviction set
    frees capacity without admitting the candidate — pure disruption).
  * CONFLICT RESOLUTION: the kernel plans candidates independently;
    the engine accepts plans greedily in candidate order (highest
    priority first — the planner sorts them) and defers any plan whose
    victims or target node a previously-accepted plan already claimed.
  * NO DUPLICATE EVICTIONS: a victim is evicted at most once — claimed
    victims are tracked per round, and an eviction is a conditional
    store delete (already-gone pods are counted as no-ops, never
    retried as fresh disruptions).

Actuation is API-level eviction: the victim Pod is deleted through the
store (the in-process analog of the Eviction subresource); its workload
controller re-creates it as a pending pod, which the ordinary
pending-capacity solve then routes to a scale-up — exactly how
kube-scheduler preemption composes with cluster autoscaling.

Metrics (subsystem "preemption", runtime registry):
karpenter_preemption_{candidates_evaluated_total,plans_total,
evictions_total,deferred_total,unplaceable,batch_eval_ms}.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from karpenter_tpu_torch.api.core import effective_priority
from karpenter_tpu_torch.consolidation.planner import (
    cluster_view,
    discover_groups,
)
from karpenter_tpu_torch.faults import inject
from karpenter_tpu_torch.metrics.registry import GaugeRegistry, default_registry
from karpenter_tpu_torch.preemption import planner as P
from karpenter_tpu_torch.store.columnar import is_pending
from karpenter_tpu_torch.utils.log import logger

SUBSYSTEM = "preemption"

CANDIDATES_EVALUATED = "candidates_evaluated_total"
PLANS = "plans_total"
EVICTIONS = "evictions_total"
DEFERRED = "deferred_total"
UNPLACEABLE = "unplaceable"
BATCH_EVAL_MS = "batch_eval_ms"


@dataclass
class PreemptionConfig:
    plan_interval_s: float = 30.0
    # default max evictions charged against one ScalableNodeGroup's
    # nodes per hold window (spec.eviction_budget overrides per group)
    budget_per_group: int = 1
    # pending pods below this priority never trigger evictions (they
    # wait for ordinary scale-up); 1 keeps the default-priority fleet
    # (priority 0) preemption-free
    min_candidate_priority: int = 1
    max_candidates: int = 64
    max_victims: int = 4096
    # fleet default for pods naming an unknown PriorityClass
    default_priority: int = 0
    # how long an accepted plan's target node stays held (guards
    # consolidation away, and spaces repeat disruption of one node)
    hold_s: float = 120.0
    backend: Optional[str] = None  # None = the service's default


@dataclass
class _Charge:
    """One accepted plan's budget charge against a group."""

    expires: float
    evictions: int = 1


class PreemptionEngine:
    """Owns the plan cadence, budgets, holds, and eviction actuation."""

    def __init__(
        self,
        store,
        solver_service,
        consolidation=None,
        registry: Optional[GaugeRegistry] = None,
        config: Optional[PreemptionConfig] = None,
        clock=None,
    ):
        self.store = store
        self.service = solver_service
        self.consolidation = consolidation
        # crash safety (karpenter_tpu/recovery, docs/resilience.md):
        # holds and budget charges journal through `journal` so a
        # restarted controller keeps honoring disruption budgets spent
        # before the crash; `disruption_gate` is the recovery warm-up —
        # no eviction planning while it returns False
        self.journal = None
        self.disruption_gate = None
        self.config = config or PreemptionConfig()
        self.registry = (
            registry if registry is not None else default_registry()
        )
        self.clock = clock or _time.monotonic
        self._last_plan: Optional[float] = None
        # node name -> hold expiry (the consolidation node_guard reads
        # this through active_nodes())
        self._holds: Dict[str, float] = {}
        # candidate (namespace, name) -> hold expiry: a candidate whose
        # plan was ACTUATED is not re-planned until the scheduler has
        # had hold_s to bind it onto the freed capacity — without this,
        # a still-pending candidate would trigger fresh evictions on
        # another node every round (disruption amplification)
        self._candidate_holds: Dict[Tuple[str, str], float] = {}
        # budget key (namespace, nodeGroupRef) -> live charges
        self._charges: Dict[Tuple[str, str], List[_Charge]] = {}
        reg = self.registry.register
        self._c_evaluated = reg(
            SUBSYSTEM, CANDIDATES_EVALUATED, kind="counter"
        )
        self._c_plans = reg(SUBSYSTEM, PLANS, kind="counter")
        self._c_evictions = reg(SUBSYSTEM, EVICTIONS, kind="counter")
        self._c_deferred = reg(SUBSYSTEM, DEFERRED, kind="counter")
        self._g_unplaceable = reg(SUBSYSTEM, UNPLACEABLE)
        self._g_eval_ms = reg(SUBSYSTEM, BATCH_EVAL_MS)

    # -- coordination surface ---------------------------------------------

    def active_nodes(self) -> Set[str]:
        """Nodes currently held by an accepted eviction plan — the
        consolidation engine's node_guard seam consults this so a node
        being preempted onto is never simultaneously drained."""
        now = self.clock()
        self._holds = {
            n: exp for n, exp in self._holds.items() if exp > now
        }
        return set(self._holds)

    def _excluded_nodes(self) -> Set[str]:
        excluded = self.active_nodes()
        if self.consolidation is not None:
            excluded |= set(self.consolidation.in_flight())
        return excluded

    # -- plan cadence ------------------------------------------------------

    def maybe_plan(self, now: Optional[float] = None) -> None:
        """Plan at most once per plan_interval_s; the ScalableNodeGroup
        controller calls this every reconcile like consolidation's."""
        now = self.clock() if now is None else now
        if (
            self._last_plan is not None
            and now - self._last_plan < self.config.plan_interval_s
        ):
            return
        self.plan(now)

    def _candidates(self) -> List:
        """High-priority pending pods, highest priority first (the
        greedy acceptance order), capped at max_candidates."""
        default = self.config.default_priority
        now = self.clock()
        self._candidate_holds = {
            k: exp
            for k, exp in self._candidate_holds.items()
            if exp > now
        }
        pending = [
            pod
            for pod in self.store.list("Pod")
            if is_pending(pod)
            and (pod.metadata.namespace, pod.metadata.name)
            not in self._candidate_holds
            and effective_priority(pod, default=default)
            >= self.config.min_candidate_priority
        ]
        pending.sort(
            key=lambda p: (
                -effective_priority(p, default=default),
                p.metadata.namespace,
                p.metadata.name,
            )
        )
        return pending[: self.config.max_candidates]

    def _preemptible_groups(self) -> frozenset:
        return frozenset(
            (sng.metadata.namespace, sng.metadata.name)
            for sng in self.store.list("ScalableNodeGroup")
            if sng.spec.preemptible
        )

    def plan(self, now: Optional[float] = None) -> Dict[tuple, Optional[dict]]:
        """One full round: snapshot, one batched eviction solve through
        the service, greedy conflict/budget resolution, actuation.
        Returns {(namespace, name): accepted plan or None} per candidate
        for observability/tests."""
        now = self.clock() if now is None else now
        if self.disruption_gate is not None and not self.disruption_gate():
            # recovery warm-up: no eviction until fleet state is
            # confirmed; _last_plan stays unset so the first
            # post-warm-up reconcile plans immediately
            return {}
        self._last_plan = now
        self._expire_charges(now)
        candidates = self._candidates()
        if not candidates:
            self._g_unplaceable.set("-", "-", 0.0)
            return {}
        groups = discover_groups(self.store)
        view = cluster_view(self.store, groups)
        inputs, victim_keys, node_names = P.build_problem(
            view,
            candidates,
            default_priority=self.config.default_priority,
            excluded_nodes=frozenset(self._excluded_nodes()),
            preemptible_groups=self._preemptible_groups(),
            max_victims=self.config.max_victims,
        )
        t0 = _time.perf_counter()
        out = self.service.preempt(inputs, backend=self.config.backend)
        self._g_eval_ms.set(
            "-", "-", (_time.perf_counter() - t0) * 1e3
        )
        self._c_evaluated.inc("-", "-", float(len(candidates)))
        self._g_unplaceable.set("-", "-", float(int(out.unplaceable)))
        plans = P.plan_rows(out, victim_keys, node_names)
        return self._resolve_and_actuate(
            view, candidates, plans, now
        )

    # -- resolution + actuation -------------------------------------------

    def _expire_charges(self, now: float) -> None:
        for key in list(self._charges):
            live = [
                c for c in self._charges[key] if c.expires > now
            ]
            if live:
                self._charges[key] = live
            else:
                del self._charges[key]

    @staticmethod
    def _budget_key(group: Optional[tuple], node: str) -> Tuple[str, str]:
        """Charges bind to the actuation target (namespace, ref); a
        node outside any actuatable group charges its OWN key — one
        ungrouped node's evictions must not throttle every other
        ungrouped node cluster-wide."""
        if group is not None and group[2]:
            return (group[0], group[2])
        return ("__node__", node)

    def _budget_left(self, group: Optional[tuple], node: str) -> int:
        """Remaining eviction budget for the target node's owner:
        spec.eviction_budget when set, else the engine default, minus
        live charges. Ungrouped nodes get the engine default (there is
        no spec to consult)."""
        budget = self.config.budget_per_group
        key = self._budget_key(group, node)
        if group is not None and group[2]:
            sng = self.store.try_get(
                "ScalableNodeGroup", group[0], group[2]
            )
            if sng is not None and sng.spec.eviction_budget is not None:
                budget = sng.spec.eviction_budget
        charged = sum(
            c.evictions for c in self._charges.get(key, [])
        )
        return budget - charged

    def _charge(
        self, group: Optional[tuple], count: int, now: float, node: str
    ) -> None:
        bkey = self._budget_key(group, node)
        self._charges.setdefault(bkey, []).append(
            _Charge(expires=now + self.config.hold_s, evictions=count)
        )
        self._journal_charges(bkey)

    # -- crash-safe journal (karpenter_tpu/recovery) -----------------------

    def _journal_charges(self, bkey: Tuple[str, str]) -> None:
        if self.journal is None:
            return
        live = self._charges.get(bkey, [])
        if live:
            self.journal.set(
                ("charge",) + bkey,
                [[c.expires, c.evictions] for c in live],
            )
        else:
            self.journal.delete(("charge",) + bkey)

    def _journal_hold(self, node: str, expires: Optional[float]) -> None:
        if self.journal is None:
            return
        if expires is None:
            self.journal.delete(("hold", node))
        else:
            self.journal.set(("hold", node), expires)

    def _journal_candidate_hold(self, key: Tuple[str, str]) -> None:
        if self.journal is not None:
            self.journal.set(
                ("cand",) + key, self._candidate_holds[key]
            )

    def snapshot_state(self) -> Dict[str, object]:
        """Full holds/charges table for the recovery checkpoint (the
        layout the journal folds to)."""
        from karpenter_tpu_torch.recovery.journal import key_str

        state: Dict[str, object] = {}
        for node, exp in self._holds.items():
            state[key_str(("hold", node))] = exp
        for ckey, exp in self._candidate_holds.items():
            state[key_str(("cand",) + ckey)] = exp
        for bkey, charges in self._charges.items():
            if charges:
                state[key_str(("charge",) + bkey)] = [
                    [c.expires, c.evictions] for c in charges
                ]
        return state

    def restore_state(self, entries: dict, now: Optional[float] = None) -> None:
        """Rebuild holds and budget charges from a replayed journal
        table: disruption spent before the crash stays spent, so a
        restart cannot double an eviction budget. Expired entries are
        dropped; surviving expiries are capped at now + hold_s (a
        skewed stamp must not hold a node hostage past one window)."""
        from karpenter_tpu_torch.recovery.journal import key_tuple

        now = self.clock() if now is None else now
        cap = now + self.config.hold_s
        restored = 0
        for k, v in entries.items():
            restored += self._restore_entry(key_tuple(k), v, now, cap)
        if restored:
            logger().info(
                "preemption: restored %d hold/budget entr(ies) from "
                "the journal", restored,
            )

    def _restore_entry(self, key, v, now: float, cap: float) -> int:
        if key[0] == "hold":
            exp = min(float(v), cap)
            if exp > now:
                self._holds[key[1]] = exp
                return 1
        elif key[0] == "cand":
            exp = min(float(v), cap)
            if exp > now:
                self._candidate_holds[(key[1], key[2])] = exp
                return 1
        elif key[0] == "charge":
            live = [
                _Charge(expires=min(float(e), cap), evictions=int(n))
                for e, n in v
                if min(float(e), cap) > now
            ]
            if live:
                self._charges[(key[1], key[2])] = live
                return 1
        return 0

    def _resolve_and_actuate(
        self, view, candidates, plans, now: float
    ) -> Dict[tuple, Optional[dict]]:
        """Greedy acceptance in candidate (priority) order: claim
        victims and target nodes first-come, defer conflicting or
        over-budget plans to a later round."""
        by_name = view.by_name()
        claimed_victims: Set[tuple] = set()
        claimed_nodes: Set[str] = set()
        results: Dict[tuple, Optional[dict]] = {}
        for pod, plan in zip(candidates, plans):
            key = (pod.metadata.namespace, pod.metadata.name)
            if plan is None:
                results[key] = None
                continue
            if not plan["evictions"]:
                # fits without eviction: nothing to actuate — the
                # ordinary schedule/scale path owns zero-disruption
                # placement
                results[key] = plan
                continue
            node = plan["node"]
            group = by_name[node].group if node in by_name else None
            if (
                node in claimed_nodes
                or any(v in claimed_victims for v in plan["evictions"])
            ):
                self._c_deferred.inc("-", "-")
                results[key] = None
                continue
            if self._budget_left(group, node) < len(plan["evictions"]):
                self._c_deferred.inc("-", "-")
                logger().info(
                    "preemption deferred for %s/%s: eviction budget "
                    "exhausted on %s", key[0], key[1], node,
                )
                results[key] = None
                continue
            evicted = self._actuate_with_charge(plan, group, node, now)
            if not evicted:
                results[key] = None
                continue
            claimed_nodes.add(node)
            claimed_victims.update(plan["evictions"])
            results[key] = self._finish_accepted(
                key, node, plan, evicted, now
            )
        return results

    def _actuate_with_charge(
        self, plan: dict, group, node: str, now: float
    ) -> List[tuple]:
        """WRITE-AHEAD actuation: the hold and the FULL plan's budget
        charge journal BEFORE any eviction lands, so a crash mid-batch
        restores with the disruption already charged — a restarted
        controller can never spend a budget twice. What actually
        happened is reconciled after actuation: zero evictions releases
        the charge and hold, a partial set adjusts the charge down to
        the evictions that landed."""
        self._holds[node] = now + self.config.hold_s
        self._journal_hold(node, self._holds[node])
        self._charge(group, len(plan["evictions"]), now, node)
        evicted = self._actuate(plan)
        bkey = self._budget_key(group, node)
        if not evicted:
            self._charges[bkey].pop()
            if not self._charges[bkey]:
                del self._charges[bkey]
            self._journal_charges(bkey)
            self._holds.pop(node, None)
            self._journal_hold(node, None)
        elif len(evicted) < len(plan["evictions"]):
            self._charges[bkey][-1].evictions = len(evicted)
            self._journal_charges(bkey)
        return evicted

    def _finish_accepted(
        self, key, node: str, plan: dict, evicted: List[tuple],
        now: float,
    ) -> Optional[dict]:
        """Post-actuation accounting. A FULLY actuated plan is
        accepted (candidate held for hold_s). A partial set — a store
        conflict vetoed some victims — is NOT: the freed capacity may
        not admit the candidate, so it re-plans promptly; the
        disruption that DID happen stays charged and the node stays
        held."""
        if len(evicted) < len(plan["evictions"]):
            self._c_deferred.inc("-", "-")
            logger().warning(
                "preemption partially actuated on %s (%d/%d "
                "evictions); re-planning %s/%s next round",
                node, len(evicted), len(plan["evictions"]),
                key[0], key[1],
            )
            return None
        self._candidate_holds[key] = now + self.config.hold_s
        self._journal_candidate_hold(key)
        self._c_plans.inc("-", "-")
        logger().info(
            "preemption: evicted %d pod(s) from %s to admit %s/%s",
            len(evicted), node, key[0], key[1],
        )
        return dict(plan, evictions=evicted)

    def _actuate(self, plan: dict) -> List[tuple]:
        """Evict the plan's victims (store delete — the in-process
        Eviction analog). Conditional per victim: a pod already gone
        (raced by its own lifecycle) is skipped, never double-counted;
        a store conflict vetoes just that victim and the plan reports
        what it actually evicted."""
        evicted = []
        for i, (namespace, name) in enumerate(plan["evictions"]):
            if i:
                # the mid-eviction-batch kill point
                inject("process.crash.evict")
            pod = self.store.try_get("Pod", namespace, name)
            if pod is None or not pod.spec.node_name:
                continue  # already gone or already unbound
            try:
                self.store.delete("Pod", namespace, name)
            except Exception as e:  # noqa: BLE001 — racing writers:
                # the next plan re-evaluates from fresh state
                logger().warning(
                    "preemption eviction %s/%s failed: %s",
                    namespace, name, e,
                )
                continue
            evicted.append((namespace, name))
            self._c_evictions.inc("-", "-")
        return evicted
