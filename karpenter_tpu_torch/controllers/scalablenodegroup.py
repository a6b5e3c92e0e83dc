"""ScalableNodeGroup controller: actuate replicas against the cloud provider
(the port's copy of karpenter_tpu/controllers/scalablenodegroup.py; the
runtime passes its RecoveryManager as `recovery` under --journal-dir, and
every provider write is then fenced).

reference: pkg/controllers/scalablenodegroup/v1alpha1/controller.go:48-95 —
stabilization check, observe replicas into status, set replicas when spec
diverges; retryable provider errors mark AbleToScale false WITHOUT
deactivating the resource (the next loop will likely succeed).

Consolidation (karpenter_tpu/consolidation) rides this controller: the
engine plans drains on this controller's cadence (`maybe_plan`), expresses
an approved drain as a spec.replicas decrement through the scale
subresource, and this controller's ordinary spec-vs-observed loop performs
the provider call — consolidation never bypasses the one actuation door.
When the scale-down lands, the engine is told (`on_scale_down`) so it can
finalize the drained nodes.

Circuit breaker (docs/resilience.md): each node group carries its own
breaker around the provider calls. After `circuit_failure_threshold`
consecutive provider failures the circuit OPENS: reconciles stop
touching the provider entirely (a flapping cloud API no longer eats the
tick) and the resource reports AbleToScale=False with the structured
ActuationCircuitOpen reason, the last RetryableError.code, and the
next-probe ETA. After `circuit_reset_s` one half-open probe reconcile is
admitted; success closes the circuit, failure re-opens it for a fresh
window.

Crash safety (karpenter_tpu/recovery, docs/resilience.md "Crash
recovery"): with a RecoveryManager wired, every provider write is
FENCED — stamped with the incarnation's generation token, which the
provider verifies before applying, so a stale (restarted-over or
split-brain) controller cannot replay a dead decision — and journaled
as an intent/ack pair: an intent without an ack after a crash marks an
actuation of unknown fate, which the level-triggered spec-vs-observed
loop resolves idempotently (observed already at target → the write
landed; otherwise it is re-issued under a fresh token) — exactly-once
either way. Breaker state journals too: a provider that was flapping
before the crash is still circuit-broken after it.
"""

from __future__ import annotations

from typing import Dict

from karpenter_tpu_torch.api import conditions as cond
from karpenter_tpu_torch.api.scalablenodegroup import ScalableNodeGroup
from karpenter_tpu_torch.controllers.errors import error_code, is_retryable
from karpenter_tpu_torch.observability import (
    default_flight_recorder,
    default_tracer,
)
from karpenter_tpu_torch.resilience import CLOSED as resilience_CLOSED
from karpenter_tpu_torch.resilience import CircuitBreaker
from karpenter_tpu_torch.utils.log import logger


def _serving_replicas(resource, observed: int, warm: int) -> int:
    """What status.replicas reports: SERVING replicas, warm headroom
    excluded. The scale subresource feeds the decision kernel's
    proportional math as current replicas (Value/Utilization targets),
    and counting warm nodes there would ratchet the fleet up by the
    warm amount every tick (spec rises to match the inflated status,
    warm rides on top, repeat until maxReplicas). Only nodes BEYOND
    spec.replicas are warm — mid-transition, everything observed up to
    spec is serving — and with warm 0 this is exactly `observed`
    (byte-identical pre-warm-pool behavior)."""
    if resource.spec.replicas is None or warm <= 0:
        return observed
    return min(observed, max(resource.spec.replicas, observed - warm))


class ScalableNodeGroupController:
    # this controller ACKS the e2e lead-time mark (ack_observed on the
    # provider-write return, drop_observed on convergence): the engine
    # only stamps marks for kinds that declare this — stamping kinds
    # nothing acks would be pure hot-path overhead (engine._on_event)
    acks_e2e = True

    def __init__(
        self,
        cloud_provider_factory,
        consolidator=None,
        preemptor=None,
        warmpool=None,
        registry=None,
        circuit_failure_threshold: int = 5,
        circuit_reset_s: float = 120.0,
        clock=None,
        recovery=None,
    ):
        import time as _time

        self.cloud_provider = cloud_provider_factory
        # ConsolidationEngine (or None): planning is bounded by the
        # engine's own interval, so calling it every reconcile is cheap
        self.consolidator = consolidator
        # PreemptionEngine (or None): same cadence door — eviction
        # planning rides the reconcile loop, interval-bounded in-engine
        self.preemptor = preemptor
        # WarmPoolEngine (or None): spec.warmPool groups actuate
        # spec.replicas + warm through this controller's one provider
        # door (docs/cost.md "Warm pools"); groups without the spec see
        # byte-identical behavior (warm == 0)
        self.warmpool = warmpool
        self.circuit_failure_threshold = circuit_failure_threshold
        self.circuit_reset_s = circuit_reset_s
        self.clock = clock or _time.monotonic
        # one breaker per resource (namespace, name): group A's flapping
        # ASG must not trip group B's actuation
        self._breakers: Dict[tuple, CircuitBreaker] = {}
        # crash safety (module docstring): the RecoveryManager supplies
        # the fence generation, the breaker/actuation journal handles,
        # and the replayed tables restored below
        self.recovery = recovery
        self.fence = recovery.fence if recovery is not None else None
        self._j_breaker = self._j_actuation = None
        # (namespace, name) -> un-acked intent: live during the provider
        # write, and restored from the journal after a crash
        self._intents: Dict[tuple, dict] = {}
        # breakers currently present in the journal table (avoids a
        # delete record per healthy reconcile)
        self._journaled_breakers: set = set()
        self._g_circuit = self._c_opens = None
        if registry is not None:
            self._g_circuit = registry.register(
                "resilience", "circuit_state"
            )
            self._c_opens = registry.register(
                "resilience", "circuit_open_total", kind="counter"
            )
        if recovery is not None:
            self._j_breaker = recovery.handle("breaker")
            self._j_actuation = recovery.handle("actuation")
            self._restore_recovery_state()
            recovery.register_snapshot("breaker", self.snapshot_breakers)
            recovery.register_snapshot("actuation", self._snapshot_intents)

    def kind(self) -> str:
        return ScalableNodeGroup.KIND

    def interval(self) -> float:
        return 60.0

    def on_deleted(self, resource) -> None:
        """Engine deletion hook: drop the per-object breaker and its
        gauge series — a recreated group with the same name must start
        with a CLOSED circuit, not inherit a dead group's open one."""
        key = (resource.metadata.namespace, resource.metadata.name)
        self._breakers.pop(key, None)
        if self.warmpool is not None:
            self.warmpool.on_deleted(resource)
        if self._j_breaker is not None and key in self._journaled_breakers:
            self._j_breaker.delete(key)
            self._journaled_breakers.discard(key)
        # a pending intent dies with its group too: a later group
        # RECREATED under the same name must not resolve a dead epoch's
        # actuation intent
        if self._intents.pop(key, None) is not None and (
            self._j_actuation is not None
        ):
            self._j_actuation.delete(key)
        if self._g_circuit is not None:
            self._g_circuit.remove(
                resource.metadata.name, resource.metadata.namespace
            )

    # -- crash-safe state (karpenter_tpu/recovery) -------------------------

    def _journal_breaker(self, key: tuple, breaker: CircuitBreaker) -> None:
        if self._j_breaker is None:
            return
        if breaker.state == resilience_CLOSED and (
            breaker.consecutive_failures == 0
        ):
            # a pristine breaker is the default: journal a delete (once)
            # instead of a set, so the table — and the per-tick journal
            # traffic of a HEALTHY fleet — stays proportional to sick
            # groups, not to fleet size
            if key in self._journaled_breakers:
                self._j_breaker.delete(key)
                self._journaled_breakers.discard(key)
            return
        self._j_breaker.set(key, self._breaker_doc(breaker))
        self._journaled_breakers.add(key)

    @staticmethod
    def _breaker_doc(breaker: CircuitBreaker) -> dict:
        return {
            "state": breaker.state,
            "failures": breaker.consecutive_failures,
            "opened_at": breaker.opened_at,
            "opens_total": breaker.opens_total,
            "code": breaker.last_error_code,
        }

    def snapshot_breakers(self) -> Dict[str, dict]:
        from karpenter_tpu_torch.recovery.journal import key_str

        return {
            key_str(key): self._breaker_doc(breaker)
            for key, breaker in self._breakers.items()
            if not (
                breaker.state == resilience_CLOSED
                and breaker.consecutive_failures == 0
            )
        }

    def _snapshot_intents(self) -> Dict[str, dict]:
        from karpenter_tpu_torch.recovery.journal import key_str

        return {key_str(k): v for k, v in self._intents.items()}

    def _restore_recovery_state(self) -> None:
        """Rebuild breakers and pending actuation intents from the
        replayed journal tables. A restored OPEN breaker keeps its
        window (opened_at capped at now — a skewed stamp must not
        shorten it); a pending intent marks a pre-crash provider write
        of unknown fate, resolved idempotently on first reconcile."""
        from karpenter_tpu_torch.recovery.journal import key_tuple

        now = self.clock()
        for k, doc in self.recovery.table("breaker").items():
            key = key_tuple(k)
            breaker = CircuitBreaker(
                failure_threshold=self.circuit_failure_threshold,
                reset_s=self.circuit_reset_s,
                clock=self.clock,
            )
            breaker.state = doc["state"]
            breaker.consecutive_failures = int(doc["failures"])
            opened = doc.get("opened_at")
            breaker.opened_at = (
                None if opened is None else min(float(opened), now)
            )
            breaker.opens_total = int(doc.get("opens_total", 0))
            breaker.last_error_code = doc.get("code", "")
            self._breakers[key] = breaker
            self._journaled_breakers.add(key)
        for k, doc in self.recovery.table("actuation").items():
            # mark journal-restored intents: only THESE get the
            # crash-recovery log wording when resolved (an in-session
            # provider failure also leaves an un-acked intent, and
            # calling that "recovered" would send operators hunting
            # for restarts that never happened)
            self._intents[key_tuple(k)] = dict(doc, restored=True)
        if self._breakers or self._intents:
            logger().info(
                "scalablenodegroup: restored %d breaker(s) and %d "
                "pending actuation intent(s) from the journal",
                len(self._breakers), len(self._intents),
            )

    def prune_restored_missing(self, store) -> None:
        """Drop restored breakers/intents whose group was deleted while
        the controller was down — no Deleted event will ever fire for
        them, so without this sweep they would re-persist through every
        future checkpoint forever. The runtime calls this once after
        restore, against the re-listed store."""
        for key in list(self._breakers):
            if store.try_get("ScalableNodeGroup", *key) is None:
                self._breakers.pop(key, None)
                if key in self._journaled_breakers:
                    self._j_breaker.delete(key)
                    self._journaled_breakers.discard(key)
        for akey in list(self._intents):
            if store.try_get("ScalableNodeGroup", *akey) is None:
                self._intents.pop(akey, None)
                if self._j_actuation is not None:
                    self._j_actuation.delete(akey)

    def _breaker(self, resource) -> CircuitBreaker:
        key = (resource.metadata.namespace, resource.metadata.name)
        breaker = self._breakers.get(key)
        if breaker is None:
            breaker = self._breakers[key] = CircuitBreaker(
                failure_threshold=self.circuit_failure_threshold,
                reset_s=self.circuit_reset_s,
                clock=self.clock,
            )
        return breaker

    def _publish_circuit(self, resource, breaker: CircuitBreaker) -> None:
        if self._g_circuit is not None:
            self._g_circuit.set(
                resource.metadata.name,
                resource.metadata.namespace,
                breaker.state_value(),
            )

    def _reconcile(self, resource) -> None:
        if self.preemptor is not None:
            # preemption plans BEFORE consolidation: admitting a
            # high-priority pending pod may consume the very free
            # capacity a drain was counting on — planning order makes
            # the preemption hold visible to this tick's drain gate
            self.preemptor.maybe_plan()
        if self.consolidator is not None:
            # plan before observing: an approved drain decrements
            # spec.replicas via the scale subresource, and the resulting
            # watch event requeues this resource immediately — the
            # actuation lands on the very next tick
            self.consolidator.maybe_plan()
        node_group = self.cloud_provider.node_group_for(resource.spec)
        mgr = resource.status_conditions()

        # 1. stabilization state -> condition
        stable, message = node_group.stabilized()
        if stable:
            mgr.mark_true(cond.STABILIZED)
        else:
            mgr.mark_false(cond.STABILIZED, "", message)

        # 2. observe replicas
        warm = (
            self.warmpool.warm_for(resource)
            if self.warmpool is not None
            else 0
        )
        observed = node_group.get_replicas()
        resource.status.replicas = _serving_replicas(
            resource, observed, warm
        )

        self._resolve_pending_intent(resource, observed)

        # 3. actuate when the TARGET diverges from observation — target
        # = spec.replicas + warm headroom (docs/cost.md "Warm pools";
        # warm is 0 without spec.warmPool, keeping the pre-cost
        # divergence check byte for byte). Scale-UPS never pile onto a
        # group mid-change: overlapping grow resizes against a pool
        # whose previous resize is in flight can strand partial TPU
        # slices (tpu.py module doc); the next loop grows once stable.
        # Scale-DOWNS actuate even while unstable — when a group is
        # stuck converging (e.g. an ASG capped below desired by a
        # capacity shortage, permanently un-stable under the
        # healthy==desired check), the corrective shrink is exactly the
        # action that unsticks it, and blocking it would deadlock the
        # resource.
        if resource.spec.replicas is None:
            default_tracer().drop_observed(self._e2e_key(resource))
            return
        target = resource.spec.replicas + warm
        if target == observed:
            # converged, nothing to actuate: retire any e2e observation
            # mark — a stale stamp must not inflate a later ack's
            # karpenter_reconcile_e2e_seconds sample
            default_tracer().drop_observed(self._e2e_key(resource))
            return
        if not stable and target > observed:
            return
        self._set_replicas(node_group, resource, target)
        # the provider write returned: the actuation is ACKED — close
        # the event-observed -> actuation-acked window (the BLITZSCALE
        # lead-time observable, docs/observability.md)
        default_tracer().ack_observed(self._e2e_key(resource))
        logger().debug(
            "ScalableNodeGroup %s updated nodes %d -> %d (%d warm)",
            resource.spec.id,
            observed,
            target,
            warm,
        )
        if target < observed:
            self._finish_scale_down(
                resource, mgr, observed, target, stable, message
            )

    def _resolve_pending_intent(self, resource, observed: int) -> None:
        """Resolve a pre-crash actuation of unknown fate (an intent
        journaled without an ack): the fresh observation settles it —
        either the write landed before the crash (observed == target;
        nothing to redo) or it didn't and the level-triggered
        spec-vs-observed step re-issues it under a fresh fence token.
        Exactly-once by idempotent replay, never a blind redo."""
        akey = (resource.metadata.namespace, resource.metadata.name)
        intent = self._intents.pop(akey, None)
        if intent is None or self._j_actuation is None:
            return
        self._j_actuation.delete(akey)
        outcome = (
            "landed before the crash"
            if intent.get("target") == observed
            else "not applied; the reconcile loop re-issues it"
        )
        if intent.get("restored"):
            logger().info(
                "recovered actuation intent for %s/%s (target %s): "
                "observed %d — %s",
                akey[0], akey[1], intent.get("target"), observed, outcome,
            )
        else:
            # same-incarnation leftover of a raised provider call: the
            # ordinary retry path, not a crash recovery
            logger().debug(
                "unresolved actuation intent for %s/%s (target %s): "
                "observed %d — %s",
                akey[0], akey[1], intent.get("target"), observed, outcome,
            )

    @staticmethod
    def _e2e_key(resource) -> tuple:
        """The engine's object key — where the manager stamped the
        event-observed time this controller's ack closes."""
        return (
            resource.KIND,
            resource.metadata.namespace,
            resource.metadata.name,
        )

    def _set_replicas(self, node_group, resource, target: int) -> None:
        """The one provider-write door — `target` includes any warm-pool
        headroom on top of spec.replicas. Unfenced (no RecoveryManager):
        the plain call, byte-compatible with every existing provider
        fake. Fenced: journal the intent, stamp the incarnation's fence
        token (the provider verifies it before applying), ack on
        success. A raised provider call leaves the intent UN-acked —
        its fate is unknown (a timeout may have landed), and the next
        reconcile's observation resolves it idempotently."""
        with default_tracer().span(
            "actuate.set_replicas",
            group=resource.spec.id,
            target=target,
            fenced=self.fence is not None,
        ):
            if self.fence is None:
                node_group.set_replicas(target)
                return
            akey = (resource.metadata.namespace, resource.metadata.name)
            intent = {
                "target": target,
                "gen": self.fence.generation,
            }
            self._intents[akey] = intent
            if self._j_actuation is not None:
                self._j_actuation.set(akey, intent)
            node_group.set_replicas(target, token=self.fence.token())
            self._intents.pop(akey, None)
            if self._j_actuation is not None:
                self._j_actuation.delete(akey)

    def _finish_scale_down(
        self, resource, mgr, observed: int, target: int, stable: bool,
        message: str,
    ) -> None:
        """Post-actuation bookkeeping for a shrink: let the consolidation
        engine finalize any drains this scale-down carries, and surface a
        disruption-under-instability as a STRUCTURED condition (reason +
        transition timestamp) on the API object, not just a log line —
        operators watching the resource see WHY a shrinking group moved
        while unconverged."""
        drained = []
        if self.consolidator is not None:
            drained = self.consolidator.on_scale_down(
                resource.metadata.namespace,
                resource.metadata.name,
                observed - target,
            )
        if not stable:
            detail = (
                f"scale-down {observed}->{target} "
                f"actuated while unstable: {message}"
            )
            if drained:
                detail += f" (consolidation drained {', '.join(drained)})"
            mgr.mark_false(
                cond.STABILIZED, "ScaleDownWhileUnstable", detail
            )

    def _mark_circuit_open(self, resource, breaker: CircuitBreaker) -> None:
        """ActuationCircuitOpen condition: machine-readable reason, with
        the last RetryableError.code and next-probe ETA in the message —
        the operator sees WHY actuation is paused without log-diving."""
        resource.status_conditions().mark_false(
            cond.ABLE_TO_SCALE,
            cond.ACTUATION_CIRCUIT_OPEN,
            f"actuation circuit open for {resource.spec.id}: "
            f"{breaker.consecutive_failures} consecutive provider "
            f"failures (last code "
            f"{breaker.last_error_code or 'unknown'}); next probe in "
            f"{breaker.retry_in():.0f}s",
        )

    def _record_provider_failure(self, resource, breaker, err) -> None:
        opens_before = breaker.opens_total
        code = error_code(err)
        breaker.record_failure(code)
        key = (resource.metadata.namespace, resource.metadata.name)
        self._journal_breaker(key, breaker)
        if self.recovery is not None:
            from karpenter_tpu_torch.recovery.fence import FENCE_REJECTED_CODE

            if code == FENCE_REJECTED_CODE:
                # a provider refused this incarnation's stamp: we are
                # the stale (restarted-over / split-brain) controller
                self.recovery.count_fence_rejection()
        if breaker.opens_total > opens_before:
            logger().warning(
                "actuation circuit OPENED for ScalableNodeGroup %s/%s "
                "after %d consecutive provider failures (last: %s)",
                resource.metadata.namespace, resource.metadata.name,
                breaker.consecutive_failures, err,
            )
            if self._c_opens is not None:
                self._c_opens.inc(
                    resource.metadata.name, resource.metadata.namespace
                )
            # flight-recorder event (trace id captured from the tick
            # span): which group's actuation went dark, and on what code
            default_flight_recorder().record(
                "circuit_open",
                group=f"{resource.metadata.namespace}/"
                      f"{resource.metadata.name}",
                failures=breaker.consecutive_failures,
                code=breaker.last_error_code or error_code(err) or "",
            )

    def reconcile(self, resource) -> None:
        mgr = resource.status_conditions()
        breaker = self._breaker(resource)
        if not breaker.allow():
            # open circuit: skip the provider ENTIRELY this tick — the
            # whole point of the breaker is that a flapping cloud API
            # stops consuming reconcile time. The resource stays Active
            # (this is a supervised degradation, not a resource fault).
            # Retire any pending e2e mark: convergence is UNKNOWABLE
            # without the provider, and a mark accrued on a converged
            # group during a flap would inflate the next real
            # actuation's lead time by the whole outage. Conservative
            # trade: lead during a circuit-open window is under-
            # reported (the flight recorder carries that story).
            default_tracer().drop_observed(self._e2e_key(resource))
            self._mark_circuit_open(resource, breaker)
            self._publish_circuit(resource, breaker)
            return
        try:
            self._reconcile(resource)
        except Exception as e:  # noqa: BLE001
            # EVERY failure feeds the breaker — in particular a
            # non-retryable one during a HALF_OPEN probe must record an
            # outcome, or the breaker wedges half-open (allow() False
            # forever) with no probe ever admitted again
            self._record_provider_failure(resource, breaker, e)
            self._publish_circuit(resource, breaker)
            if is_retryable(e):
                # stay Active; just flag the transient inability to scale
                # (reference: controller.go:83-95) — K consecutive
                # failures open the circuit
                if breaker.state != resilience_CLOSED:
                    self._mark_circuit_open(resource, breaker)
                else:
                    mgr.mark_false(
                        cond.ABLE_TO_SCALE, "", error_code(e) or str(e)
                    )
                return
            raise
        breaker.record_success()
        self._journal_breaker(
            (resource.metadata.namespace, resource.metadata.name), breaker
        )
        self._publish_circuit(resource, breaker)
        mgr.mark_true(cond.ABLE_TO_SCALE)
