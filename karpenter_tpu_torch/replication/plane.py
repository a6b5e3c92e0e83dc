"""ReplicatedControlPlane: one replica's view of the partitioned fleet.

Runs once per manager tick (`on_tick`, wired into the runtime's
composed tick hook): a lease round (lease.py), then the ownership diff
becomes fenced tenant handoffs (handoff.py) — adopt every tenant whose
partition we now hold, release every tenant whose partition moved away
— then the per-tenant warm-ups advance and the gauges publish.

Observability surface (docs/OPERATIONS.md):

  karpenter_replica_partitions_owned   partitions this replica holds
  karpenter_replica_replicas_live      live heartbeats it can see
  karpenter_replica_lease_rounds_total election rounds completed
  karpenter_replica_lease_failures_total held-lease renew failures
  karpenter_handoff_tenants_adopted_total fenced adoptions completed
  karpenter_handoff_tenants_released_total releases (moves + shutdown)
  karpenter_handoff_tenants_serving    tenants fully serving here
  karpenter_handoff_tenants_warming    tenants still in warm-up
  karpenter_handoff_replay_seconds     last adoption's journal replay

plus the /debug/replicas scoreboard (`scoreboard()`) and the self-SLO
source (`slo_source`): a tick with held-lease renew failures or tenants
still warming is a BAD control-health event — a handoff in flight burns
error budget exactly like a degraded solver FSM.

The port's copy of karpenter_tpu/replication/plane.py.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Dict, List, Optional

from karpenter_tpu_torch.controllers.errors import RetryableError
from karpenter_tpu_torch.faults import inject
from karpenter_tpu_torch.leaderelection import (
    DEFAULT_LEASE_DURATION,
    DEFAULT_LEASE_NAMESPACE,
    DEFAULT_SKEW_TOLERANCE,
)
from karpenter_tpu_torch.replication.handoff import TenantHandoff
from karpenter_tpu_torch.replication.lease import LeaseRound, PartitionLeaseManager
from karpenter_tpu_torch.replication.partitions import partition_of
from karpenter_tpu_torch.utils.log import logger

SUBSYSTEM_REPLICA = "replica"
SUBSYSTEM_HANDOFF = "handoff"

# flight-recorder kind for one completed fenced adoption
HANDOFF_EVENT = "tenant_handoff"


class ReplicatedControlPlane:
    """Seams (all callables, so tests and the simulator compose pieces
    freely, the SelfSLOMonitor posture):

      tenants_source   () -> [tenant ids] — the tenant universe this
                       replica partitions (the TenantRegistry's list)
      journal_dir_for  (tenant) -> Optional[dir] — the per-tenant
                       journal/fence dir (TenantRegistry.journal_dir_for)
      validator        the provider-side FenceValidator adoptions seed
                       (cloudprovider factory `.fence_validator`)
      validator_for    (tenant) -> validator — the per-tenant form for
                       worlds where every tenant has its own provider
                       (the failover simulator); wins over `validator`
    """

    def __init__(
        self,
        store,
        replica_id: Optional[str],
        partitions: int,
        lease_duration: float = DEFAULT_LEASE_DURATION,
        tenants_source: Optional[Callable[[], List[str]]] = None,
        journal_dir_for: Optional[Callable[[str], Optional[str]]] = None,
        validator=None,
        validator_for: Optional[Callable[[str], object]] = None,
        warmup_ticks: int = 1,
        registry=None,
        clock: Callable[[], float] = _time.time,
        monotonic=None,
        skew_tolerance: float = DEFAULT_SKEW_TOLERANCE,
        namespace: str = DEFAULT_LEASE_NAMESPACE,
        recorder=None,
    ):
        if not replica_id:
            import uuid

            replica_id = f"karpenter-{uuid.uuid4().hex[:8]}"
        self.replica_id = replica_id
        self.partitions = partitions
        self.clock = clock
        self.warmup_ticks = warmup_ticks
        self.validator = validator
        self.validator_for = validator_for
        self.tenants_source = tenants_source or (lambda: [])
        self.journal_dir_for = journal_dir_for or (lambda tenant: None)
        self._recorder = recorder
        self.leases = PartitionLeaseManager(
            store,
            replica_id=replica_id,
            partitions=partitions,
            lease_duration=lease_duration,
            clock=clock,
            monotonic=monotonic,
            skew_tolerance=skew_tolerance,
            namespace=namespace,
        )
        self.handoffs: Dict[str, TenantHandoff] = {}
        self.rounds = 0
        self.adopted_total = 0
        self.released_total = 0
        self.last_round: Optional[LeaseRound] = None
        self._g_owned = self._g_live = None
        self._c_rounds = self._c_failures = None
        self._c_adopted = self._c_released = None
        self._g_serving = self._g_warming = self._g_replay = None
        if registry is not None:
            reg = registry.register
            self._g_owned = reg(SUBSYSTEM_REPLICA, "partitions_owned")
            self._g_live = reg(SUBSYSTEM_REPLICA, "replicas_live")
            self._c_rounds = reg(
                SUBSYSTEM_REPLICA, "lease_rounds_total", kind="counter"
            )
            self._c_failures = reg(
                SUBSYSTEM_REPLICA, "lease_failures_total", kind="counter"
            )
            self._c_adopted = reg(
                SUBSYSTEM_HANDOFF, "tenants_adopted_total", kind="counter"
            )
            self._c_released = reg(
                SUBSYSTEM_HANDOFF, "tenants_released_total", kind="counter"
            )
            self._g_serving = reg(SUBSYSTEM_HANDOFF, "tenants_serving")
            self._g_warming = reg(SUBSYSTEM_HANDOFF, "tenants_warming")
            self._g_replay = reg(SUBSYSTEM_HANDOFF, "replay_seconds")

    # -- ownership ---------------------------------------------------------

    def partition_for(self, tenant: str) -> int:
        return partition_of(tenant, self.partitions)

    def owns(self, tenant: str) -> bool:
        """Whether this replica holds the tenant's partition lease."""
        return self.leases.owns(self.partition_for(tenant))

    def serving(self, tenant: str) -> bool:
        """Owned AND past the handoff warm-up: safe to decide + actuate
        disruptively for this tenant."""
        handoff = self.handoffs.get(tenant)
        return handoff is not None and handoff.ready()

    def handoff_for(self, tenant: str) -> Optional[TenantHandoff]:
        return self.handoffs.get(tenant)

    def token_for(self, tenant: str):
        """The fence stamp this replica's actuations for `tenant` carry
        (None when not owned or unfenced)."""
        handoff = self.handoffs.get(tenant)
        return handoff.token() if handoff is not None else None

    def allow_disruption(self, tenant: str) -> bool:
        handoff = self.handoffs.get(tenant)
        return handoff is not None and handoff.allow_disruption()

    # -- the per-tick protocol ---------------------------------------------

    def on_tick(self) -> LeaseRound:
        """One replica tick: crash seam, lease round, ownership diff ->
        adoptions/releases, warm-up advance, gauges."""
        try:
            # the kill point of the failover chaos family: a crash plan
            # here is this replica dying between lease rounds
            inject(f"replica.crash.{self.replica_id}")
        except RetryableError:
            pass  # error plans at a kill point degrade to a no-op tick
        self.rounds += 1
        round_ = self.leases.round()
        self.last_round = round_
        desired = {
            tenant
            for tenant in self.tenants_source()
            if self.partition_for(tenant) in round_.owned
        }
        adopted_now = desired - set(self.handoffs)
        for tenant in sorted(adopted_now):
            self._adopt(tenant)
        for tenant in sorted(set(self.handoffs) - desired):
            self._release(tenant)
        for tenant, handoff in self.handoffs.items():
            # an adoption mid-round has observed ZERO full ticks of its
            # fleet: the warm-up starts counting NEXT round
            if tenant not in adopted_now:
                handoff.on_tick()
        self._publish(round_)
        return round_

    def _adopt(self, tenant: str) -> None:
        validator = (
            self.validator_for(tenant)
            if self.validator_for is not None else self.validator
        )
        handoff = TenantHandoff(
            tenant,
            journal_dir=self.journal_dir_for(tenant),
            validator=validator,
            warmup_ticks=self.warmup_ticks,
            clock=self.clock,
        )
        self.handoffs[tenant] = handoff
        self.adopted_total += 1
        if self._c_adopted is not None:
            self._c_adopted.inc("-", "-")
        if self._g_replay is not None:
            self._g_replay.set("-", "-", handoff.replay_seconds)
        self._recorder_or_default().record(
            HANDOFF_EVENT,
            tenant=tenant,
            replica=self.replica_id,
            partition=self.partition_for(tenant),
            generation=handoff.generation,
        )
        logger().info(
            "replication: %s adopted tenant %s (partition %d, fence "
            "generation %d, replay %.3fs)",
            self.replica_id, tenant, self.partition_for(tenant),
            handoff.generation, handoff.replay_seconds,
        )

    def _release(self, tenant: str) -> None:
        handoff = self.handoffs.pop(tenant, None)
        if handoff is None:
            return
        handoff.release()
        self.released_total += 1
        if self._c_released is not None:
            self._c_released.inc("-", "-")

    def _publish(self, round_: LeaseRound) -> None:
        if self._g_owned is None:
            return
        serving = sum(1 for h in self.handoffs.values() if h.ready())
        self._g_owned.set("-", "-", float(len(round_.owned)))
        self._g_live.set("-", "-", float(len(round_.live)))
        self._c_rounds.inc("-", "-")
        for _ in range(round_.failures):
            self._c_failures.inc("-", "-")
        self._g_serving.set("-", "-", float(serving))
        self._g_warming.set(
            "-", "-", float(len(self.handoffs) - serving)
        )

    # -- surfaces ----------------------------------------------------------

    def slo_source(self) -> Optional[bool]:
        """Self-SLO control-health source: True = BAD (a held lease
        failed to renew this round, or a handoff is still warming —
        the plane is mid-failover), False = healthy, None = no round
        yet (contributes no event)."""
        if self.last_round is None:
            return None
        warming = any(not h.ready() for h in self.handoffs.values())
        return bool(self.last_round.failures) or warming

    def scoreboard(self) -> dict:
        """The /debug/replicas document: this replica's identity, the
        live set, per-partition holders, and per-tenant handoff state."""
        round_ = self.last_round
        return {
            "replica": self.replica_id,
            "partitions": self.partitions,
            "rounds": self.rounds,
            "live": list(round_.live) if round_ else [],
            "owned": sorted(round_.owned) if round_ else [],
            "lease_failures": round_.failures if round_ else 0,
            "holders": {
                str(p): self.leases.holder_of(p)
                for p in range(self.partitions)
            },
            "tenants": {
                tenant: {
                    "partition": self.partition_for(tenant),
                    "state": handoff.state,
                    "generation": handoff.generation,
                    "warmup_remaining": handoff.warmup_remaining,
                    "replay_seconds": round(handoff.replay_seconds, 6),
                }
                for tenant, handoff in sorted(self.handoffs.items())
            },
            "adopted_total": self.adopted_total,
            "released_total": self.released_total,
        }

    def close(self) -> None:
        """Graceful shutdown: release every tenant (checkpointing their
        journals) and surrender the leases so successors take over
        without waiting out the lease duration."""
        for tenant in sorted(self.handoffs):
            self._release(tenant)
        self.leases.release_all()

    def _recorder_or_default(self):
        if self._recorder is not None:
            return self._recorder
        from karpenter_tpu_torch.observability import default_flight_recorder

        return default_flight_recorder()
