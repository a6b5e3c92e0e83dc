"""Replicated control plane: leader-elected solver replicas with fenced
tenant handoff (docs/resilience.md "Replicated control plane").

The MultiTenantScheduler batches 1k tenants through one SolverService —
but one process is one blast radius. This package partitions tenants
across N replicas and makes replica death a non-event:

  * partitions.py — stable tenant -> partition hashing plus rendezvous
    (highest-random-weight) ranking of replicas per partition;
  * lease.py      — PartitionLeaseManager: one CAS lease per partition
    on the existing LeaderElector, plus a per-replica heartbeat lease
    that defines the live-replica set the rendezvous ranks over;
  * handoff.py    — TenantHandoff: the fenced adoption of one tenant
    (claim the journaled fence generation, replay the journal, hold the
    conservative warm-up) and the exactly-once audit trail;
  * plane.py      — ReplicatedControlPlane: the per-replica tick (lease
    round -> ownership diff -> adoptions/releases), the
    karpenter_replica_* / karpenter_handoff_* gauges, the
    /debug/replicas scoreboard, and the self-SLO source;
  * chaos.py      — the failover chaos family: store-partition plans
    over the lease.acquire/lease.renew points, replica.crash kill
    plans, and the SkewedClock used by clock-skew scenarios.

The port's copy of karpenter_tpu/replication: the same modules, seams
and series, over the port's leaderelection.py, recovery/ and faults/.
"""

from karpenter_tpu_torch.replication.chaos import (
    SkewedClock,
    crash_plan,
    partition_plans,
)
from karpenter_tpu_torch.replication.handoff import TenantHandoff
from karpenter_tpu_torch.replication.lease import PartitionLeaseManager
from karpenter_tpu_torch.replication.partitions import (
    partition_of,
    rendezvous_rank,
)
from karpenter_tpu_torch.replication.plane import ReplicatedControlPlane

__all__ = [
    "PartitionLeaseManager",
    "ReplicatedControlPlane",
    "SkewedClock",
    "TenantHandoff",
    "crash_plan",
    "partition_of",
    "partition_plans",
    "rendezvous_rank",
]
