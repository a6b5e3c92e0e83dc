"""PartitionLeaseManager: one CAS lease per tenant partition.

Built entirely on LeaderElector (leaderelection.py) — same Lease kind,
same store transport, same CAS-on-resourceVersion invariant — so the
partition plane inherits the monotonic/skew clock discipline and the
`lease.acquire.*` / `lease.renew.*` chaos seams for free. Two lease
families per replica:

  * `karpenter-replica-<id>`   — the replica's HEARTBEAT. Only its own
    replica renews it; every replica reads all of them to agree on the
    live-replica set the rendezvous ranking runs over. A replica whose
    heartbeat lapses is dead to the fleet, whatever its process thinks.
  * `karpenter-partition-<p>`  — ownership of partition p. STICKY: the
    holder renews every round and is never evicted by a ranking change
    (a new replica joining does not churn assignments); a NON-holder
    contends only when (a) it is the top-ranked LIVE replica for p and
    (b) the current lease is vacant or expired. One deterministic
    contender per vacant partition keeps CAS conflicts to the genuine
    races.

`round()` is the whole protocol: heartbeat, read liveness, contend,
renew — returning the ownership delta the ReplicatedControlPlane turns
into fenced tenant handoffs.

The port's copy of karpenter_tpu/replication/lease.py.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from karpenter_tpu_torch.leaderelection import (
    DEFAULT_LEASE_DURATION,
    DEFAULT_LEASE_NAMESPACE,
    DEFAULT_SKEW_TOLERANCE,
    LeaderElector,
)
from karpenter_tpu_torch.replication.partitions import rendezvous_rank

HEARTBEAT_PREFIX = "karpenter-replica-"
PARTITION_PREFIX = "karpenter-partition-"


@dataclass
class LeaseRound:
    """The outcome of one `round()`: the ownership delta drives
    handoffs, the counters drive the karpenter_replica_* gauges."""

    owned: Set[int] = field(default_factory=set)
    gained: Set[int] = field(default_factory=set)
    lost: Set[int] = field(default_factory=set)
    live: List[str] = field(default_factory=list)
    failures: int = 0  # rounds a lease write/contend failed (partition)


class PartitionLeaseManager:
    def __init__(
        self,
        store,
        replica_id: str,
        partitions: int,
        lease_duration: float = DEFAULT_LEASE_DURATION,
        clock=_time.time,
        monotonic=None,
        skew_tolerance: float = DEFAULT_SKEW_TOLERANCE,
        namespace: str = DEFAULT_LEASE_NAMESPACE,
    ):
        if partitions <= 0:
            raise ValueError(f"partitions must be positive: {partitions}")
        self.store = store
        self.replica_id = replica_id
        self.partitions = partitions
        self.lease_duration = lease_duration
        self.clock = clock
        self.skew_tolerance = skew_tolerance
        self.namespace = namespace

        def elector(name: str) -> LeaderElector:
            return LeaderElector(
                store,
                identity=replica_id,
                name=name,
                namespace=namespace,
                lease_duration=lease_duration,
                clock=clock,
                monotonic=monotonic,
                skew_tolerance=skew_tolerance,
            )

        self.heartbeat = elector(f"{HEARTBEAT_PREFIX}{replica_id}")
        self.electors: Dict[int, LeaderElector] = {
            p: elector(f"{PARTITION_PREFIX}{p}") for p in range(partitions)
        }
        self.owned: Set[int] = set()
        self._rounds = 0

    # -- liveness ----------------------------------------------------------

    def live_replicas(self) -> List[str]:
        """Replica ids with an unexpired heartbeat lease (wall clock +
        skew margin), always including ourselves — a replica that can
        run this code is alive even if its first heartbeat write has
        not landed yet."""
        now = self.clock()
        live = {self.replica_id}
        for lease in self.store.list("Lease", namespace=self.namespace):
            if not lease.metadata.name.startswith(HEARTBEAT_PREFIX):
                continue
            fresh = now <= (
                lease.renew_time
                + lease.lease_duration
                + self.skew_tolerance
            )
            if lease.holder and fresh:
                live.add(lease.holder)
        return sorted(live)

    # -- the per-tick protocol ---------------------------------------------

    def round(self) -> LeaseRound:
        """One lease round: heartbeat, read the live set, renew what we
        hold (sticky), contend for vacant/expired partitions we are the
        top-ranked live replica for. Returns the ownership delta."""
        self.heartbeat.try_acquire()
        live = self.live_replicas()
        self._rounds += 1
        owned: Set[int] = set()
        failures = 0
        for partition, elector in self.electors.items():
            holding = partition in self.owned
            # the first round only heartbeats + renews: co-booting
            # replicas see each other's heartbeats before anyone
            # contends, so a simultaneous start spreads partitions by
            # rendezvous instead of first-ticker-takes-all
            contend = holding or (
                self._rounds > 1
                and rendezvous_rank(partition, live)[0] == self.replica_id
            )
            if not contend:
                continue
            if elector.try_acquire():
                owned.add(partition)
            elif holding:
                failures += 1
        result = LeaseRound(
            owned=owned,
            gained=owned - self.owned,
            lost=self.owned - owned,
            live=live,
            failures=failures,
        )
        self.owned = owned
        return result

    def release_all(self) -> None:
        """Graceful shutdown: surrender heartbeat + every held
        partition so successors take over without waiting out the
        leases."""
        for partition in sorted(self.owned):
            self.electors[partition].release()
        self.owned = set()
        self.heartbeat.release()

    def owns(self, partition: int) -> bool:
        return partition in self.owned

    def holder_of(self, partition: int) -> Optional[str]:
        """Who the store says owns `partition` right now (diagnostics +
        the /debug/replicas scoreboard)."""
        lease = self.store.try_get(
            "Lease", self.namespace, f"{PARTITION_PREFIX}{partition}"
        )
        return lease.holder or None if lease is not None else None
