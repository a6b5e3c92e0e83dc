"""Tenant -> partition -> replica assignment.

Two pure functions, both keyed on a seeded stable digest (blake2b —
`hash()` is salted per process, useless for cross-replica agreement):

  * partition_of(tenant, partitions) — which partition a tenant lives
    in. Stable across restarts and replica-set changes: a tenant only
    moves when the partition COUNT changes (an operator action).
  * rendezvous_rank(partition, replicas) — highest-random-weight
    ranking of candidate replicas for one partition. Every replica
    computes the same ranking from the same inputs with no
    coordination, and removing one replica only reassigns the
    partitions it owned (the classic rendezvous property) — the
    surviving assignments do not churn.

Stickiness lives a layer up (lease.py): ranking decides who CONTENDS
for a vacant or expired partition lease; it never evicts a live holder.

The port's copy of karpenter_tpu/replication/partitions.py.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence


def _digest(key: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


def partition_of(tenant: str, partitions: int) -> int:
    """The partition `tenant` hashes into (0 <= p < partitions)."""
    if partitions <= 0:
        raise ValueError(f"partitions must be positive: {partitions}")
    return _digest(f"tenant:{tenant}") % partitions


def rendezvous_rank(partition: int, replicas: Sequence[str]) -> List[str]:
    """Replicas ranked highest-random-weight for one partition: index 0
    is the preferred owner; each later entry is the failover successor
    if everything before it is dead. Deterministic and agreed-upon by
    every replica that sees the same candidate set."""
    return sorted(
        replicas,
        key=lambda replica: (_digest(f"p{partition}@{replica}"), replica),
        reverse=True,
    )
