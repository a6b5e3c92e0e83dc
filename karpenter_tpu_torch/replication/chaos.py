"""The failover chaos family: plan builders over the replication seams.

The fault registry (faults/registry.py) already gives every plan a
seeded RNG stream; these helpers just spell the failover scenarios'
recurring shapes against the replication points:

  lease.acquire.<replica>   a candidate's takeover/first-acquire round
  lease.renew.<replica>     a holder's renew round
  replica.crash.<replica>   the top of the replica tick (plane.on_tick)

`partition_plans` = the replica can reach nothing (both lease verbs
fail — the network-partition analog: its heartbeat lapses, its
partitions expire, survivors adopt). `crash_plan` = the replica dies
between ticks (ProcessCrash out of on_tick; the harness abandons it).
`SkewedClock` = a stepped wall clock for the clock-skew scenarios —
deliberately NOT a registry mode: skew is not an exception, it is a
lying clock, so it wraps the clock seam directly.

The port's copy of karpenter_tpu/replication/chaos.py.
"""

from __future__ import annotations

from typing import Callable, List


def partition_plans(
    registry,
    replica_id: str = "*",
    times=None,
    probability: float = 1.0,
) -> List:
    """Install error plans cutting `replica_id` (or every replica, the
    default glob) off from the lease store: acquire AND renew rounds
    fail while the plans last. Returns the plans (their `fired` counts
    are the scenario's partition-duration evidence)."""
    return [
        registry.plan(
            f"lease.{verb}.{replica_id}",
            mode="error",
            times=times,
            probability=probability,
            code="LeasePartitioned",
            message=f"injected store partition: lease {verb} unreachable",
        )
        for verb in ("acquire", "renew")
    ]


def crash_plan(registry, replica_id: str, times: int = 1):
    """Install the replica-death plan: ProcessCrash out of the NEXT
    `times` replica ticks (plane.on_tick's kill point). The harness
    catches it and abandons the incarnation — the SIGKILL analog."""
    return registry.plan(
        f"replica.crash.{replica_id}", mode="crash", times=times
    )


class SkewedClock:
    """A wall clock stepped by `offset_s`, for the clock-skew plans: a
    replica reading this clock stamps skewed renew_times while its
    monotonic source stays honest — exactly the failure the
    LeaderElector's monotonic expiry + skew margin must absorb.
    `step()` changes the offset mid-scenario (the NTP-jump analog)."""

    def __init__(self, base: Callable[[], float], offset_s: float = 0.0):
        self.base = base
        self.offset_s = offset_s

    def step(self, delta_s: float) -> None:
        self.offset_s += delta_s

    def __call__(self) -> float:
        return self.base() + self.offset_s
