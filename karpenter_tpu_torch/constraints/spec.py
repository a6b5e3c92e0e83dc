"""Declarative constraint-group specs (spec.constraints on the
pendingCapacity producer).

A ConstraintGroup names a set of pending pods (podSelector over pod
labels, first matching group wins) and declares how the batched solver
must place them:

- ``anti_affinity`` — no two members share a node (each member row takes
  a whole node: the pod_exclusive operand, the same conservative shape
  the hostname self-anti-affinity path uses)
- ``compact`` — members pack onto nodes of their own (compact-placement
  isolation class: the pod_pack_class operand; members never share a
  node with non-members, TPU-slice locality)
- ``spread`` — members balance across zones (the pod_spread_slot /
  group_domain / spread_cap operand trio; the compiler emits balanced
  per-domain quotas, skew <= 1 <= any legal maxSkew)
- ``reservation`` — members claim reserved capacity: they only place on
  groups labeled karpenter.sh/reservation=<name>, and unclaimed pods are
  fenced OFF every reserved group (the pod_claim / group_reservation
  operands)

Validation is strict at the API boundary (``validate()``), while the
compiler itself never raises on fleet state — a constraint that cannot
be satisfied yields infeasible rows (unschedulable counts), not errors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.api.core import ZONE_LABEL


@dataclass(slots=True)
class SpreadSpec:
    """Topology-spread over the domains of ANY node label axis —
    topologyKey defaults to the zone label but accepts hostname, rack,
    or any custom key the fleet's groups carry. maxSkew >= 1 is
    accepted and always satisfied because the compiler emits BALANCED
    per-domain quotas (skew <= 1).

    One constraint set shares ONE topology key across all its spread
    groups (the solver ships a single group->domain operand;
    validate_constraints enforces the invariant at admission)."""

    topology_key: str = ZONE_LABEL
    max_skew: int = 1

    def validate(self) -> None:
        if not self.topology_key:
            raise ValueError("spread.topologyKey must be a non-empty label key")
        if self.max_skew < 1:
            raise ValueError("spread.maxSkew must be >= 1")


@dataclass(slots=True)
class ConstraintGroup:
    name: str = ""
    pod_selector: Dict[str, str] = field(default_factory=dict)
    anti_affinity: bool = False
    compact: bool = False
    spread: Optional[SpreadSpec] = None
    reservation: str = ""

    def validate(self) -> None:
        if not self.name:
            raise ValueError("constraint group requires a name")
        if not self.pod_selector:
            raise ValueError(
                f"constraint group {self.name!r} requires a podSelector"
            )
        if not (
            self.anti_affinity
            or self.compact
            or self.spread is not None
            or self.reservation
        ):
            raise ValueError(
                f"constraint group {self.name!r} declares no constraint "
                "(one of antiAffinity/compact/spread/reservation)"
            )
        if self.spread is not None:
            self.spread.validate()
        if self.anti_affinity and self.compact:
            # exclusive rows take whole nodes; compact isolation of
            # whole-node rows is vacuous and the combination reads as a
            # spec mistake
            raise ValueError(
                f"constraint group {self.name!r}: antiAffinity and "
                "compact are mutually exclusive"
            )


def validate_constraints(groups: List[ConstraintGroup]) -> None:
    seen = set()
    for group in groups:
        group.validate()
        if group.name in seen:
            raise ValueError(
                f"duplicate constraint group name {group.name!r}"
            )
        seen.add(group.name)
    keys = {g.spread.topology_key for g in groups if g.spread is not None}
    if len(keys) > 1:
        raise ValueError(
            "all spread groups in one constraint set must share a single "
            f"topologyKey, got {sorted(keys)}"
        )


def spread_topology_key(groups) -> str:
    """The single domain axis this constraint set spreads on (the
    validated invariant above); the zone label when nothing spreads."""
    for group in groups:
        if group.spread is not None:
            return group.spread.topology_key
    return ZONE_LABEL


def canonical_constraints(groups) -> tuple:
    """Hashable canonical form — the encode-memo / fingerprint identity
    of a constraint-group set (order-preserving: first-match-wins makes
    group order semantic)."""
    if not groups:
        return ()
    return tuple(
        (
            g.name,
            tuple(sorted(g.pod_selector.items())),
            bool(g.anti_affinity),
            bool(g.compact),
            (
                (g.spread.topology_key, int(g.spread.max_skew))
                if g.spread is not None
                else None
            ),
            g.reservation,
        )
        for g in groups
    )
