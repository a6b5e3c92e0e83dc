"""Weighted fair admission for the multi-tenant scheduler.

One solver service fronting a thousand tenant clusters has a classic
serving problem: a single noisy tenant — a cluster mid-incident
submitting 100x everyone else's rows — must not starve the shared
dispatch pipeline. The admission policy here is DEFICIT-WEIGHTED ROUND
ROBIN over tenants: each admission round carries a row budget, every
tenant accrues credit proportional to its configured weight, and the
round admits tenants (whole — a tenant's per-tick matrix is indivisible)
in credit order until the budget is spent. Credit is SPENT on admission
and CARRIES OVER when a tenant is deferred, so a deferred tenant's claim
on the next round grows instead of resetting — over consecutive rounds
every tenant's admitted-row share converges to its weight share, the
deficit-round-robin guarantee.

Two deliberate floors keep the policy safe at the edges:

  * every round admits AT LEAST one tenant, even when that tenant's
    matrix alone exceeds the budget — an oversized tenant is admitted
    ALONE (its rows become their own dispatch) rather than deadlocking;
  * a tenant's credit is capped at a few rounds' worth of its share, so
    an idle tenant cannot bank unbounded credit and then monopolize the
    pipeline when it returns.

PoolGroups add one constraint on top: tenants hosting member pools of
the same group (TenantSpec.poolGroup) must land in the SAME round — the
joint allocator (ops/poolgroup.py) scores a group's pools against each
other, so splitting its members across rounds would hand it a partial
view. Grouped tenants are admitted as one INDIVISIBLE COALITION:
combined demand, combined credit, admitted or deferred together. The
oversized-tenant floor applies to the coalition as a whole, and
ungrouped tenants are scheduled exactly as before (a singleton is a
coalition of one — same credit math, same order, same rounds).

The policy is host-side bookkeeping only (a dict of floats); the row
budget bounds each concatenated device program's leading axis, which is
what actually bounds a dispatch's latency and memory.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# credit cap, in multiples of a tenant's per-round fair share: enough to
# absorb a couple of deferred rounds, small enough that a returning idle
# tenant cannot monopolize the pipeline
_CREDIT_CAP_ROUNDS = 4.0


def effective_weight(weights: Dict[str, float], tenant: str) -> float:
    """One tenant's normalized admission weight: missing defaults to
    1.0, zero/negative clamp to 1.0 (a weightless tenant must neither
    divide by zero nor be starved outright). THE single definition —
    round admission and the deadline budgets (scheduler._deadline_
    budgets) must normalize identically, or a zero-weight tenant would
    get one effective weight for rows and another for its wait bound."""
    return max(float(weights.get(tenant, 1.0)), 0.0) or 1.0


class WeightedAdmission:
    """Deficit-weighted round-robin admission (module docstring).

    `budget_rows` bounds the total rows admitted per round; weights come
    from the caller (TenantRegistry.weight in production). Stateful:
    deficits persist across rounds so deferral debts are honored."""

    def __init__(self, budget_rows: int = 4096):
        if budget_rows < 1:
            raise ValueError(f"budget_rows must be >= 1, got {budget_rows}")
        self.budget_rows = budget_rows
        self._credit: Dict[str, float] = {}

    def forget(self, tenant: str) -> None:
        """Drop a deleted tenant's carried credit."""
        self._credit.pop(tenant, None)

    def rounds(
        self,
        demand: Dict[str, int],
        weights: Dict[str, float],
        groups: Optional[Dict[str, str]] = None,
    ) -> List[List[str]]:
        """Partition tenants with pending rows into admission rounds.

        Returns the full schedule for this batch (every tenant appears
        exactly once): round k+1's tenants were deferred behind round
        k's by the weighted deficit. Tenants whose demand fits one
        budget together ride one round — the common small-fleet case
        collapses to a single concatenated dispatch.

        `groups` maps tenant id -> pool-group id: tenants sharing an id
        are admitted as one indivisible coalition (module docstring) so
        the joint allocator always sees a whole group in one round."""
        pending = {t: int(n) for t, n in demand.items() if n > 0}
        units = _coalitions(pending, groups)
        schedule: List[List[str]] = []
        while pending:
            admitted = self._admit_round(pending, weights, units)
            schedule.append(admitted)
            for tenant in admitted:
                del pending[tenant]
            units = [u for u in units if u[0] not in admitted]
        return schedule

    def _admit_round(
        self,
        pending: Dict[str, int],
        weights: Dict[str, float],
        units: List[List[str]],
    ) -> List[str]:
        total_weight = sum(
            effective_weight(weights, t) for t in pending
        )
        for tenant in pending:
            weight = effective_weight(weights, tenant)
            share = self.budget_rows * weight / total_weight
            credit = self._credit.get(tenant, 0.0) + share
            self._credit[tenant] = min(credit, _CREDIT_CAP_ROUNDS * share)
        # highest accrued credit first (a coalition's is its members'
        # combined, matching its combined row demand); the first member
        # id breaks ties so the schedule is deterministic under equal
        # weights — for singletons this is exactly the old ordering
        order = sorted(
            units,
            key=lambda u: (
                -sum(self._credit.get(t, 0.0) for t in u),
                u[0],
            ),
        )
        admitted: List[str] = []
        spent = 0
        for unit in order:
            rows = sum(pending[t] for t in unit)
            if admitted and spent + rows > self.budget_rows:
                continue  # deferred whole: credit carries to next round
            admitted.extend(unit)
            spent += rows
            # admission spends the credit (floored at 0 so an oversized
            # tenant admitted alone doesn't go unboundedly negative and
            # starve ITSELF forever)
            for tenant in unit:
                self._credit[tenant] = max(
                    0.0, self._credit.get(tenant, 0.0) - pending[tenant]
                )
        return admitted


def _coalitions(
    pending: Dict[str, int], groups: Optional[Dict[str, str]]
) -> List[List[str]]:
    """Pending tenants as indivisible admission units: tenants sharing
    a pool-group id ride together, everyone else is a singleton.
    Members are sorted so a coalition's identity (and the tie-break on
    its first member) is deterministic regardless of dict order."""
    if not groups:
        return [[t] for t in sorted(pending)]
    by_group: Dict[str, List[str]] = {}
    units: List[List[str]] = []
    for tenant in sorted(pending):
        gid = groups.get(tenant)
        if gid:
            by_group.setdefault(gid, []).append(tenant)
        else:
            units.append([tenant])
    units.extend(by_group.values())
    units.sort(key=lambda u: u[0])
    return units
