"""Constraint plane: declarative constraint groups compiled into the
batched bin-pack's exact-integer operands.

Spec surface (spec.constraints on the pendingCapacity producer):
constraints/spec.py. Compiler (membership, reservation claims, compact
isolation classes, balanced zone-spread quotas, anti-affinity
exclusivity) and host-side verdict helpers: constraints/compiler.py.
See docs/constraints.md for worked examples.
"""

from karpenter_tpu_torch.constraints.compiler import (
    CompiledConstraints,
    ConstraintMeta,
    compile_membership,
    compile_rows,
    constraint_meta,
    reservation_fill,
    spread_skew,
)
from karpenter_tpu_torch.constraints.spec import (
    ConstraintGroup,
    SpreadSpec,
    canonical_constraints,
    validate_constraints,
)

__all__ = [
    "CompiledConstraints",
    "ConstraintGroup",
    "ConstraintMeta",
    "SpreadSpec",
    "canonical_constraints",
    "compile_membership",
    "compile_rows",
    "constraint_meta",
    "reservation_fill",
    "spread_skew",
    "validate_constraints",
]
