"""Priority- and preemption-aware packing (the port's copy of
karpenter_tpu/preemption).

Answers "what do I evict to place this?" fleet-wide in one device
dispatch: the planner encodes candidates/nodes/victims
(preemption/planner.py), the batched eviction kernel solves every
candidate at once (ops/preempt.py via SolverService.preempt), and the
engine applies budgets, conflict resolution, consolidation
coordination, and eviction actuation (preemption/engine.py).
"""

from karpenter_tpu_torch.preemption.engine import (
    PreemptionConfig,
    PreemptionEngine,
)
from karpenter_tpu_torch.preemption.planner import build_problem, plan_rows

__all__ = [
    "PreemptionConfig",
    "PreemptionEngine",
    "build_problem",
    "plan_rows",
]
