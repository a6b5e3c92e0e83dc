"""Consolidation: batched on-device node-drain planning (the port's copy
of karpenter_tpu/consolidation).

Public surface:

  * ConsolidationEngine — safety gates + cordon→verify→drain state
    machine + actuation through the scale subresource
  * ConsolidationConfig — knobs (cadence, cooldown, verify soak,
    per-group budgets, candidate cap)
  * planner helpers — cluster_view / build_problems / evaluate /
    drainable, the pure fit math under the engine
  * DO_NOT_DISRUPT — the opt-out annotation
"""

from karpenter_tpu_torch.consolidation.engine import (
    SUBSYSTEM,
    ConsolidationConfig,
    ConsolidationEngine,
)
from karpenter_tpu_torch.consolidation.planner import (
    DO_NOT_DISRUPT,
    ClusterView,
    NodeView,
    build_problems,
    cluster_view,
    discover_groups,
    drainable,
    evaluate,
)

__all__ = [
    "SUBSYSTEM",
    "ConsolidationConfig",
    "ConsolidationEngine",
    "DO_NOT_DISRUPT",
    "ClusterView",
    "NodeView",
    "build_problems",
    "cluster_view",
    "discover_groups",
    "drainable",
    "evaluate",
]
