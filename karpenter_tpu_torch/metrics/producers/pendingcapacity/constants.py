"""Shared constants: gauge names and the pad buckets that keep
compiled shapes stable (universes GROW in these steps rather than
truncating — silent constraint drops would be false feasibility)."""

from __future__ import annotations

from karpenter_tpu_torch.store.columnar import BASE_RESOURCES

SUBSYSTEM = "pending_capacity"
PENDING_PODS = "pending_pods"
ADDITIONAL_NODES_NEEDED = "additional_nodes_needed"
LP_LOWER_BOUND = "lp_lower_bound"
UNSCHEDULABLE_PODS = "unschedulable_pods"

# base resources always present; the per-solve universe adds any extended
# resources (GPUs/TPUs/ephemeral-storage/...) seen in requests or allocatable,
# with the 'pods' slot axis always LAST (each pod occupies exactly 1).
# Single definition lives with the encoder (store/columnar.py).
RESOURCES_BASE = BASE_RESOURCES

# pad buckets for stable compiled shapes; universes GROW in these steps
# rather than truncating (silent constraint drops = false feasibility)
TAINT_PAD = 32
LABEL_PAD = 64
POD_PAD = 256  # pods padded to a multiple of this
GROUP_PAD = 8
RESOURCE_PAD = 4

# kubernetes' default max-pods when a node doesn't report a 'pods' allocatable
DEFAULT_PODS_PER_NODE = 110.0
