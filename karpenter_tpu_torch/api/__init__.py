"""API group autoscaling.karpenter.sh/v1alpha1: the core objects (Pod,
Node, ObjectMeta, selectors, affinity and spread shapes), conditions and
the MetricsProducer, HorizontalAutoscaler, ScalableNodeGroup and
PoolGroup kinds, and the manifest codec (serialization.py), copied from
karpenter_tpu/api."""

from karpenter_tpu_torch.api import conditions
from karpenter_tpu_torch.api.core import (
    Node,
    ObjectMeta,
    Pod,
    is_ready_and_schedulable,
    matches_selector,
    resource_list,
)
from karpenter_tpu_torch.api.horizontalautoscaler import HorizontalAutoscaler
from karpenter_tpu_torch.api.metricsproducer import MetricsProducer
from karpenter_tpu_torch.api.poolgroup import PoolGroup
from karpenter_tpu_torch.api.scalablenodegroup import ScalableNodeGroup

GROUP = "autoscaling.karpenter.sh"
VERSION = "v1alpha1"

# Kinds registered in the scheme
KINDS = {
    HorizontalAutoscaler.KIND: HorizontalAutoscaler,
    MetricsProducer.KIND: MetricsProducer,
    ScalableNodeGroup.KIND: ScalableNodeGroup,
}

__all__ = [
    "GROUP",
    "VERSION",
    "KINDS",
    "conditions",
    "HorizontalAutoscaler",
    "MetricsProducer",
    "PoolGroup",
    "ScalableNodeGroup",
    "Node",
    "Pod",
    "ObjectMeta",
    "resource_list",
    "is_ready_and_schedulable",
    "matches_selector",
]
