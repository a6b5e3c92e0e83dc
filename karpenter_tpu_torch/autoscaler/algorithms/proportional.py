"""Scalar proportional algorithm — HPA-style ratio scaling.

reference: pkg/autoscaler/algorithms/proportional.go:30-47. This is the
float64 host implementation; it is the oracle the batched device kernel
(karpenter_tpu/ops/decision.py) is golden-tested against.

The port's copy of karpenter_tpu/autoscaler/algorithms/proportional.py,
changed only in its imports.
"""

from __future__ import annotations

import math

from karpenter_tpu_torch.api.horizontalautoscaler import AVERAGE_VALUE, UTILIZATION, VALUE
from karpenter_tpu_torch.utils.log import logger


class Proportional:
    def get_desired_replicas(self, metric, replicas: int) -> int:
        ratio = metric.value / metric.target_value if metric.target_value else 0.0
        proportional = float(replicas) * ratio
        if metric.target_type == VALUE:
            # proportional, cannot scale to zero
            return int(max(1, math.ceil(proportional)))
        if metric.target_type == AVERAGE_VALUE:
            # proportional average, divided by number of replicas; can reach 0
            return int(math.ceil(ratio))
        if metric.target_type == UTILIZATION:
            # proportional percentage, multiplied by 100, cannot scale to zero
            return int(max(1, math.ceil(proportional * 100)))
        logger().error("Unexpected TargetType %s", metric.target_type)
        return replicas
