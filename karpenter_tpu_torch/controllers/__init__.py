"""The port's controllers package: the error taxonomy (errors.py, a copy
of karpenter_tpu/controllers/errors.py) that the fault registry raises
through, the HorizontalAutoscaler controller that hands the fleet to
the BatchAutoscaler, and the ScalableNodeGroup controller that actuates
replicas and drives the disruption engines. The controller engine and
the MetricsProducer controller come with a later slice."""

from karpenter_tpu_torch.controllers.errors import (
    RetryableError,
    error_code,
    is_retryable,
)
from karpenter_tpu_torch.controllers.horizontalautoscaler import (
    HorizontalAutoscalerController,
)
from karpenter_tpu_torch.controllers.scalablenodegroup import (
    ScalableNodeGroupController,
)

__all__ = [
    "HorizontalAutoscalerController",
    "RetryableError",
    "ScalableNodeGroupController",
    "error_code",
    "is_retryable",
]
