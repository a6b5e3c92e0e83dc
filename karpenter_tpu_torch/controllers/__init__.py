"""The port's controllers package (a copy of karpenter_tpu/controllers):
the reconcile engine and its Manager, the error taxonomy, and the
MetricsProducer, ScalableNodeGroup and HorizontalAutoscaler
controllers."""

from karpenter_tpu_torch.controllers.engine import Controller, Manager
from karpenter_tpu_torch.controllers.errors import (
    RetryableError,
    error_code,
    is_retryable,
)
from karpenter_tpu_torch.controllers.horizontalautoscaler import (
    HorizontalAutoscalerController,
)
from karpenter_tpu_torch.controllers.metricsproducer import (
    MetricsProducerController,
)
from karpenter_tpu_torch.controllers.scalablenodegroup import (
    ScalableNodeGroupController,
)

__all__ = [
    "Controller",
    "Manager",
    "RetryableError",
    "error_code",
    "is_retryable",
    "HorizontalAutoscalerController",
    "MetricsProducerController",
    "ScalableNodeGroupController",
]
