"""The port's controllers package: the error taxonomy (errors.py, a copy
of karpenter_tpu/controllers/errors.py) that the fault registry raises
through, and the HorizontalAutoscaler controller that hands the fleet to
the BatchAutoscaler. The controller engine and the other controllers
come with a later slice."""

from karpenter_tpu_torch.controllers.errors import (
    RetryableError,
    error_code,
    is_retryable,
)
from karpenter_tpu_torch.controllers.horizontalautoscaler import (
    HorizontalAutoscalerController,
)

__all__ = [
    "HorizontalAutoscalerController",
    "RetryableError",
    "error_code",
    "is_retryable",
]
