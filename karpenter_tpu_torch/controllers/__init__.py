"""The port's controllers package: so far only the error taxonomy
(errors.py, a copy of karpenter_tpu/controllers/errors.py) that the fault
registry raises through. The controllers themselves come with a later
slice."""

from karpenter_tpu_torch.controllers.errors import (
    RetryableError,
    error_code,
    is_retryable,
)

__all__ = ["RetryableError", "error_code", "is_retryable"]
