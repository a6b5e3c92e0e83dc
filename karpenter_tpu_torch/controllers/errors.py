"""Error taxonomy for controllers (reference: pkg/controllers/errors.go:22-59).

RetryableError marks transient provider failures that should NOT deactivate a
resource; the short `code` surfaces in status conditions where long messages
won't fit.
"""

from __future__ import annotations


class RetryableError(RuntimeError):
    def __init__(self, message: str, code: str = "", retryable: bool = True):
        super().__init__(message)
        self.code = code
        self.retryable = retryable


def is_retryable(err: BaseException) -> bool:
    """reference: errors.go:41-47"""
    e = err
    while e is not None:
        if isinstance(e, RetryableError):
            return e.retryable
        e = e.__cause__
    return False


def error_code(err: BaseException) -> str:
    """reference: errors.go:53-59"""
    e = err
    while e is not None:
        if isinstance(e, RetryableError):
            return e.code
        e = e.__cause__
    return ""
