"""Fake producer returning a configured error.

reference: pkg/metrics/producers/fake/types.go:23-27.

The port's copy of karpenter_tpu/metrics/producers/fake.py.
"""

from __future__ import annotations

from typing import Optional

NOT_IMPLEMENTED_ERROR = RuntimeError("provider is not implemented")


class FakeProducer:
    def __init__(self, want_err: Optional[Exception] = None):
        self.want_err = want_err

    def reconcile(self) -> None:
        if self.want_err is not None:
            raise self.want_err
