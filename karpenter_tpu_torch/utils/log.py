"""Logging setup + invariant helpers (reference: pkg/utils/log/log.go:26-40).

The port's copy of karpenter_tpu/utils/log.py; its logger is named after
the port's package."""

from __future__ import annotations

import json
import logging
import sys

_LOGGER = logging.getLogger("karpenter_tpu_torch")


def setup(verbose: bool = False) -> logging.Logger:
    level = logging.DEBUG if verbose else logging.INFO
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
    )
    _LOGGER.handlers[:] = [handler]
    _LOGGER.setLevel(level)
    return _LOGGER


def logger() -> logging.Logger:
    return _LOGGER


class InvariantViolation(AssertionError):
    """Raised for states that validation should have made impossible."""


def invariant_violated(message: str) -> None:
    _LOGGER.error("Invariant violated: %s", message)
    raise InvariantViolation(message)


def pretty(obj) -> str:
    try:
        return json.dumps(obj, indent=2, default=str)
    except TypeError:
        return repr(obj)
