"""Device-timeline annotation (counterpart of the `solver_trace` half of
karpenter_tpu/observability/profiler.py).

The reference wraps solver dispatches in jax.profiler.TraceAnnotation so
they show as named ranges on an xprof timeline. Here the range is
torch.profiler.record_function: inside a torch.profiler window it shows
as a named range over the kernels it launched, and outside one it costs
a few microseconds of host time.
"""

from __future__ import annotations

import torch


def solver_trace(name: str):
    """A context manager naming a solver section on the profiler's
    timeline."""
    return torch.profiler.record_function(name)
