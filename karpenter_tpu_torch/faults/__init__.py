"""Fault injection (registry.py) — the testable-failure subsystem.

Public surface: `inject(point)` for instrumented production code paths,
`FaultRegistry`/`FaultPlan` + install/uninstall/injected_faults for
chaos suites. See docs/resilience.md for the point catalog and plan
format.

The port's copy of karpenter_tpu/faults/__init__.py.
"""

from karpenter_tpu_torch.faults.registry import (
    FaultInjected,
    FaultPlan,
    FaultRegistry,
    ProcessCrash,
    active,
    inject,
    injected_faults,
    install,
    uninstall,
)

__all__ = [
    "FaultInjected",
    "FaultPlan",
    "FaultRegistry",
    "ProcessCrash",
    "active",
    "inject",
    "injected_faults",
    "install",
    "uninstall",
]
