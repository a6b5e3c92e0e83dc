"""Autoscaling algorithms (reference: pkg/autoscaler/algorithms/algorithm.go:24-40).

The reference hardcodes Proportional and leaves spec-driven selection as a
TODO (algorithm.go:37-39). Here the seam is REAL: algorithms register by
name, a HorizontalAutoscaler selects one with the
`autoscaling.karpenter.sh/algorithm` annotation (annotation, not a spec
field, so the CRD schema stays reference-compatible), and unknown names are
rejected at admission.

TPU-first composition: the batched device kernel (karpenter_tpu_torch.ops.decision)
natively implements Proportional's HPA semantics for the whole fleet in one
call. A row that selects a CUSTOM algorithm still rides the same batch —
the algorithm computes per-metric replica recommendations on host, and the
snapshot encodes them as AverageValue metrics with target 1 (the kernel's
AverageValue rule is ceil(value/target), so the recommendation passes
through exactly) — select policy, stabilization windows, Count/Percent
rate-limit policies, and min/max bounds then apply uniformly ON DEVICE for
default and custom rows alike.

The scalar Proportional here also serves as the golden oracle for kernel
tests.

The port's copy of karpenter_tpu/autoscaler/algorithms/__init__.py,
changed only in its imports.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict

from karpenter_tpu_torch.autoscaler.algorithms.proportional import Proportional

# annotation on the HorizontalAutoscaler selecting the algorithm by name
ALGORITHM_ANNOTATION = "autoscaling.karpenter.sh/algorithm"
DEFAULT_ALGORITHM = "proportional"


@dataclass
class Metric:
    """Observed value + target (reference: algorithm.go:29-34).

    `owner` (the observing autoscaler's (namespace, name)) and `at`
    (observation time) extend the reference shape so STATEFUL
    algorithms (trend windows) can key and order their history; both
    default empty for plain stateless use."""

    value: float = 0.0
    target_type: str = ""
    target_value: float = 0.0
    name: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    owner: tuple = ()
    at: float = 0.0


_registry: Dict[str, Callable[[], object]] = {}


def register_algorithm(name: str, factory: Callable[[], object]) -> None:
    """Register an Algorithm factory; instances must provide
    get_desired_replicas(metric, replicas) -> int (algorithm.go:24-26)."""
    _registry[name] = factory


def known_algorithms() -> list:
    return sorted(_registry)


def algorithm_name(ha) -> str:
    """The algorithm a HorizontalAutoscaler selects (default proportional)."""
    return (
        ha.metadata.annotations.get(ALGORITHM_ANNOTATION, DEFAULT_ALGORITHM)
        if getattr(ha, "metadata", None) is not None
        else DEFAULT_ALGORITHM
    )


def _resolve(name: str) -> Callable[[], object]:
    """ONE unknown-name error for both admission and reconcile paths."""
    factory = _registry.get(name)
    if factory is None:
        raise ValueError(
            f"unknown algorithm {name!r} in annotation "
            f"{ALGORITHM_ANNOTATION}; known: {', '.join(known_algorithms())}"
        )
    return factory


def validate_algorithm(ha) -> None:
    """Admission-time check: an unknown algorithm name must be rejected
    when the object is written, not discovered at reconcile time."""
    _resolve(algorithm_name(ha))


def for_spec(ha_or_none=None):
    """Resolve the Algorithm instance for a HorizontalAutoscaler.

    reference: algorithm.go:36-40 hardcodes Proportional "until we
    implement a means to select via the spec"; this implements it.
    """
    name = (
        algorithm_name(ha_or_none)
        if ha_or_none is not None
        else DEFAULT_ALGORITHM
    )
    return _resolve(name)()


register_algorithm(DEFAULT_ALGORITHM, Proportional)

# trend: the factory returns FRESH instances; the autoscaler engine
# memoizes one per name (autoscaler.py _algorithm_instances), so trend
# windows survive across reconciles without a process-wide global that
# would leak history (and fake clocks) across runtimes
from karpenter_tpu_torch.autoscaler.algorithms.trend import Trend  # noqa: E402

register_algorithm("trend", Trend)

# simlab: the frozen search-tuned SimLab policy (docs/simulator.md)
# behind the never-block contract — any tuned-path failure degrades
# that decision to the plain reactive tick; same fresh-instance /
# engine-memoized lifecycle as trend
from karpenter_tpu_torch.autoscaler.algorithms.simlab_policy import (  # noqa: E402
    SimlabPolicy,
)

register_algorithm("simlab", SimlabPolicy)

# admission wiring: the api layer exposes a hook registry (it cannot import
# this package — that would invert the layering); importing the algorithms
# package is what arms the annotation check, and every control-plane entry
# point does (runtime -> autoscaler -> algorithms)
from karpenter_tpu_torch.api.horizontalautoscaler import (  # noqa: E402
    register_validation_hook,
)

register_validation_hook(validate_algorithm)

__all__ = [
    "ALGORITHM_ANNOTATION",
    "DEFAULT_ALGORITHM",
    "Metric",
    "Proportional",
    "algorithm_name",
    "for_spec",
    "known_algorithms",
    "register_algorithm",
    "validate_algorithm",
]
