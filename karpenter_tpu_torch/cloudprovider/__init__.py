"""Cloud provider SPI (reference: pkg/cloudprovider/types.go:23-55; the
port's copy of karpenter_tpu/cloudprovider/__init__.py).

Providers plug in NodeGroup (get/set replicas, stabilization) and Queue
(length, oldest message age) implementations. Provider selection is runtime
(registry.py) rather than compile-time build tags.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Tuple


class Queue(Protocol):
    def name(self) -> str: ...

    def length(self) -> int: ...

    def oldest_message_age_seconds(self) -> int: ...


@dataclass
class NodeTemplate:
    """Shape of the node a group would add — what the provider knows about
    the instance type even when the group is scaled to ZERO. The pending-
    pods producer falls back to this for empty groups (spec.pendingCapacity
    .nodeGroupRef), fixing scale-from-zero: with no live node to profile,
    the bin-pack would otherwise see an empty shape and never signal.
    allocatable values are Quantities (e.g. {"cpu": 8, "google.com/tpu": 8});
    labels/taints as on the nodes the group stamps."""

    allocatable: Dict[str, object] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[object] = field(default_factory=list)  # api.core.Taint


_EFFECT_DIALECT = {
    # cloud APIs (GKE nodePools.get, EKS describeNodegroup) spell taint
    # effects as enums where core/v1 uses camelCase
    "NO_SCHEDULE": "NoSchedule",
    "NO_EXECUTE": "NoExecute",
    "PREFER_NO_SCHEDULE": "PreferNoSchedule",
}


def node_template_from_raw(
    raw: Optional[dict], extra_labels: Optional[Dict[str, str]] = None
) -> Optional["NodeTemplate"]:
    """Cloud-API-shaped dict -> NodeTemplate: allocatable strings parse to
    Quantities, taint dicts become api.core.Taint with core/v1 effect
    spelling (enum dialects accepted). The one conversion every provider's
    template() shares. extra_labels fill in defaults (e.g. the pool/group
    label its nodes would carry) without overriding the API's."""
    if raw is None:
        return None
    from karpenter_tpu_torch.api.core import Taint
    from karpenter_tpu_torch.utils.quantity import parse_quantity

    labels = dict(raw.get("labels", {}))
    for key, value in (extra_labels or {}).items():
        labels.setdefault(key, value)
    taints = [
        Taint(
            key=t.get("key", ""),
            value=t.get("value", ""),
            effect=_EFFECT_DIALECT.get(
                t.get("effect", ""), t.get("effect", "")
            ),
        )
        for t in raw.get("taints", [])
    ]
    return NodeTemplate(
        allocatable={
            r: parse_quantity(str(v))
            for r, v in raw.get("allocatable", {}).items()
        },
        labels=labels,
        taints=taints,
    )


class NodeGroup(Protocol):
    def set_replicas(self, count: int, token=None) -> None:
        """Apply the desired replica count. `token` is an optional
        actuation fence stamp (recovery/fence.FenceToken): providers
        that enforce fencing verify it BEFORE applying and raise
        FenceRejectedError for a superseded generation; None (unfenced
        deployments) must always be accepted."""
        ...

    def get_replicas(self) -> int: ...

    def stabilized(self) -> Tuple[bool, str]:
        """(stable, message); message explains instability."""
        ...

    # OPTIONAL (resolved via getattr — older/simpler providers need not
    # implement it): the instance shape this group would add, or None when
    # the provider can't know (then scale-from-zero needs a live node).
    # def template(self) -> Optional[NodeTemplate]: ...


class CloudProviderFactory(Protocol):
    def node_group_for(self, spec) -> NodeGroup:
        """NodeGroup for a ScalableNodeGroupSpec."""
        ...

    def queue_for(self, spec) -> Queue:
        """Queue for a QueueSpec."""
        ...


@dataclass
class Options:
    """Injected into provider factories (reference: types.go:52-55)."""

    store: Optional[object] = None
