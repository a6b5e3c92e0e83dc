"""ReservedCapacity producer: committed vs allocatable resources per node group.

reference: pkg/metrics/producers/reservedcapacity/{producer,reservations,gauges}.go —
lists nodes by selector, filters ready+schedulable, sums container requests of
pods on each node (via the spec.nodeName index) against allocatable, and emits
9 gauges (cpu/memory/pods × reserved/capacity/utilization) plus human-readable
status strings like "15.54%, 7600m/48900m".

Status strings use exact Quantity arithmetic (host) for bit-identical output;
gauges carry the float values the autoscaler consumes. At fleet scale the
batched aggregation path (ops) subsumes this per-producer loop.

The port's copy of karpenter_tpu/metrics/producers/reservedcapacity.py.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from karpenter_tpu_torch.api.core import (
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    is_ready_and_schedulable,
)
from karpenter_tpu_torch.metrics.registry import GaugeRegistry, default_registry
from karpenter_tpu_torch.utils.quantity import Quantity, parse_quantity

SUBSYSTEM = "reserved_capacity"
RESERVED = "reserved"
CAPACITY = "capacity"
UTILIZATION = "utilization"

RESOURCES = (RESOURCE_PODS, RESOURCE_CPU, RESOURCE_MEMORY)
METRIC_TYPES = (RESERVED, CAPACITY, UTILIZATION)

_ONE = parse_quantity("1")


class Reservations:
    """Accumulator (reference: reservations.go:24-56)."""

    def __init__(self):
        self.reserved: Dict[str, Quantity] = {r: Quantity() for r in RESOURCES}
        self.capacity: Dict[str, Quantity] = {r: Quantity() for r in RESOURCES}

    def add(self, node, pods) -> None:
        for pod in pods:
            self.reserved[RESOURCE_PODS] = self.reserved[RESOURCE_PODS].add(_ONE)
            for container in pod.spec.containers:
                for resource in (RESOURCE_CPU, RESOURCE_MEMORY):
                    q = container.requests.get(resource)
                    if q is not None:
                        self.reserved[resource] = self.reserved[resource].add(q)
        for resource in RESOURCES:
            q = node.status.allocatable.get(resource)
            if q is not None:
                self.capacity[resource] = self.capacity[resource].add(q)


def register_gauges(registry: GaugeRegistry) -> None:
    """reference: gauges.go:34-44"""
    for resource in RESOURCES:
        for metric_type in METRIC_TYPES:
            registry.register(SUBSYSTEM, f"{resource}_{metric_type}")


class ReservedCapacityProducer:
    def __init__(
        self,
        mp,
        store,
        registry: Optional[GaugeRegistry] = None,
        reservations=None,
        node_mirror=None,
    ):
        self.mp = mp
        self.store = store
        self.registry = registry if registry is not None else default_registry()
        # incremental feed (store/columnar.ReservationsCache + NodeMirror):
        # O(nodes-in-group) per tick instead of O(nodes + pods); None runs
        # the oracle list path the property tests compare against
        self.reservations = reservations
        self.node_mirror = node_mirror
        register_gauges(self.registry)

    def reconcile(self) -> None:
        selector = self.mp.spec.reserved_capacity.node_selector
        if self.node_mirror is not None:
            nodes = self.node_mirror.nodes(selector)
        else:
            nodes = self.store.list("Node", label_selector=selector)
        # Only ready+schedulable nodes count, to avoid diluting the
        # denominator and triggering premature scale-down
        # (reference: producer.go:46-48).
        ready = [n for n in nodes if is_ready_and_schedulable(n)]
        reservations = Reservations()
        if self.reservations is not None:
            totals = self.reservations.reserved_on(
                node.metadata.name for node in ready
            )
            for resource in RESOURCES:
                cached = totals.get(resource)
                if cached is not None:
                    reservations.reserved[resource] = cached
            for node in ready:
                reservations.add(node, ())  # capacity side only
        else:
            for node in ready:
                pods = self.store.pods_on_node(node.metadata.name)
                reservations.add(node, pods)
        self._record(reservations)

    def _record(self, reservations: Reservations) -> None:
        """reference: producer.go:63-86

        Display canonicalization: Quantity.add adopts the first non-zero
        operand's format, so the reserved sum's format depends on pod
        event/iteration order — which differs between the incremental
        ReservationsCache path and the oracle list path. The capacity sum
        is order-stable (same ready-node list either way), so reserved is
        re-rendered in capacity's format: both paths emit bit-identical
        status strings, this module's stated goal.
        """
        for resource in RESOURCES:
            reserved_q = reservations.reserved[resource]
            capacity_q = reservations.capacity[resource]
            if reserved_q.value != 0 and capacity_q.value != 0:
                reserved_q = Quantity(reserved_q.value, capacity_q.format)
            reserved = reserved_q.to_float()
            capacity = capacity_q.to_float()
            utilization = reserved / capacity if capacity != 0 else math.nan

            name, namespace = self.mp.metadata.name, self.mp.metadata.namespace
            gauge = lambda t: self.registry.gauge(SUBSYSTEM, f"{resource}_{t}")
            gauge(UTILIZATION).set(name, namespace, utilization)
            gauge(RESERVED).set(name, namespace, reserved)
            gauge(CAPACITY).set(name, namespace, capacity)

            percent = utilization * 100
            rendered = "NaN" if math.isnan(percent) else f"{percent:.2f}"
            self.mp.status.reserved_capacity[resource] = (
                f"{rendered}%, {reserved_q}/{capacity_q}"
            )
