"""MetricsProducer implementations + one-of factory dispatch.

reference: pkg/metrics/producers/factory.go:36-62.

The port's copy of karpenter_tpu/metrics/producers/__init__.py.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.metrics.producers.fake import FakeProducer, NOT_IMPLEMENTED_ERROR
from karpenter_tpu_torch.metrics.producers.pendingcapacity import PendingCapacityProducer
from karpenter_tpu_torch.metrics.producers.queue import QueueProducer
from karpenter_tpu_torch.metrics.producers.reservedcapacity import ReservedCapacityProducer
from karpenter_tpu_torch.metrics.producers.scheduledcapacity import (
    ScheduledCapacityProducer,
)
from karpenter_tpu_torch.utils.log import logger


def profile_from_template(template):
    """cloudprovider.NodeTemplate -> the (alloc floats, labels set,
    taints set) profile tuple _group_profile produces from live nodes —
    the ONE conversion shared by the scale-from-zero resolver and the
    what-if simulation. Mirrors _group_profile's conventions: the pods
    resource defaults when undeclared, only hard taints constrain."""
    from karpenter_tpu_torch.metrics.producers.pendingcapacity import (
        DEFAULT_PODS_PER_NODE,
    )
    from karpenter_tpu_torch.store.columnar import RESOURCE_PODS

    alloc = {r: q.to_float() for r, q in template.allocatable.items()}
    if alloc and alloc.get(RESOURCE_PODS, 0.0) <= 0:
        alloc[RESOURCE_PODS] = DEFAULT_PODS_PER_NODE
    labels = set(template.labels.items())
    taints = {
        (t.key, t.value, t.effect)
        for t in template.taints
        if t.effect in ("NoSchedule", "NoExecute", "PreferNoSchedule")
    }
    return alloc, labels, taints


class ProducerFactory:
    def __init__(
        self, store, cloud_provider_factory, registry=None, solver=None,
        default_priority: int = 0,
    ):
        from karpenter_tpu_torch.metrics.registry import default_registry

        self.store = store
        self.cloud_provider_factory = cloud_provider_factory
        self.registry = registry if registry is not None else default_registry()
        # optional remote bin-pack (sidecar SolverClient.solve); None =
        # in-process device call
        self.solver = solver
        # fleet default for pods naming an unknown PriorityClass
        # (runtime --default-priority; docs/preemption.md)
        self.default_priority = default_priority
        self._pending_feed = None
        self._node_mirror = None
        self._reservations = None

    def node_mirror(self):
        """Shared watch-maintained Node mirror (store/columnar.NodeMirror),
        lazy like the feeds that use it."""
        if self._node_mirror is None:
            from karpenter_tpu_torch.metrics.producers.pendingcapacity import (
                group_profile,
            )
            from karpenter_tpu_torch.store.columnar import NodeMirror

            self._node_mirror = NodeMirror(self.store, group_profile)
        return self._node_mirror

    def reservations(self):
        """Incremental per-node reserved-resource sums for the
        reservedCapacity producer (store/columnar.ReservationsCache)."""
        if self._reservations is None:
            from karpenter_tpu_torch.store.columnar import ReservationsCache

            self._reservations = ReservationsCache(self.store)
        return self._reservations

    def pending_feed(self):
        """Incremental feed for the pending-pods solve — pod arena, node
        profiles, producer selectors, all watch-maintained
        (store/columnar.py). Created on FIRST pendingCapacity use so
        deployments without that producer never pay the per-mutation watch
        cost."""
        if self._pending_feed is None:
            from karpenter_tpu_torch.metrics.producers.pendingcapacity import (
                group_profile,
            )
            from karpenter_tpu_torch.store.columnar import PendingFeed

            self._pending_feed = PendingFeed(
                self.store, group_profile, node_mirror=self.node_mirror(),
                default_priority=self.default_priority,
            )
        return self._pending_feed

    # scale-from-zero templates change on pool reconfiguration, not per
    # tick; cache resolutions so an idle tick never pays a cloud-API
    # round trip (the memoized-tick cost model in OPERATIONS.md). A
    # changed template is picked up within TTL + one producer interval.
    template_cache_ttl = 60.0

    def template_resolver(self):
        """(namespace, node_group_ref) -> Optional[(alloc floats, labels
        set, taints set)] — the scale-from-zero seam for the pending-pods
        solve. Resolves the referenced ScalableNodeGroup from the store,
        asks the cloud provider for its NodeTemplate (optional protocol
        method; providers that can't know their instance shape return
        None / don't implement it), and converts to the profile tuple
        _group_profile produces from live nodes. Results are TTL-cached
        (template_cache_ttl) so the per-tick profile loop never blocks on
        the provider API."""
        import time as _time

        if not hasattr(self, "_template_cache"):
            self._template_cache = {}

        def resolve(namespace: str, ref: str):
            now = _time.monotonic()
            cached = self._template_cache.get((namespace, ref))
            if cached is not None and cached[0] > now:
                return cached[1]

            def uncached():
                sng = self.store.try_get(
                    "ScalableNodeGroup", namespace, ref
                )
                if sng is None:
                    return None
                group = self.cloud_provider_factory.node_group_for(sng.spec)
                template_fn = getattr(group, "template", None)
                template = (
                    template_fn() if template_fn is not None else None
                )
                if template is None:
                    return None
                return profile_from_template(template)

            result = uncached()
            self._template_cache[(namespace, ref)] = (
                now + self.template_cache_ttl,
                result,
            )
            return result

        return resolve

    def for_producer(self, mp):
        spec = mp.spec
        if spec.pending_capacity is not None:
            return PendingCapacityProducer(
                mp, self.store, registry=self.registry, solver=self.solver,
                feed=self.pending_feed(),
                template_resolver=self.template_resolver(),
            )
        if spec.queue is not None:
            return QueueProducer(
                mp,
                self.cloud_provider_factory.queue_for(spec.queue),
                registry=self.registry,
            )
        if spec.reserved_capacity is not None:
            return ReservedCapacityProducer(
                mp, self.store, registry=self.registry,
                reservations=self.reservations(),
                node_mirror=self.node_mirror(),
            )
        if spec.schedule is not None:
            return ScheduledCapacityProducer(mp, registry=self.registry)
        logger().error(
            "Failed to instantiate metrics producer, no spec defined for %s",
            mp.metadata.name,
        )
        return FakeProducer(want_err=NOT_IMPLEMENTED_ERROR)
