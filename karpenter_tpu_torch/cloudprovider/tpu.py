"""TPU pod-slice pool provider: the TPU-native ScalableNodeGroup.

The reference's "real" providers are AWS ASG/EKS node groups
(pkg/cloudprovider/aws/{autoscalinggroup,managednodegroup}.go). The TPU
deployment's replica unit is a GKE node pool of TPU pod slices: scaling the
pool by one adds one whole slice (a topology like 2x4), so replicas count
SLICES, not chips. Same SPI, same observation posture as the reference's
ManagedNodeGroup: observed replicas come from ready+schedulable nodes in
the store (the apiserver analog, managednodegroup.go:86-98), actuation goes
through an injected duck-typed container API (the UpdateNodegroupConfig
analog, managednodegroup.go:100-110).

Unlike the reference's TODO-true Stabilized (autoscalinggroup.go:110-112),
pools report unstable while a resize operation is in flight — the SNG
controller then holds actuation, which matters for TPU slices where a
partial slice is unusable.

The port's copy of karpenter_tpu/cloudprovider/tpu.py.
"""

from __future__ import annotations

import re
from typing import List, Optional, Protocol, Tuple

from karpenter_tpu_torch.api.core import is_ready_and_schedulable
from karpenter_tpu_torch.api.metricsproducer import register_queue_validator
from karpenter_tpu_torch.api.scalablenodegroup import (
    TPU_POD_SLICE_POOL,
    register_scalable_node_group_validator,
)
from karpenter_tpu_torch.cloudprovider import Options, node_template_from_raw
from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
from karpenter_tpu_torch.controllers.errors import RetryableError
from karpenter_tpu_torch.faults import inject

# GKE labels node-pool members with the pool name
NODE_POOL_LABEL = "cloud.google.com/gke-nodepool"
# TPU nodes additionally carry accelerator/topology labels
TPU_TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"

_POOL_ID_RE = re.compile(
    r"^projects/(?P<project>[^/]+)/locations/(?P<location>[^/]+)"
    r"(?:/clusters/(?P<cluster>[^/]+))?/nodePools/(?P<pool>[^/]+)$"
)


def parse_pool_id(id_: str) -> Tuple[str, str, str, str]:
    """(project, location, cluster, pool) from a GKE-style resource name.
    Cluster is optional in the short form."""
    m = _POOL_ID_RE.match(id_)
    if m is None:
        raise ValueError(
            f"invalid node pool id {id_!r}; want "
            "projects/<p>/locations/<l>[/clusters/<c>]/nodePools/<name>"
        )
    return (
        m.group("project"),
        m.group("location"),
        m.group("cluster") or "",
        m.group("pool"),
    )


class ContainerAPI(Protocol):
    """Duck-typed GKE container API seam (bind a google-cloud client or a
    fake here)."""

    def set_node_pool_size(
        self, project: str, location: str, cluster: str, pool: str, size: int
    ) -> None: ...

    def pending_operations(
        self, project: str, location: str, cluster: str, pool: str
    ) -> List[str]:
        """Names of in-flight resize/repair operations for the pool."""
        ...


class _NotImplementedContainerAPI:
    def set_node_pool_size(self, project, location, cluster, pool, size):
        raise RuntimeError(
            "no container API client bound; inject one into TPUFactory to "
            "actuate node pools"
        )

    def pending_operations(self, project, location, cluster, pool):
        return []


class TPUPodSlicePool:
    def __init__(self, id_: str, api: ContainerAPI, store, fence=None):
        self.project, self.location, self.cluster, self.pool = parse_pool_id(
            id_
        )
        self.api = api
        self.store = store
        # actuation fence (karpenter_tpu_torch/recovery): the factory's shared
        # FenceValidator; None = unfenced (direct construction, tests)
        self.fence = fence

    def get_replicas(self) -> int:
        """Ready slices = ready+schedulable nodes labeled with the pool name.
        For multi-host slices every host-node carries the pool label; ready
        hosts are divided by hosts-per-slice (conservative floor: a
        partially-ready slice is not a replica). Hosts-per-slice is derived
        from each node's OWN google.com/tpu allocatable (chips actually on
        that host) against the slice topology — hardware generations differ
        (4 chips/host on v4/v5p, 8 on single-host v5e/v6e shapes), so a
        constant would halve or double the count."""
        inject("cloud.get_replicas")
        nodes = self.store.list(
            "Node", label_selector={NODE_POOL_LABEL: self.pool}
        )
        ready = [n for n in nodes if is_ready_and_schedulable(n)]
        if not ready:
            return 0
        hosts_per_slice = max(
            (_hosts_per_slice(n) for n in ready), default=1
        )
        return len(ready) // max(hosts_per_slice, 1)

    def set_replicas(self, count: int, token=None) -> None:
        # fence verification BEFORE apply (karpenter_tpu_torch/recovery): a
        # stale incarnation's stamp is rejected, never applied, and the
        # rejection is NOT wrapped as a transient resize race below —
        # retrying a dead decision is what fencing exists to stop
        if self.fence is not None:
            self.fence.admit(token)
        try:
            inject("cloud.set_replicas")
            self.api.set_node_pool_size(
                self.project, self.location, self.cluster, self.pool, count
            )
        except RetryableError:
            raise
        except Exception as e:  # noqa: BLE001 — resize races are transient
            wrapped = RetryableError(str(e), code="ResizeFailed")
            wrapped.__cause__ = e
            raise wrapped from e

    def template(self):
        """NodeTemplate for scale-from-zero (cloudprovider.NodeTemplate):
        the host shape a pool resize would add, sourced from the bound
        container API's node-pool config when it exposes one
        (`node_pool_template` is an OPTIONAL api method — google's
        nodePools.get returns the machine config this models). None when
        the API can't say; live nodes always take precedence anyway."""
        template_fn = getattr(self.api, "node_pool_template", None)
        if template_fn is None:
            return None
        try:
            raw = template_fn(
                self.project, self.location, self.cluster, self.pool
            )
        except RetryableError:
            raise
        except Exception as e:  # noqa: BLE001 — API blips are transient,
            # same posture as stabilized/set_replicas
            wrapped = RetryableError(str(e), code="TemplateReadFailed")
            raise wrapped from e
        return node_template_from_raw(
            raw, extra_labels={NODE_POOL_LABEL: self.pool}
        )

    def stabilized(self) -> Tuple[bool, str]:
        try:
            pending = self.api.pending_operations(
                self.project, self.location, self.cluster, self.pool
            )
        except RetryableError:
            raise
        except Exception as e:  # noqa: BLE001 — API blips are transient:
            # keep the resource Active (AbleToScale=false) like set_replicas
            wrapped = RetryableError(str(e), code="OperationPollFailed")
            raise wrapped from e
        if pending:
            return False, f"operations in flight: {', '.join(pending)}"
        return True, ""


# fallback when a node doesn't report google.com/tpu allocatable
_DEFAULT_CHIPS_PER_HOST = 4
# node allocatable resource name for TPU chips on GKE
TPU_CHIP_RESOURCE = "google.com/tpu"


def _hosts_per_slice(node) -> int:
    """Hosts spanned by the slice this node belongs to: topology chip count
    divided by the chips this host itself exposes (ceil — a remainder still
    needs a host)."""
    topology = node.metadata.labels.get(TPU_TOPOLOGY_LABEL)
    if not topology:
        return 1
    try:
        chips = 1
        for dim in topology.lower().split("x"):
            chips *= int(dim)
    except ValueError:
        return 1
    chip_quantity = node.status.allocatable.get(TPU_CHIP_RESOURCE)
    chips_per_host = (
        int(chip_quantity.to_float())
        if chip_quantity is not None and chip_quantity.to_float() > 0
        else _DEFAULT_CHIPS_PER_HOST
    )
    return max(1, -(-chips // chips_per_host))


# ---------------------------------------------------------------------------
# Pub/Sub subscription queue — the GCP analog of the reference's SQS queue
# (reference: pkg/cloudprovider/aws/sqsqueue.go). Depth and age come from
# Cloud Monitoring's subscription/num_undelivered_messages and
# subscription/oldest_unacked_message_age metrics, read through a
# duck-typed seam like every other cloud API here.
# ---------------------------------------------------------------------------

GCP_PUBSUB_SUBSCRIPTION = "GCPPubSubSubscription"

_SUBSCRIPTION_ID_RE = re.compile(
    r"^projects/(?P<project>[^/]+)/subscriptions/(?P<name>[^/]+)$"
)


def parse_subscription_id(id_: str) -> Tuple[str, str]:
    m = _SUBSCRIPTION_ID_RE.match(id_)
    if m is None:
        raise ValueError(
            f"invalid subscription id {id_!r}; want "
            "projects/<project>/subscriptions/<name>"
        )
    return m.group("project"), m.group("name")


class PubSubMetricsAPI(Protocol):
    """Bind a Cloud Monitoring client (or a fake) here."""

    def num_undelivered_messages(
        self, project: str, subscription: str
    ) -> int: ...

    def oldest_unacked_message_age_seconds(
        self, project: str, subscription: str
    ) -> int: ...


class PubSubSubscriptionQueue:
    """Queue SPI over a Pub/Sub subscription. The reference's SQS stub
    never implemented message age (sqsqueue.go:78-80); Monitoring exposes
    it directly, so both gauges are real here."""

    def __init__(self, id_: str, api: PubSubMetricsAPI):
        self.project, self.subscription = parse_subscription_id(id_)
        self.api = api

    def name(self) -> str:
        return self.subscription

    def length(self) -> int:
        try:
            return int(
                self.api.num_undelivered_messages(
                    self.project, self.subscription
                )
            )
        except RetryableError:
            raise
        except Exception as e:  # noqa: BLE001 — monitoring blips are
            # transient, same posture as the pool API reads
            wrapped = RetryableError(str(e), code="QueueReadFailed")
            raise wrapped from e

    def oldest_message_age_seconds(self) -> int:
        try:
            return int(
                self.api.oldest_unacked_message_age_seconds(
                    self.project, self.subscription
                )
            )
        except RetryableError:
            raise
        except Exception as e:  # noqa: BLE001
            wrapped = RetryableError(str(e), code="QueueReadFailed")
            raise wrapped from e


class _NotImplementedPubSubAPI:
    def num_undelivered_messages(self, project, subscription):
        raise RuntimeError(
            "no Pub/Sub metrics client bound; inject one into TPUFactory "
            "to read subscription queues"
        )

    def oldest_unacked_message_age_seconds(self, project, subscription):
        raise RuntimeError(
            "no Pub/Sub metrics client bound; inject one into TPUFactory "
            "to read subscription queues"
        )


class TPUFactory:
    """Provider factory for TPU pod-slice pools + Pub/Sub subscription
    queues; anything else falls back to not-implemented."""

    def __init__(
        self,
        options: Optional[Options] = None,
        container_api: Optional[ContainerAPI] = None,
        pubsub_api: Optional[PubSubMetricsAPI] = None,
        sdk_autobind: bool = False,
    ):
        # resolution per seam: explicit injection, then — only via the
        # registry (operator selected the provider, a live client is
        # wanted) — the google-cloud binding (gke_sdk), then the
        # fail-with-guidance stub; direct construction never builds live
        # cloud clients as a side effect of an ambient SDK install
        options = options or Options()
        self.store = options.store
        if sdk_autobind:
            from karpenter_tpu_torch.cloudprovider import gke_sdk

            container_api = container_api or gke_sdk.bind_container()
            pubsub_api = pubsub_api or gke_sdk.bind_pubsub_metrics()
        self.container_api = container_api or _NotImplementedContainerAPI()
        self.pubsub_api = pubsub_api or _NotImplementedPubSubAPI()
        self._fallback = FakeFactory.not_implemented()
        # one actuation fence per factory — every controller incarnation
        # actuating through it races the same highest-seen generation
        from karpenter_tpu_torch.recovery.fence import FenceValidator

        self.fence_validator = FenceValidator()

    def node_group_for(self, spec):
        if spec.type == TPU_POD_SLICE_POOL:
            return TPUPodSlicePool(
                spec.id, self.container_api, self.store,
                fence=self.fence_validator,
            )
        return self._fallback.node_group_for(spec)

    def queue_for(self, spec):
        if spec.type == GCP_PUBSUB_SUBSCRIPTION:
            return PubSubSubscriptionQueue(spec.id, self.pubsub_api)
        return self._fallback.queue_for(spec)


def _validate_pool(spec) -> None:
    parse_pool_id(spec.id)


def _validate_subscription(spec) -> None:
    parse_subscription_id(spec.id)


register_scalable_node_group_validator(TPU_POD_SLICE_POOL, _validate_pool)
register_queue_validator(GCP_PUBSUB_SUBSCRIPTION, _validate_subscription)
