"""google-cloud bindings for the TPU provider's duck-typed API seams.

reference: the AWS analog is pkg/cloudprovider/aws/factory.go:41-76 (live
SDK session built at factory construction). The TPU provider's seams are
ContainerAPI (GKE node pools, tpu.py:63-77) and PubSubMetricsAPI (queue
depth/age via Cloud Monitoring, tpu.py:221-230); this module is their
production binding over google-cloud-container / google-cloud-monitoring.

Both SDKs are OPTIONAL. Nothing imports google.cloud at module import;
`bind_container` / `bind_pubsub_metrics` return None when the library is
missing or client construction fails, and TPUFactory keeps its
fail-with-guidance stubs. google.api_core errors are translated into the
controller taxonomy (RetryableError with the transport's retryability) so
TPUPodSlicePool's `except RetryableError: raise` path preserves terminal
vs transient classification instead of blanket-transient wrapping.

The port's copy of karpenter_tpu/cloudprovider/gke_sdk.py.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from karpenter_tpu_torch.controllers.errors import RetryableError
from karpenter_tpu_torch.utils.log import logger


def container_sdk_available() -> bool:
    import importlib.util

    return importlib.util.find_spec("google.cloud.container_v1") is not None


def monitoring_sdk_available() -> bool:
    import importlib.util

    return importlib.util.find_spec("google.cloud.monitoring_v3") is not None


# google.api_core exception class names whose failures clear on retry;
# everything else (NotFound, PermissionDenied, InvalidArgument, ...) is
# terminal and must NOT keep the controller requeueing forever.
_RETRYABLE_GOOGLE_ERRORS = frozenset(
    {
        "ServiceUnavailable",
        "DeadlineExceeded",
        "TooManyRequests",
        "InternalServerError",
        "Aborted",
        "GatewayTimeout",
        "RetryError",
    }
)


def _translate_call(fn, *args, **kwargs):
    """Run one google-cloud call, mapping google.api_core exceptions into
    RetryableError with honest retryability and the exception class name
    as the condition code."""
    try:
        import google.api_core.exceptions as gex
    except ImportError:  # SDK half-installed: classify nothing
        return fn(*args, **kwargs)

    try:
        return fn(*args, **kwargs)
    except gex.GoogleAPIError as e:
        # GoogleAPIError, not GoogleAPICallError: RetryError (client-side
        # retry deadline exhausted) subclasses only the former and must
        # still be classified — it is in the retryable set
        name = type(e).__name__
        wrapped = RetryableError(
            str(e), code=name, retryable=name in _RETRYABLE_GOOGLE_ERRORS
        )
        raise wrapped from e
    except (ConnectionError, TimeoutError) as e:
        wrapped = RetryableError(str(e), code="ConnectionError", retryable=True)
        raise wrapped from e


def _pool_name(project: str, location: str, cluster: str, pool: str) -> str:
    return (
        f"projects/{project}/locations/{location}"
        f"/clusters/{cluster}/nodePools/{pool}"
    )


def _tpu_chips_per_host(machine_type: str) -> Optional[int]:
    """GKE TPU machine types encode chips-per-host in the trailing
    '<n>t' token (ct5lp-hightpu-4t, ct4p-hightpu-4t, ct6e-standard-8t).
    None for non-TPU machine types."""
    if not machine_type.startswith("ct"):
        return None
    tail = machine_type.rsplit("-", 1)[-1]
    if tail.endswith("t") and tail[:-1].isdigit():
        return int(tail[:-1])
    return None


class GKEContainerClient:
    """ContainerAPI over google.cloud.container_v1.ClusterManagerClient."""

    def __init__(self, client):
        self._client = client

    def set_node_pool_size(
        self, project: str, location: str, cluster: str, pool: str, size: int
    ) -> None:
        _translate_call(
            self._client.set_node_pool_size,
            request={
                "name": _pool_name(project, location, cluster, pool),
                "node_count": size,
            },
        )

    def pending_operations(
        self, project: str, location: str, cluster: str, pool: str
    ) -> List[str]:
        """Names of in-flight operations targeting the pool. GKE holds a
        per-cluster operation lock, so any running cluster-scoped resize
        also blocks ours — report operations whose target mentions the
        pool OR the cluster with no pool qualifier."""
        response = _translate_call(
            self._client.list_operations,
            request={"parent": f"projects/{project}/locations/{location}"},
        )
        pool_path = _pool_name(project, location, cluster, pool)
        cluster_path = (
            f"projects/{project}/locations/{location}/clusters/{cluster}"
        )
        pending = []
        for op in getattr(response, "operations", []) or []:
            status = getattr(op, "status", None)
            status_name = getattr(status, "name", str(status))
            if status_name in ("DONE", "ABORTING"):
                continue
            target = getattr(op, "target_link", "") or ""
            # suffix match only: a substring test would also catch sibling
            # pools sharing the name prefix (v5e vs v5e-large)
            if target.endswith(pool_path) or target.endswith(cluster_path):
                pending.append(getattr(op, "name", "") or "operation")
        return pending

    def node_pool_template(
        self, project: str, location: str, cluster: str, pool: str
    ) -> Optional[dict]:
        """Scale-from-zero template from nodePools.get: labels/taints from
        the pool config; google.com/tpu allocatable derived from the TPU
        machine-type's chips-per-host token. cpu/memory are left to live
        nodes — GKE machine shapes aren't in the API response and the
        slice-pool solver keys on the chip resource."""
        node_pool = _translate_call(
            self._client.get_node_pool,
            request={"name": _pool_name(project, location, cluster, pool)},
        )
        config = getattr(node_pool, "config", None)
        if config is None:
            return None
        labels = dict(getattr(config, "labels", {}) or {})
        taints = [
            {
                "key": getattr(t, "key", ""),
                "value": getattr(t, "value", ""),
                "effect": getattr(
                    getattr(t, "effect", None), "name", ""
                ),
            }
            for t in getattr(config, "taints", []) or []
        ]
        allocatable: Dict[str, str] = {}
        machine_type = getattr(config, "machine_type", "") or ""
        chips = _tpu_chips_per_host(machine_type)
        if chips:
            allocatable["google.com/tpu"] = str(chips)
        if not allocatable:
            # a template with empty allocatable reads as a zero-capacity
            # node (nothing fits, the pool never scales from zero); None
            # correctly means "no declared shape, profile a live node"
            return None
        if machine_type:
            labels.setdefault(
                "node.kubernetes.io/instance-type", machine_type
            )
        return {
            "allocatable": allocatable,
            "labels": labels,
            "taints": taints,
        }


class MonitoringPubSubClient:
    """PubSubMetricsAPI over google.cloud.monitoring_v3: latest point of
    the subscription backlog gauges. Metrics lag ~60s; the queue producer
    already treats depth as a sampled signal (tpu.py PubSubSubscriptionQueue)."""

    # how far back to look for the latest written point; backlog gauges
    # are written once a minute
    _WINDOW_SECONDS = 300

    def __init__(self, client, clock=time.time):
        self._client = client
        self._clock = clock

    def _latest_point(self, project: str, metric: str, subscription: str):
        from google.cloud import monitoring_v3

        now = self._clock()
        interval = monitoring_v3.TimeInterval(
            {
                "end_time": {"seconds": int(now)},
                "start_time": {"seconds": int(now) - self._WINDOW_SECONDS},
            }
        )
        # drain the pager INSIDE the translation wrapper: subsequent pages
        # are fetched lazily during iteration and their transport errors
        # must hit the same RetryableError classification as the first RPC
        series = _translate_call(
            lambda: list(
                self._client.list_time_series(
                    request={
                        "name": f"projects/{project}",
                        "filter": (
                            "metric.type = "
                            f'"pubsub.googleapis.com/subscription/{metric}"'
                            " AND resource.labels.subscription_id = "
                            f'"{subscription}"'
                        ),
                        "interval": interval,
                        "view": (
                            monitoring_v3.ListTimeSeriesRequest
                            .TimeSeriesView.FULL
                        ),
                    },
                )
            )
        )
        for ts in series:
            points = getattr(ts, "points", []) or []
            if points:
                # points come newest-first from the API
                return points[0].value.int64_value
        return 0

    def num_undelivered_messages(
        self, project: str, subscription: str
    ) -> int:
        return int(
            self._latest_point(
                project, "num_undelivered_messages", subscription
            )
        )

    def oldest_unacked_message_age_seconds(
        self, project: str, subscription: str
    ) -> int:
        return int(
            self._latest_point(
                project, "oldest_unacked_message_age", subscription
            )
        )


def bind_container():
    """Production ContainerAPI, or None (caller keeps the guidance stub).
    Never raises: factory construction must succeed without GCP access."""
    if not container_sdk_available():
        return None
    try:
        from google.cloud import container_v1

        return GKEContainerClient(container_v1.ClusterManagerClient())
    except Exception as e:  # noqa: BLE001 — missing ADC etc.: degrade
        logger().warning("gke container binding failed: %s", e)
        return None


def bind_pubsub_metrics():
    """Production PubSubMetricsAPI, or None."""
    if not monitoring_sdk_available():
        return None
    try:
        from google.cloud import monitoring_v3

        return MonitoringPubSubClient(monitoring_v3.MetricServiceClient())
    except Exception as e:  # noqa: BLE001
        logger().warning("gke monitoring binding failed: %s", e)
        return None
