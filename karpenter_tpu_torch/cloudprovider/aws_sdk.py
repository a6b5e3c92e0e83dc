"""boto3 bindings for the AWS provider's duck-typed API seams.

reference: pkg/cloudprovider/aws/factory.go:41-76 — the reference
constructs a live SDK session at factory build time (region discovered
from the EC2 metadata service) and hands service clients to the node-group
and queue types. Here the SPI boundary is the Protocol trio in aws.py
(AutoscalingAPI / EKSAPI / SQSAPI); this module is the production binding:
thin adapters that translate call shapes and map botocore failures into
AWSAPIError so the provider's transient/terminal taxonomy (aws.py
transient_error, reference error.go:28-55) applies unchanged.

The SDK is OPTIONAL. Nothing here imports boto3 at module import; `bind`
returns None when boto3 is missing or a session cannot be built, and
AWSFactory then falls back to the fail-with-guidance stubs exactly as
before. Tests stub `boto3`/`botocore` in sys.modules — the adapters are
exercised against recorded call/response shapes, not the network.

The port's copy of karpenter_tpu/cloudprovider/aws_sdk.py.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from karpenter_tpu_torch.cloudprovider.aws import AWSAPIError
from karpenter_tpu_torch.utils.log import logger

# EC2 IMDSv2: the region source of last resort, like the reference's
# ec2metadata lookup (factory.go:71-76). Short timeouts: off-EC2 the
# link-local address is unroutable and must fail fast, not hang startup.
_IMDS_BASE = "http://169.254.169.254"
_IMDS_TIMEOUT = 2.0


def sdk_available() -> bool:
    import importlib.util

    return importlib.util.find_spec("boto3") is not None


def resolve_region(session=None) -> Optional[str]:
    """Region discovery order: explicit env, SDK config chain (profile /
    shared config), then EC2 instance metadata. None when undiscoverable —
    the caller degrades to the guidance stub rather than guessing."""
    region = os.environ.get("AWS_REGION") or os.environ.get(
        "AWS_DEFAULT_REGION"
    )
    if region:
        return region
    if session is not None and getattr(session, "region_name", None):
        return session.region_name
    return _imds_region()


def _imds_region() -> Optional[str]:
    import urllib.error
    import urllib.request

    try:
        token_req = urllib.request.Request(
            f"{_IMDS_BASE}/latest/api/token",
            method="PUT",
            headers={"X-aws-ec2-metadata-token-ttl-seconds": "60"},
        )
        with urllib.request.urlopen(token_req, timeout=_IMDS_TIMEOUT) as r:
            token = r.read().decode()
        region_req = urllib.request.Request(
            f"{_IMDS_BASE}/latest/meta-data/placement/region",
            headers={"X-aws-ec2-metadata-token": token},
        )
        with urllib.request.urlopen(region_req, timeout=_IMDS_TIMEOUT) as r:
            return r.read().decode().strip() or None
    except (urllib.error.URLError, OSError, ValueError):
        return None


def _translate_call(fn, *args, **kwargs):
    """Run one SDK call, mapping botocore failures into AWSAPIError so the
    provider's classifier (transient_error) sees the service error code;
    connection-level failures carry no code and are forced retryable."""
    import botocore.exceptions as bex

    try:
        return fn(*args, **kwargs)
    except bex.ClientError as e:
        error = (getattr(e, "response", None) or {}).get("Error", {})
        raise AWSAPIError(
            error.get("Message") or str(e), code=error.get("Code", "")
        ) from e
    except (
        # the connection-failure base classes, not a leaf enumeration:
        # ConnectionClosedError, ProxyConnectionError, SSLError,
        # ReadTimeoutError etc. all subclass one of these two — any of
        # them classified terminal would stop the controller requeueing
        # over a network blip
        bex.ConnectionError,
        bex.HTTPClientError,
    ) as e:
        raise AWSAPIError(str(e), retryable=True) from e


# Cluster-autoscaler's ASG tag convention for declaring the shape of
# scale-from-zero nodes; the standard way an operator annotates an ASG
# with what its nodes will look like before any exist.
_CAS_LABEL_TAG = "k8s.io/cluster-autoscaler/node-template/label/"
_CAS_TAINT_TAG = "k8s.io/cluster-autoscaler/node-template/taint/"


def _instance_type_allocatable(ec2, instance_type: str) -> Dict[str, str]:
    """DescribeInstanceTypes -> allocatable resource strings. Capacity,
    not true allocatable (kubelet reservations are deployment-specific);
    the solver treats templates as optimistic upper bounds already."""
    out = _translate_call(
        ec2.describe_instance_types, InstanceTypes=[instance_type]
    )
    infos = out.get("InstanceTypes") or []
    if not infos:
        return {}
    info = infos[0]
    allocatable: Dict[str, str] = {}
    vcpus = (info.get("VCpuInfo") or {}).get("DefaultVCpus")
    if vcpus:
        allocatable["cpu"] = str(vcpus)
    mib = (info.get("MemoryInfo") or {}).get("SizeInMiB")
    if mib:
        allocatable["memory"] = f"{mib}Mi"
    gpus = sum(
        g.get("Count", 0) for g in (info.get("GpuInfo") or {}).get("Gpus", [])
    )
    if gpus:
        allocatable["nvidia.com/gpu"] = str(gpus)
    return allocatable


def _labels_taints_from_tags(tags: Dict[str, str]):
    """Decode the cluster-autoscaler node-template tag convention into
    (labels, taints)."""
    labels: Dict[str, str] = {}
    taints = []
    for key, value in tags.items():
        if key.startswith(_CAS_LABEL_TAG):
            labels[key[len(_CAS_LABEL_TAG):]] = value
        elif key.startswith(_CAS_TAINT_TAG):
            taint_value, _, effect = value.partition(":")
            taints.append(
                {
                    "key": key[len(_CAS_TAINT_TAG):],
                    "value": taint_value,
                    "effect": effect,
                }
            )
    return labels, taints


class Boto3AutoscalingClient:
    """AutoscalingAPI over boto3 autoscaling (+ ec2 for templates)."""

    def __init__(self, autoscaling, ec2=None):
        self._autoscaling = autoscaling
        self._ec2 = ec2

    def describe_auto_scaling_groups(
        self, names: List[str], max_records: int
    ) -> List[dict]:
        out = _translate_call(
            self._autoscaling.describe_auto_scaling_groups,
            AutoScalingGroupNames=list(names),
            MaxRecords=max_records,
        )
        return [
            {
                "name": g.get("AutoScalingGroupName", ""),
                "desired_capacity": g.get("DesiredCapacity"),
                "instances": [
                    {
                        "health_status": i.get("HealthStatus", ""),
                        "lifecycle_state": i.get("LifecycleState", ""),
                    }
                    for i in g.get("Instances", [])
                ],
                "tags": {
                    t.get("Key", ""): t.get("Value", "")
                    for t in g.get("Tags", [])
                },
                "launch_template": g.get("LaunchTemplate")
                or (g.get("MixedInstancesPolicy") or {})
                .get("LaunchTemplate", {})
                .get("LaunchTemplateSpecification"),
                "overrides": (g.get("MixedInstancesPolicy") or {})
                .get("LaunchTemplate", {})
                .get("Overrides", []),
            }
            for g in out.get("AutoScalingGroups", [])
        ]

    def update_auto_scaling_group(
        self, name: str, desired_capacity: int
    ) -> None:
        _translate_call(
            self._autoscaling.update_auto_scaling_group,
            AutoScalingGroupName=name,
            DesiredCapacity=desired_capacity,
        )

    def _launch_template_instance_type(self, spec: dict) -> Optional[str]:
        """Instance type from a LaunchTemplateSpecification. Specs carry
        EITHER an id or a name (both shapes are returned by AWS); passing
        a None id would be a ParamValidationError."""
        if spec.get("LaunchTemplateId"):
            lt_ref = {"LaunchTemplateId": spec["LaunchTemplateId"]}
        elif spec.get("LaunchTemplateName"):
            lt_ref = {"LaunchTemplateName": spec["LaunchTemplateName"]}
        else:
            return None
        versions = _translate_call(
            self._ec2.describe_launch_template_versions,
            Versions=[spec.get("Version", "$Default")],
            **lt_ref,
        ).get("LaunchTemplateVersions") or []
        if not versions:
            return None
        return versions[0].get("LaunchTemplateData", {}).get("InstanceType")

    def describe_node_template(self, name: str) -> Optional[dict]:
        """Scale-from-zero template: instance type from the ASG's launch
        template (override first — mixed policies list the real types
        there), sized via DescribeInstanceTypes; labels/taints from the
        cluster-autoscaler node-template tag convention."""
        groups = self.describe_auto_scaling_groups([name], 1)
        if len(groups) != 1:
            return None
        group = groups[0]
        instance_type = None
        for override in group["overrides"]:
            if override.get("InstanceType"):
                instance_type = override["InstanceType"]
                break
        if instance_type is None and group["launch_template"] and self._ec2:
            instance_type = self._launch_template_instance_type(
                group["launch_template"]
            )
        if instance_type is None or self._ec2 is None:
            return None
        labels, taints = _labels_taints_from_tags(group["tags"])
        allocatable = _instance_type_allocatable(self._ec2, instance_type)
        if not allocatable:
            return None
        labels.setdefault("node.kubernetes.io/instance-type", instance_type)
        return {
            "allocatable": allocatable,
            "labels": labels,
            "taints": taints,
        }


class Boto3EKSClient:
    """EKSAPI over boto3 eks (+ ec2 for template sizing)."""

    def __init__(self, eks, ec2=None):
        self._eks = eks
        self._ec2 = ec2

    def update_nodegroup_config(
        self, cluster_name: str, nodegroup_name: str, desired_size: int
    ) -> None:
        _translate_call(
            self._eks.update_nodegroup_config,
            clusterName=cluster_name,
            nodegroupName=nodegroup_name,
            scalingConfig={"desiredSize": desired_size},
        )

    def describe_node_template(
        self, cluster_name: str, nodegroup_name: str
    ) -> Optional[dict]:
        nodegroup = _translate_call(
            self._eks.describe_nodegroup,
            clusterName=cluster_name,
            nodegroupName=nodegroup_name,
        ).get("nodegroup") or {}
        instance_types = nodegroup.get("instanceTypes") or []
        if not instance_types or self._ec2 is None:
            return None
        allocatable = _instance_type_allocatable(
            self._ec2, instance_types[0]
        )
        if not allocatable:
            return None
        labels = dict(nodegroup.get("labels") or {})
        labels.setdefault(
            "node.kubernetes.io/instance-type", instance_types[0]
        )
        return {
            "allocatable": allocatable,
            "labels": labels,
            # EKS spells effects NO_SCHEDULE etc.; node_template_from_raw
            # translates the enum dialect
            "taints": [
                {
                    "key": t.get("key", ""),
                    "value": t.get("value", ""),
                    "effect": t.get("effect", ""),
                }
                for t in nodegroup.get("taints") or []
            ],
        }


class Boto3SQSClient:
    """SQSAPI over boto3 sqs."""

    def __init__(self, sqs):
        self._sqs = sqs

    def get_queue_url(self, queue_name: str, account_id: str) -> str:
        return _translate_call(
            self._sqs.get_queue_url,
            QueueName=queue_name,
            QueueOwnerAWSAccountId=account_id,
        )["QueueUrl"]

    def get_queue_attributes(
        self, queue_url: str, attribute_names: List[str]
    ) -> Dict[str, str]:
        return (
            _translate_call(
                self._sqs.get_queue_attributes,
                QueueUrl=queue_url,
                AttributeNames=list(attribute_names),
            ).get("Attributes")
            or {}
        )

    def receive_message(
        self,
        queue_url: str,
        attribute_names: List[str],
        max_number_of_messages: int,
        visibility_timeout: int,
    ) -> List[Dict]:
        return (
            _translate_call(
                self._sqs.receive_message,
                QueueUrl=queue_url,
                AttributeNames=list(attribute_names),
                MaxNumberOfMessages=max_number_of_messages,
                VisibilityTimeout=visibility_timeout,
            ).get("Messages")
            or []
        )


# One session/region resolution (and one service client per name) per
# process: binding is called once per seam from AWSFactory.__init__, and
# both Session construction and client construction re-read config files /
# re-resolve endpoints each time. The ec2 client in particular is shared
# by the autoscaling and eks seams.
_bind_lock = threading.Lock()
_session_cache: Optional[tuple] = None  # (session, region) or (None, None)
_client_cache: Dict[str, object] = {}


def _session_and_region():
    global _session_cache
    with _bind_lock:
        if _session_cache is None:
            import boto3

            session = boto3.session.Session()
            region = resolve_region(session)
            if region is None:
                logger().warning(
                    "aws sdk present but no region discoverable "
                    "(env/config/IMDS); AWS clients stay unbound"
                )
                _session_cache = (None, None)
            else:
                _session_cache = (session, region)
        return _session_cache


def _service_client(session, region, name: str):
    with _bind_lock:
        client = _client_cache.get(name)
        if client is None:
            client = _client_cache[name] = session.client(
                name, region_name=region
            )
        return client


def bind(service: str):
    """Build the production client for one API seam, or None when the SDK
    is missing / unconfigured (caller falls back to the guidance stub).
    Never raises for a known seam: provider construction must succeed
    without AWS access — the control plane may be scaling only non-AWS
    resources. (botocore's InvalidRegionError subclasses ValueError, so
    the unknown-seam check sits OUTSIDE the degrade-to-None handler.)"""
    if service not in ("autoscaling", "eks", "sqs"):
        raise ValueError(f"unknown AWS service seam {service!r}")
    if not sdk_available():
        return None
    try:
        session, region = _session_and_region()
        if session is None:
            return None
        if service == "autoscaling":
            return Boto3AutoscalingClient(
                _service_client(session, region, "autoscaling"),
                _service_client(session, region, "ec2"),
            )
        if service == "eks":
            return Boto3EKSClient(
                _service_client(session, region, "eks"),
                _service_client(session, region, "ec2"),
            )
        return Boto3SQSClient(_service_client(session, region, "sqs"))
    except Exception as e:  # noqa: BLE001 — constructing clients must not
        # take down factory construction; actuation will fail with guidance
        logger().warning("aws sdk binding for %s failed: %s", service, e)
        return None


def reset_binding_cache() -> None:
    """Test hook: forget the cached session/region and clients."""
    global _session_cache
    with _bind_lock:
        _session_cache = None
        _client_cache.clear()
