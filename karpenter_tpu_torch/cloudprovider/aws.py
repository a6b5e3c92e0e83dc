"""AWS cloud provider: EC2 AutoScalingGroups, EKS ManagedNodeGroups, SQS.

reference: pkg/cloudprovider/aws/{factory,autoscalinggroup,managednodegroup,
sqsqueue,error}.go. Same semantics, different binding: the reference links
aws-sdk-go and picks the region from EC2 metadata at construction
(factory.go:71-76); here the three API clients are INJECTED duck-typed
protocols (AutoscalingAPI / EKSAPI / SQSAPI), so the provider logic — ARN
handling, healthy-replica counting, transient-error classification — is
fully testable without the SDK, and a deployment binds boto3 (or anything
else) at the edge. The reference's compile-time `-tags=aws` selection
(registry/aws.go:1) maps to runtime registration under the name "aws".

The port's copy of karpenter_tpu/cloudprovider/aws.py.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, Tuple

from karpenter_tpu_torch.api.core import is_ready_and_schedulable
from karpenter_tpu_torch.api.metricsproducer import (
    AWS_SQS_QUEUE_TYPE,
    register_queue_validator,
)
from karpenter_tpu_torch.api.scalablenodegroup import (
    AWS_EC2_AUTO_SCALING_GROUP,
    AWS_EKS_NODE_GROUP,
    register_scalable_node_group_validator,
)
from karpenter_tpu_torch.cloudprovider import Options, node_template_from_raw
from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
from karpenter_tpu_torch.controllers.errors import RetryableError
from karpenter_tpu_torch.faults import inject

# Node label EKS applies to managed-node-group members
# (reference: managednodegroup.go NodeGroupLabel).
NODE_GROUP_LABEL = "eks.amazonaws.com/nodegroup"

# Error codes the AWS SDK retry classifier treats as transient
# (reference: error.go:45-47 delegates to request.IsErrorRetryable; this is
# the same family of codes, expressed directly).
RETRYABLE_CODES = frozenset(
    {
        "RequestError",
        "RequestTimeout",
        "RequestTimeoutException",
        "Throttling",
        "ThrottlingException",
        "ThrottledException",
        "RequestThrottled",
        "RequestThrottledException",
        "TooManyRequestsException",
        "ProvisionedThroughputExceededException",
        "TransactionInProgressException",
        "RequestLimitExceeded",
        "BandwidthLimitExceeded",
        "LimitExceededException",
        "SlowDown",
        "PriorRequestNotComplete",
        "EC2ThrottledException",
        "InternalFailure",
        "ServiceUnavailable",
    }
)


class AWSAPIError(RuntimeError):
    """An error from an AWS API call, carrying the service error code.

    Fakes (and a boto3 binding translating botocore ClientError) raise this;
    `retryable` overrides the code-based classification when the caller
    knows better (e.g. connection resets with no code).
    """

    def __init__(
        self, message: str, code: str = "", retryable: Optional[bool] = None
    ):
        super().__init__(message)
        self.code = code
        self.retryable = (
            retryable if retryable is not None else code in RETRYABLE_CODES
        )


def transient_error(err: Optional[BaseException]) -> Optional[RetryableError]:
    """Wrap an AWS error into the controller taxonomy (reference:
    error.go:28-55): retryability from the SDK classifier, code surfaced for
    status conditions. Returns None for None, mirroring TransientError."""
    if err is None:
        return None
    code = getattr(err, "code", "") or ""
    retryable = getattr(err, "retryable", None)
    if retryable is None:
        retryable = code in RETRYABLE_CODES
    wrapped = RetryableError(str(err), code=code, retryable=bool(retryable))
    wrapped.__cause__ = err
    return wrapped


# ---------------------------------------------------------------------------
# ARN handling
# ---------------------------------------------------------------------------


@dataclass
class Arn:
    partition: str
    service: str
    region: str
    account_id: str
    resource: str


def parse_arn(value: str) -> Arn:
    """arn:partition:service:region:account-id:resource (resource may itself
    contain colons)."""
    parts = value.split(":", 5)
    if len(parts) != 6 or parts[0] != "arn":
        raise ValueError(f"invalid ARN: {value!r}")
    return Arn(
        partition=parts[1],
        service=parts[2],
        region=parts[3],
        account_id=parts[4],
        resource=parts[5],
    )


def normalize_asg_id(id_: str) -> str:
    """ASG APIs take a NAME, but users paste ARNs in YAML: extract the name
    from an ASG ARN, pass non-ARNs through unchanged (they are either a
    valid name already or will fail at the API), and reject ARNs that are
    not ASG ARNs (reference: autoscalinggroup.go:56-76)."""
    try:
        arn = parse_arn(id_)
    except ValueError:
        return id_
    resource = arn.resource.split(":")
    if len(resource) < 3 or resource[0] != "autoScalingGroup":
        raise ValueError(f"{id_}: is not an autoScalingGroup ARN")
    name_specifier = resource[2].split("/")
    if len(name_specifier) != 2 or name_specifier[0] != "autoScalingGroupName":
        raise ValueError(f"{id_}: does not contain autoScalingGroupName")
    return name_specifier[1]


def parse_mng_id(id_: str) -> Tuple[str, str]:
    """(cluster, nodegroup) from an EKS node-group ARN, whose resource is
    nodegroup/<cluster>/<nodegroup>/<uuid> (reference:
    managednodegroup.go:69-84)."""
    arn = parse_arn(id_)  # raises ValueError on malformed ARNs
    components = arn.resource.split("/")
    if len(components) < 3:
        raise ValueError(f"invalid managed node group id {id_}")
    return components[1], components[2]


# ---------------------------------------------------------------------------
# API client protocols (duck-typed seams; fakes + real bindings implement)
# ---------------------------------------------------------------------------


class AutoscalingAPI(Protocol):
    def describe_auto_scaling_groups(
        self, names: List[str], max_records: int
    ) -> List[dict]:
        """Each dict: {"instances": [{"health_status", "lifecycle_state"}]}."""
        ...

    def update_auto_scaling_group(
        self, name: str, desired_capacity: int
    ) -> None: ...


class EKSAPI(Protocol):
    def update_nodegroup_config(
        self, cluster_name: str, nodegroup_name: str, desired_size: int
    ) -> None: ...


class SQSAPI(Protocol):
    def get_queue_url(self, queue_name: str, account_id: str) -> str: ...

    def get_queue_attributes(
        self, queue_url: str, attribute_names: List[str]
    ) -> Dict[str, str]: ...

    def receive_message(
        self,
        queue_url: str,
        attribute_names: List[str],
        max_number_of_messages: int,
        visibility_timeout: int,
    ) -> List[Dict]: ...


class _NotImplementedClient:
    """Default when no client is bound: every call fails with guidance —
    the analog of running the !aws build against AWS resources."""

    # the OPTIONAL template hook must read as absent (None), not as a
    # failing stub: the catch-all __getattr__ below would otherwise
    # defeat the getattr sentinel and turn "no declared shape" into a
    # per-tick error for every empty group
    describe_node_template = None

    def __init__(self, service: str):
        self._service = service

    def __getattr__(self, name):
        def fail(*args, **kwargs):
            raise RuntimeError(
                f"no {self._service} API client bound; inject one into "
                "AWSFactory (e.g. a boto3 binding) to actuate AWS resources"
            )

        return fail


# ---------------------------------------------------------------------------
# Node groups and queues
# ---------------------------------------------------------------------------


class AutoScalingGroup:
    """reference: autoscalinggroup.go:79-112."""

    def __init__(self, id_: str, client: AutoscalingAPI, fence=None):
        self.id = normalize_asg_id(id_)
        self.client = client
        # actuation fence (karpenter_tpu_torch/recovery): the factory's shared
        # FenceValidator; None = unfenced (direct construction, tests)
        self.fence = fence
        # one describe per reconcile: the controller calls stabilized()
        # then get_replicas() on the same short-lived instance (a fresh
        # one per reconcile), so memoizing the first describe halves the
        # DescribeAutoScalingGroups volume without staleness
        self._describe_memo = None

    def _describe(self) -> List[dict]:
        if self._describe_memo is None:
            try:
                inject("cloud.get_replicas")
                self._describe_memo = self.client.describe_auto_scaling_groups(
                    names=[self.id], max_records=1
                )
            except Exception as e:  # noqa: BLE001 — classified, not swallowed
                raise transient_error(e) from e
        return self._describe_memo

    @staticmethod
    def _count_healthy(group: dict) -> int:
        return sum(
            1
            for instance in group.get("instances", [])
            if instance.get("health_status") == "Healthy"
            and instance.get("lifecycle_state") == "InService"
        )

    def get_replicas(self) -> int:
        groups = self._describe()
        if len(groups) == 0:
            # distinct from "zero instances": the describe found NO group
            # with this name, so the SNG points at something that doesn't
            # exist (deleted, typo, wrong region/account)
            raise RuntimeError(f"autoscaling group not found: {self.id}")
        if len(groups) > 1:
            raise RuntimeError(
                f"autoscaling group name is ambiguous "
                f"({len(groups)} groups matched): {self.id}"
            )
        return self._count_healthy(groups[0])

    def set_replicas(self, count: int, token=None) -> None:
        # fence verification BEFORE apply (karpenter_tpu_torch/recovery): a
        # stale incarnation's stamp is rejected, never applied — and
        # never wrapped as transient (retrying a dead decision is the
        # exact failure fencing exists to stop)
        if self.fence is not None:
            self.fence.admit(token)
        try:
            inject("cloud.set_replicas")
            self.client.update_auto_scaling_group(
                name=self.id, desired_capacity=count
            )
        except Exception as e:  # noqa: BLE001
            raise transient_error(e) from e

    def stabilized(self) -> Tuple[bool, str]:
        """Stable iff every desired instance is Healthy+InService — the
        check the reference leaves TODO-true (autoscalinggroup.go:110).
        Clients that don't report desired_capacity (older fakes/bindings)
        keep the reference's always-stable behavior. (The SNG controller
        still actuates scale-DOWNS while unstable, so a group capped
        below desired by a capacity shortage can be shrunk out of it.)"""
        groups = self._describe()
        if len(groups) != 1:
            return True, ""  # unknown group surfaces via get_replicas
        desired = groups[0].get("desired_capacity")
        if desired is None:
            return True, ""
        healthy = self._count_healthy(groups[0])
        if healthy == desired:
            return True, ""
        return False, (
            f"{healthy}/{desired} instances healthy and in service"
        )

    def template(self):
        """Scale-from-zero NodeTemplate. The injected autoscaling client
        may implement the OPTIONAL `describe_node_template(name)` —
        a boto3 binding would combine the ASG's launch template instance
        type with DescribeInstanceTypes into {allocatable, labels,
        taints}. None (or no hook) = no declared shape; a live node is
        then required to profile the group."""
        template_fn = getattr(self.client, "describe_node_template", None)
        if template_fn is None:
            return None
        try:
            raw = template_fn(self.id)
        except Exception as e:  # noqa: BLE001 — same posture as reads
            raise transient_error(e) from e
        return node_template_from_raw(raw)


class ManagedNodeGroup:
    """reference: managednodegroup.go:86-114. Replica observation counts
    ready+schedulable nodes carrying the EKS node-group label — read from
    the object store (the apiserver analog), not the EKS API."""

    def __init__(self, id_: str, eks_client: EKSAPI, store, fence=None):
        try:
            self.cluster, self.node_group = parse_mng_id(id_)
        except ValueError:
            # invalid ARNs surface as reconcile errors, not constructor
            # failures (reference: managednodegroup.go:53-56)
            self.cluster, self.node_group = "", ""
        self.eks_client = eks_client
        self.store = store
        self.fence = fence  # shared FenceValidator, or None = unfenced

    def get_replicas(self) -> int:
        inject("cloud.get_replicas")
        nodes = self.store.list(
            "Node", label_selector={NODE_GROUP_LABEL: self.node_group}
        )
        return sum(1 for n in nodes if is_ready_and_schedulable(n))

    def set_replicas(self, count: int, token=None) -> None:
        if self.fence is not None:
            self.fence.admit(token)  # verified BEFORE apply; not transient
        try:
            inject("cloud.set_replicas")
            self.eks_client.update_nodegroup_config(
                cluster_name=self.cluster,
                nodegroup_name=self.node_group,
                desired_size=count,
            )
        except Exception as e:  # noqa: BLE001
            raise transient_error(e) from e

    def stabilized(self) -> Tuple[bool, str]:
        return True, ""  # reference leaves this TODO (managednodegroup.go:112)

    def template(self):
        """Scale-from-zero NodeTemplate via the OPTIONAL
        `describe_node_template(cluster, nodegroup)` hook on the injected
        EKS client (EKS describeNodegroup returns instanceTypes + labels
        + taints — with NO_SCHEDULE-style effect enums, converted here).
        The EKS node-group label is stamped so selectors over the group
        match the template."""
        template_fn = getattr(
            self.eks_client, "describe_node_template", None
        )
        if template_fn is None:
            return None
        try:
            raw = template_fn(self.cluster, self.node_group)
        except Exception as e:  # noqa: BLE001 — same posture as reads
            raise transient_error(e) from e
        return node_template_from_raw(
            raw, extra_labels={NODE_GROUP_LABEL: self.node_group}
        )


def _oldest_sent_ms(messages) -> Optional[int]:
    """Smallest (oldest) SentTimestamp in a sampled batch, epoch ms;
    None when the batch is empty or carries no parsable timestamps."""
    oldest_ms: Optional[int] = None
    for message in messages or []:
        raw = (message.get("Attributes") or {}).get("SentTimestamp")
        if raw is None:
            continue
        try:
            sent = int(raw)
        except ValueError:
            continue
        if oldest_ms is None or sent < oldest_ms:
            oldest_ms = sent
    return oldest_ms


class SQSQueue:
    """reference: sqsqueue.go:36-98."""

    def __init__(
        self,
        arn: str,
        client: SQSAPI,
        age_sample_interval: float = 60.0,
        clock=_time.time,
    ):
        self.arn = arn
        self.client = client
        self.age_sample_interval = age_sample_interval
        self.clock = clock
        self._cached_url: Optional[str] = None
        self._age_sampled_at: float = float("-inf")
        self._age_sample: int = 0
        self._age_saw_message: bool = False

    def name(self) -> str:
        return self.arn

    def length(self) -> int:
        url = self._url()
        try:
            attributes = self.client.get_queue_attributes(
                queue_url=url,
                attribute_names=["ApproximateNumberOfMessages"],
            )
        except Exception as e:  # noqa: BLE001
            raise RuntimeError(
                f"could not pull SQS queueAttributes with input URL: {e}"
            ) from e
        raw = attributes.get("ApproximateNumberOfMessages", "")
        try:
            return int(raw)
        except ValueError as e:
            raise RuntimeError(
                f"could not resolve SQS queueAttributes types, {raw!r}"
            ) from e

    def oldest_message_age_seconds(self) -> int:
        """The reference stubs this at 0 (sqsqueue.go:78-80) because SQS
        surfaces oldest-message age only as a CloudWatch metric.
        Implemented here by message-attribute sampling: peek a batch with
        visibility_timeout=0 and age the oldest SentTimestamp. A head
        sample is an approximation (SQS ordering is best-effort), but it
        turns a dead gauge into a usable scaling signal.

        Side-effect caveat: every ReceiveMessage increments the sampled
        messages' ApproximateReceiveCount even at visibility_timeout=0,
        which counts toward a redrive policy's maxReceiveCount. The
        sample is therefore cached for age_sample_interval (default 60 s
        vs the 5 s producer tick); on queues with an aggressive redrive
        policy, raise the interval or prefer the CloudWatch
        ApproximateAgeOfOldestMessage metric via the Prometheus path.
        The cached age is extrapolated by elapsed time between samples,
        so the gauge still climbs between refreshes."""
        now = self.clock()
        since = now - self._age_sampled_at
        if since < self.age_sample_interval:
            # a sampled EMPTY queue stays 0 between refreshes; a sampled
            # head climbs by elapsed time even when its age rounded to 0
            # at sample time (a fresh-but-stuck message must still age)
            if not self._age_saw_message:
                return 0
            return max(0, self._age_sample + int(since))
        url = self._url()
        try:
            messages = self.client.receive_message(
                queue_url=url,
                attribute_names=["SentTimestamp"],
                max_number_of_messages=10,
                visibility_timeout=0,
            )
        except Exception as e:  # noqa: BLE001
            raise RuntimeError(
                f"could not sample SQS messages for age: {e}"
            ) from e
        oldest_ms = _oldest_sent_ms(messages)
        self._age_sampled_at = now
        self._age_saw_message = oldest_ms is not None
        self._age_sample = (
            0 if oldest_ms is None else max(0, int(now - oldest_ms / 1000.0))
        )
        return self._age_sample

    def _url(self) -> str:
        # the ARN->URL mapping is immutable for this queue's lifetime;
        # resolve once instead of one extra SQS round-trip per poll
        if self._cached_url is not None:
            return self._cached_url
        arn = parse_arn(self.arn)
        try:
            self._cached_url = self.client.get_queue_url(
                queue_name=arn.resource, account_id=arn.account_id
            )
        except Exception as e:  # noqa: BLE001
            raise RuntimeError(f"could not get SQS queue URL {e}") from e
        return self._cached_url


# ---------------------------------------------------------------------------
# Factory + admission validators
# ---------------------------------------------------------------------------


class AWSFactory:
    """reference: factory.go:41-76. Client resolution order per seam:
    explicit injection, then — only when constructed through the registry
    (the operator explicitly selected KARPENTER_CLOUD_PROVIDER=aws, so a
    live session is wanted, like the reference's factory) — the boto3
    binding (aws_sdk.bind), then the fail-with-guidance stub. Direct
    construction defaults to injection-or-stub so tests and embedders
    never build live cloud clients (or do IMDS network I/O) as a side
    effect of an ambient SDK install."""

    def __init__(
        self,
        options: Optional[Options] = None,
        autoscaling_client: Optional[AutoscalingAPI] = None,
        eks_client: Optional[EKSAPI] = None,
        sqs_client: Optional[SQSAPI] = None,
        sdk_autobind: bool = False,
    ):
        options = options or Options()
        self.store = options.store
        if sdk_autobind:
            from karpenter_tpu_torch.cloudprovider import aws_sdk

            autoscaling_client = autoscaling_client or aws_sdk.bind(
                "autoscaling"
            )
            eks_client = eks_client or aws_sdk.bind("eks")
            sqs_client = sqs_client or aws_sdk.bind("sqs")
        self.autoscaling_client = autoscaling_client or _NotImplementedClient(
            "autoscaling"
        )
        self.eks_client = eks_client or _NotImplementedClient("eks")
        self.sqs_client = sqs_client or _NotImplementedClient("sqs")
        self._fallback = FakeFactory.not_implemented()
        # one actuation fence per factory — the cloud is shared
        # infrastructure, so every controller incarnation races the
        # same highest-seen generation (karpenter_tpu_torch/recovery)
        from karpenter_tpu_torch.recovery.fence import FenceValidator

        self.fence_validator = FenceValidator()
        # queue objects are cached per ARN so the SQSQueue URL cache
        # actually spans polls (producers resolve queue_for every tick)
        self._queues: Dict[str, SQSQueue] = {}

    def node_group_for(self, spec):
        if spec.type == AWS_EC2_AUTO_SCALING_GROUP:
            return AutoScalingGroup(
                spec.id, self.autoscaling_client,
                fence=self.fence_validator,
            )
        if spec.type == AWS_EKS_NODE_GROUP:
            return ManagedNodeGroup(
                spec.id, self.eks_client, self.store,
                fence=self.fence_validator,
            )
        return self._fallback.node_group_for(spec)

    def queue_for(self, spec):
        if spec.type == AWS_SQS_QUEUE_TYPE:
            queue = self._queues.get(spec.id)
            if queue is None:
                queue = self._queues[spec.id] = SQSQueue(
                    spec.id, self.sqs_client
                )
            return queue
        return self._fallback.queue_for(spec)


def _validate_asg(spec) -> None:
    normalize_asg_id(spec.id)


def _validate_mng(spec) -> None:
    parse_mng_id(spec.id)


def _validate_sqs(spec) -> None:
    parse_arn(spec.id)


# The reference registers its ASG normalizer under the EKS type — an
# upstream slip (autoscalinggroup.go:43-48 registers AWSEKSNodeGroup with
# normalizeID). Here each type gets its own validator.
register_scalable_node_group_validator(AWS_EC2_AUTO_SCALING_GROUP, _validate_asg)
register_scalable_node_group_validator(AWS_EKS_NODE_GROUP, _validate_mng)
register_queue_validator(AWS_SQS_QUEUE_TYPE, _validate_sqs)
