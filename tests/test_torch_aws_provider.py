"""AWS provider parity tests.

Table cases mirror the reference's unit suites: ASG ARN normalization
(pkg/cloudprovider/aws/autoscalinggroup_test.go:20-47), SQS queue length
happy/error (sqsqueue_test.go:27-64), MNG ready-node counting
(suite_test.go:45-62), plus transient-error classification (error.go:28-55)
flowing through the ScalableNodeGroup controller.

The port's copy of tests/test_aws_provider.py: the same cases on
karpenter_tpu_torch, with the same fakes. The runtimes run on the CPU.
"""

import pytest

from karpenter_tpu_torch.api.core import (
    Node,
    NodeCondition,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    resource_list,
)
from karpenter_tpu_torch.api.metricsproducer import (
    AWS_SQS_QUEUE_TYPE,
    QueueSpec,
    validate_queue,
)
from karpenter_tpu_torch.api.scalablenodegroup import (
    AWS_EC2_AUTO_SCALING_GROUP,
    AWS_EKS_NODE_GROUP,
    ScalableNodeGroup,
    ScalableNodeGroupSpec,
)
from karpenter_tpu_torch.cloudprovider import Options
from karpenter_tpu_torch.cloudprovider.aws import (
    AWSAPIError,
    AWSFactory,
    AutoScalingGroup,
    ManagedNodeGroup,
    NODE_GROUP_LABEL,
    SQSQueue,
    normalize_asg_id,
    parse_arn,
    parse_mng_id,
    transient_error,
)
from karpenter_tpu_torch.controllers.errors import error_code, is_retryable
from karpenter_tpu_torch.runtime import KarpenterRuntime
from karpenter_tpu_torch.runtime import Options as RuntimeOptions
from karpenter_tpu_torch.store import Store

ASG_ARN = (
    "arn:aws:autoscaling:region:123456789012:"
    "autoScalingGroup:uuid:autoScalingGroupName/asg-name"
)
MNG_ARN = (
    "arn:aws:eks:us-west-2:741206201142:"
    "nodegroup/ridiculous-sculpture-1594766004/ng-0b663e8a/aeb9a7fe"
)
SQS_ARN = "arn:aws:iam:us-west-2:112358132134:fibonacci"


# --- fakes mirroring pkg/cloudprovider/aws/fake/ ---------------------------


class FakeAutoscalingAPI:
    def __init__(self, instances=(), want_err=None):
        self.instances = list(instances)
        self.want_err = want_err
        self.updated = None

    def describe_auto_scaling_groups(self, names, max_records):
        if self.want_err:
            raise self.want_err
        return [{"instances": self.instances}]

    def update_auto_scaling_group(self, name, desired_capacity):
        if self.want_err:
            raise self.want_err
        self.updated = (name, desired_capacity)


class FakeEKSAPI:
    def __init__(self, want_err=None):
        self.want_err = want_err
        self.updated = None

    def update_nodegroup_config(
        self, cluster_name, nodegroup_name, desired_size
    ):
        if self.want_err:
            raise self.want_err
        self.updated = (cluster_name, nodegroup_name, desired_size)


class FakeSQSAPI:
    def __init__(self, url="oopsydaisy", attributes=None, want_err=None,
                 messages=None):
        self.url = url
        self.attributes = attributes or {}
        self.want_err = want_err
        self.messages = messages or []
        self.receive_calls = []

    def get_queue_url(self, queue_name, account_id):
        self.url_calls = getattr(self, "url_calls", 0) + 1
        if self.want_err:
            raise self.want_err
        return self.url

    def get_queue_attributes(self, queue_url, attribute_names):
        if self.want_err:
            raise self.want_err
        return self.attributes

    def receive_message(self, queue_url, attribute_names,
                        max_number_of_messages, visibility_timeout):
        if self.want_err:
            raise self.want_err
        self.receive_calls.append(
            (queue_url, tuple(attribute_names), max_number_of_messages,
             visibility_timeout)
        )
        return self.messages[:max_number_of_messages]


# --- ARN tables (reference: autoscalinggroup_test.go:20-47) ----------------


class TestNormalizeASGID:
    @pytest.mark.parametrize(
        "value,expected",
        [
            ("", ""),
            ("foo", "foo"),
            (ASG_ARN, "asg-name"),
            (
                "arn:aws:autoscaling:region:123456789012:"
                "autoScalingGroup:uuid:autoScalingGroupName/",
                "",
            ),
        ],
    )
    def test_ok(self, value, expected):
        assert normalize_asg_id(value) == expected

    @pytest.mark.parametrize(
        "value",
        [
            # missing the name specifier entirely
            "arn:aws:autoscaling:region:123456789012:"
            "autoScalingGroup:uuid:autoScalingGroupName",
            # misspelled specifier
            "arn:aws:autoscaling:region:123456789012:"
            "autoScalingGroup:uuid:utoScalingGroupName/asg-name",
            "arn:aws:autoscalin:region:123456789012:"
            "autoScalingGroup:uuid:utoScalingGroupName/asg-name",
        ],
    )
    def test_invalid(self, value):
        with pytest.raises(ValueError):
            normalize_asg_id(value)


class TestParseMNGID:
    def test_extracts_cluster_and_nodegroup(self):
        assert parse_mng_id(MNG_ARN) == (
            "ridiculous-sculpture-1594766004",
            "ng-0b663e8a",
        )

    @pytest.mark.parametrize("value", ["not-an-arn", "arn:aws:eks:r:a:flat"])
    def test_invalid(self, value):
        with pytest.raises(ValueError):
            parse_mng_id(value)


class TestParseArn:
    def test_resource_keeps_colons(self):
        assert (
            parse_arn(ASG_ARN).resource
            == "autoScalingGroup:uuid:autoScalingGroupName/asg-name"
        )

    def test_fields(self):
        arn = parse_arn(SQS_ARN)
        assert arn.account_id == "112358132134"
        assert arn.resource == "fibonacci"


# --- ASG replica semantics (reference: autoscalinggroup.go:79-108) ---------


class TestAutoScalingGroup:
    def test_stabilized_from_desired_capacity(self):
        """Beats the reference's TODO-true Stabilized: unstable while the
        ASG converges toward desired, stable once every desired instance
        is Healthy+InService; clients without desired_capacity keep the
        reference behavior."""

        class DescribeAPI(FakeAutoscalingAPI):
            def __init__(self, instances, desired=None):
                super().__init__(instances)
                self.desired = desired

            def describe_auto_scaling_groups(self, names, max_records):
                group = {"instances": self.instances}
                if self.desired is not None:
                    group["desired_capacity"] = self.desired
                return [group]

        healthy = {"health_status": "Healthy", "lifecycle_state": "InService"}
        pending = {"health_status": "Healthy", "lifecycle_state": "Pending"}
        converging = AutoScalingGroup(
            "asg", DescribeAPI([healthy, pending], desired=2)
        )
        stable, message = converging.stabilized()
        assert not stable and "1/2" in message
        settled = AutoScalingGroup(
            "asg", DescribeAPI([healthy, healthy], desired=2)
        )
        assert settled.stabilized() == (True, "")
        legacy = AutoScalingGroup("asg", DescribeAPI([pending]))
        assert legacy.stabilized() == (True, "")

    def test_one_describe_per_reconcile_instance(self):
        """stabilized() + get_replicas() on one (per-reconcile) instance
        must cost ONE DescribeAutoScalingGroups call, not two."""

        class CountingAPI(FakeAutoscalingAPI):
            calls = 0

            def describe_auto_scaling_groups(self, names, max_records):
                CountingAPI.calls += 1
                return [{"instances": self.instances, "desired_capacity": 0}]

        group = AutoScalingGroup("asg", CountingAPI())
        group.stabilized()
        group.get_replicas()
        assert CountingAPI.calls == 1

    def test_counts_only_healthy_in_service(self):
        api = FakeAutoscalingAPI(
            instances=[
                {"health_status": "Healthy", "lifecycle_state": "InService"},
                {"health_status": "Healthy", "lifecycle_state": "Pending"},
                {"health_status": "Unhealthy", "lifecycle_state": "InService"},
                {"health_status": "Healthy", "lifecycle_state": "InService"},
            ]
        )
        assert AutoScalingGroup(ASG_ARN, api).get_replicas() == 2

    def test_set_replicas_uses_normalized_name(self):
        api = FakeAutoscalingAPI()
        AutoScalingGroup(ASG_ARN, api).set_replicas(7)
        assert api.updated == ("asg-name", 7)

    def test_missing_group_names_the_condition(self):
        """An empty describe means the group does not exist — the error
        must say so, not claim the group 'has no instances' (a healthy
        scaled-to-zero group also has no instances)."""

        class EmptyAPI(FakeAutoscalingAPI):
            def describe_auto_scaling_groups(self, names, max_records):
                return []

        with pytest.raises(RuntimeError, match="not found"):
            AutoScalingGroup("my-asg", EmptyAPI()).get_replicas()

    def test_ambiguous_group_names_the_condition(self):
        class DoubleAPI(FakeAutoscalingAPI):
            def describe_auto_scaling_groups(self, names, max_records):
                return [{"instances": []}, {"instances": []}]

        with pytest.raises(RuntimeError, match="ambiguous"):
            AutoScalingGroup("my-asg", DoubleAPI()).get_replicas()

    def test_api_error_is_transient(self):
        api = FakeAutoscalingAPI(
            want_err=AWSAPIError("throttled", code="ThrottlingException")
        )
        asg = AutoScalingGroup("my-asg", api)
        with pytest.raises(Exception) as e:
            asg.get_replicas()
        assert is_retryable(e.value)
        assert error_code(e.value) == "ThrottlingException"

    def test_non_retryable_code(self):
        api = FakeAutoscalingAPI(
            want_err=AWSAPIError("denied", code="AccessDenied")
        )
        with pytest.raises(Exception) as e:
            AutoScalingGroup("my-asg", api).get_replicas()
        assert not is_retryable(e.value)
        assert error_code(e.value) == "AccessDenied"


# --- MNG: store-observed replicas (reference: managednodegroup.go:86-110) --


def eks_node(name, nodegroup, ready=True, schedulable=True):
    return Node(
        metadata=ObjectMeta(
            name=name, labels={"eks.amazonaws.com/nodegroup": nodegroup}
        ),
        spec=NodeSpec(unschedulable=not schedulable),
        status=NodeStatus(
            allocatable=resource_list(cpu="4", memory="8Gi", pods="16"),
            conditions=[NodeCondition("Ready", "True" if ready else "False")],
        ),
    )


class TestManagedNodeGroup:
    def test_counts_ready_schedulable_labeled_nodes(self):
        store = Store()
        store.create(eks_node("n1", "ng-0b663e8a"))
        store.create(eks_node("n2", "ng-0b663e8a", ready=False))
        store.create(eks_node("n3", "ng-0b663e8a", schedulable=False))
        store.create(eks_node("n4", "other-group"))
        mng = ManagedNodeGroup(MNG_ARN, FakeEKSAPI(), store)
        assert mng.get_replicas() == 1

    def test_set_replicas_targets_cluster_and_group(self):
        api = FakeEKSAPI()
        ManagedNodeGroup(MNG_ARN, api, Store()).set_replicas(3)
        assert api.updated == (
            "ridiculous-sculpture-1594766004",
            "ng-0b663e8a",
            3,
        )


# --- SQS (reference: sqsqueue_test.go:27-64) -------------------------------


class TestSQSQueue:
    def test_length(self):
        api = FakeSQSAPI(
            attributes={"ApproximateNumberOfMessages": "42"}
        )
        assert SQSQueue(SQS_ARN, api).length() == 42

    def test_length_error(self):
        api = FakeSQSAPI(want_err=RuntimeError("didn't work"))
        with pytest.raises(RuntimeError):
            SQSQueue(SQS_ARN, api).length()

    def test_oldest_age_empty_queue_is_zero(self):
        assert SQSQueue(SQS_ARN, FakeSQSAPI()).oldest_message_age_seconds() == 0

    def test_oldest_age_from_sent_timestamp_sampling(self):
        """Beyond the reference (sqsqueue.go:78-80 stubs this at 0): the
        age comes from peeking SentTimestamp with visibility_timeout=0 so
        sampling never consumes or hides messages from real consumers."""
        import time

        now_ms = int(time.time() * 1000)
        api = FakeSQSAPI(
            messages=[
                {"Attributes": {"SentTimestamp": str(now_ms - 90_000)}},
                {"Attributes": {"SentTimestamp": str(now_ms - 240_000)}},
                {"Attributes": {}},  # missing timestamp: skipped
            ]
        )
        age = SQSQueue(SQS_ARN, api).oldest_message_age_seconds()
        assert 239 <= age <= 242  # the OLDEST of the sample, ~240s
        (call,) = api.receive_calls
        assert call[1] == ("SentTimestamp",)
        assert call[3] == 0  # visibility_timeout: a peek, not a consume

    def test_oldest_age_sampling_is_rate_limited(self):
        """ReceiveMessage bumps ApproximateReceiveCount (redrive-policy
        fuel) even at visibility_timeout=0, so the 5s producer tick must
        NOT sample every time: one sample per age_sample_interval, with
        the cached age extrapolated by elapsed time in between."""
        clock = {"now": 1000.0}
        base_ms = int((clock["now"] - 100) * 1000)  # sent 100s ago
        api = FakeSQSAPI(
            messages=[{"Attributes": {"SentTimestamp": str(base_ms)}}]
        )
        queue = SQSQueue(
            SQS_ARN, api, age_sample_interval=60.0,
            clock=lambda: clock["now"],
        )
        assert queue.oldest_message_age_seconds() == 100
        clock["now"] += 30  # inside the interval: no new ReceiveMessage
        assert queue.oldest_message_age_seconds() == 130  # extrapolated
        assert len(api.receive_calls) == 1
        clock["now"] += 31  # past the interval: resample
        assert queue.oldest_message_age_seconds() == 161
        assert len(api.receive_calls) == 2

    def test_oldest_age_fresh_head_still_climbs(self):
        """A message whose sampled age rounds to 0 must still age between
        refreshes — only a sampled EMPTY queue stays pinned at 0 (a
        fresh-but-stuck message is exactly what the signal exists for)."""
        clock = {"now": 1000.0}
        api = FakeSQSAPI(
            messages=[
                {"Attributes": {"SentTimestamp": str(int(1000.0 * 1000))}}
            ]
        )
        queue = SQSQueue(
            SQS_ARN, api, age_sample_interval=60.0,
            clock=lambda: clock["now"],
        )
        assert queue.oldest_message_age_seconds() == 0  # fresh at sample
        clock["now"] += 45  # stuck unconsumed inside the interval
        assert queue.oldest_message_age_seconds() == 45
        assert len(api.receive_calls) == 1

        # sampled-empty stays 0 between refreshes
        clock["now"] += 30  # past the interval: resample, now empty
        api.messages = []
        assert queue.oldest_message_age_seconds() == 0
        clock["now"] += 45
        assert queue.oldest_message_age_seconds() == 0
        assert len(api.receive_calls) == 2

    def test_oldest_age_error_is_wrapped(self):
        api = FakeSQSAPI()
        queue = SQSQueue(SQS_ARN, api)
        queue._url()  # resolve first so the sampling call is what fails
        api.want_err = RuntimeError("throttled")
        with pytest.raises(RuntimeError, match="could not sample"):
            queue.oldest_message_age_seconds()

    def test_oldest_age_flows_to_gauge_and_status(self):
        """End-to-end through the queue producer: status + the
        karpenter_queue_oldest_message_age_seconds gauge."""
        import time

        from karpenter_tpu_torch.api.core import ObjectMeta
        from karpenter_tpu_torch.api.metricsproducer import (
            MetricsProducer,
            MetricsProducerSpec,
        )
        from karpenter_tpu_torch.metrics.producers.queue import QueueProducer
        from karpenter_tpu_torch.metrics.registry import GaugeRegistry

        now_ms = int(time.time() * 1000)
        api = FakeSQSAPI(
            attributes={"ApproximateNumberOfMessages": "7"},
            messages=[{"Attributes": {"SentTimestamp": str(now_ms - 60_000)}}],
        )
        mp = MetricsProducer(
            metadata=ObjectMeta(name="q", namespace="default"),
            spec=MetricsProducerSpec(
                queue=QueueSpec(type=AWS_SQS_QUEUE_TYPE, id=SQS_ARN)
            ),
        )
        registry = GaugeRegistry()
        QueueProducer(mp, SQSQueue(SQS_ARN, api), registry).reconcile()
        assert mp.status.queue.length == 7
        assert 59 <= mp.status.queue.oldest_message_age_seconds <= 62
        gauge = registry.gauge("queue", "oldest_message_age_seconds")
        assert 59 <= gauge.get("q", "default") <= 62

    def test_queue_url_resolved_once(self):
        """The ARN->URL mapping is immutable: polling length repeatedly
        must not re-issue GetQueueUrl each time."""
        api = FakeSQSAPI(attributes={"ApproximateNumberOfMessages": "1"})
        queue = SQSQueue(SQS_ARN, api)
        for _ in range(3):
            assert queue.length() == 1
        assert api.url_calls == 1

    def test_queue_url_cache_spans_polls_via_factory(self):
        """Producers resolve queue_for every tick; the factory must hand
        back the same queue object so the URL cache actually helps."""
        api = FakeSQSAPI(attributes={"ApproximateNumberOfMessages": "1"})
        factory = AWSFactory(Options(store=Store()), sqs_client=api)
        spec = QueueSpec(type=AWS_SQS_QUEUE_TYPE, id=SQS_ARN)
        for _ in range(3):
            assert factory.queue_for(spec).length() == 1
        assert api.url_calls == 1


# --- admission validators + factory dispatch -------------------------------


class TestValidatorsAndFactory:
    def test_asg_spec_validation(self):
        ScalableNodeGroup(
            metadata=ObjectMeta(name="ok"),
            spec=ScalableNodeGroupSpec(
                type=AWS_EC2_AUTO_SCALING_GROUP, id=ASG_ARN
            ),
        ).validate()

    def test_mng_spec_validation_rejects_bad_arn(self):
        sng = ScalableNodeGroup(
            metadata=ObjectMeta(name="bad"),
            spec=ScalableNodeGroupSpec(type=AWS_EKS_NODE_GROUP, id="nope"),
        )
        with pytest.raises(Exception):
            sng.validate()

    def test_sqs_queue_validation(self):
        validate_queue(QueueSpec(type=AWS_SQS_QUEUE_TYPE, id=SQS_ARN))
        with pytest.raises(Exception):
            validate_queue(QueueSpec(type=AWS_SQS_QUEUE_TYPE, id="not-arn"))

    def test_factory_dispatch(self):
        store = Store()
        factory = AWSFactory(
            Options(store=store),
            autoscaling_client=FakeAutoscalingAPI(),
            eks_client=FakeEKSAPI(),
            sqs_client=FakeSQSAPI(),
        )
        asg = factory.node_group_for(
            ScalableNodeGroupSpec(type=AWS_EC2_AUTO_SCALING_GROUP, id="x")
        )
        mng = factory.node_group_for(
            ScalableNodeGroupSpec(type=AWS_EKS_NODE_GROUP, id=MNG_ARN)
        )
        q = factory.queue_for(QueueSpec(type=AWS_SQS_QUEUE_TYPE, id=SQS_ARN))
        assert isinstance(asg, AutoScalingGroup)
        assert isinstance(mng, ManagedNodeGroup)
        assert isinstance(q, SQSQueue)

    def test_unbound_client_fails_with_guidance(self):
        factory = AWSFactory(Options(store=Store()))
        asg = factory.node_group_for(
            ScalableNodeGroupSpec(type=AWS_EC2_AUTO_SCALING_GROUP, id="x")
        )
        with pytest.raises(Exception) as e:
            asg.get_replicas()
        assert "API client bound" in str(e.value.__cause__ or e.value)

    def test_registry_selects_aws(self):
        from karpenter_tpu_torch.cloudprovider.registry import new_factory

        factory = new_factory(Options(store=Store()), provider="aws")
        assert isinstance(factory, AWSFactory)


# --- transient errors keep the resource Active (controller.go:83-95) -------


class TestRetryableThroughController:
    def test_throttle_keeps_sng_active(self):
        store = Store()
        api = FakeAutoscalingAPI(
            want_err=AWSAPIError("throttled", code="ThrottlingException")
        )
        provider = AWSFactory(Options(store=store), autoscaling_client=api)
        runtime = KarpenterRuntime(
            RuntimeOptions(device="cpu"), store=store,
            cloud_provider_factory=provider,
        )
        store.create(
            ScalableNodeGroup(
                metadata=ObjectMeta(name="asg"),
                spec=ScalableNodeGroupSpec(
                    type=AWS_EC2_AUTO_SCALING_GROUP, id="my-asg", replicas=3
                ),
            )
        )
        runtime.manager.reconcile_all()
        sng = store.get("ScalableNodeGroup", "default", "asg")
        conditions = sng.status_conditions()
        active = conditions.get("Active")
        assert active is not None and active.status == "True"
        able = conditions.get("AbleToScale")
        assert able is not None and able.status == "False"

    def test_transient_error_none_passthrough(self):
        assert transient_error(None) is None


class TestNodeTemplates:
    """Scale-from-zero: both AWS node-group kinds surface a NodeTemplate
    when the injected client implements the optional describe hook, with
    EKS-dialect taint enums converted to core/v1."""

    def test_asg_without_hook_returns_none(self):
        group = AutoScalingGroup("my-asg", FakeAutoscalingAPI())
        assert group.template() is None

    def test_unbound_client_reads_as_no_template(self):
        """The no-client-bound default (_NotImplementedClient) has a
        catch-all __getattr__; the optional template hook must still
        read as ABSENT — 'no declared shape', not a per-tick error."""
        from karpenter_tpu_torch.cloudprovider.aws import AWSFactory

        factory = AWSFactory()  # no clients injected
        group = factory.node_group_for(
            type(
                "Spec", (), {"type": "AWSEC2AutoScalingGroup", "id": "asg"}
            )()
        )
        assert group.template() is None

    def test_asg_template_from_hook(self):
        class TemplateAPI(FakeAutoscalingAPI):
            def describe_node_template(self, name):
                assert name == "my-asg"
                return {
                    "allocatable": {"cpu": "8", "memory": "32Gi"},
                    "labels": {"node.kubernetes.io/instance-type": "m5.2xlarge"},
                }

        template = AutoScalingGroup("my-asg", TemplateAPI()).template()
        assert template.allocatable["cpu"].to_float() == 8
        assert (
            template.labels["node.kubernetes.io/instance-type"]
            == "m5.2xlarge"
        )

    def test_mng_template_stamps_group_label_and_converts_taints(self):
        class TemplateAPI(FakeEKSAPI):
            def describe_node_template(self, cluster, nodegroup):
                assert (cluster, nodegroup) == ("cluster", "group")
                return {
                    "allocatable": {"cpu": "4"},
                    "taints": [
                        {"key": "gpu", "value": "true", "effect": "NO_SCHEDULE"}
                    ],
                }

        group = ManagedNodeGroup(
            "arn:aws:eks:us-east-1:1234:nodegroup/cluster/group/uuid",
            TemplateAPI(),
            Store(),
        )
        template = group.template()
        assert template.labels[NODE_GROUP_LABEL] == "group"
        assert [(t.key, t.effect) for t in template.taints] == [
            ("gpu", "NoSchedule")
        ]

    def test_asg_hook_error_classified_like_reads(self):
        """Hook failures flow through transient_error, so an SDK-shaped
        throttle is retryable and keeps the resource Active."""
        from karpenter_tpu_torch.controllers.errors import is_retryable

        class SDKError(RuntimeError):
            code = "Throttling"

        class ThrowingAPI(FakeAutoscalingAPI):
            def describe_node_template(self, name):
                raise SDKError("throttled")

        try:
            AutoScalingGroup("my-asg", ThrowingAPI()).template()
        except Exception as e:  # noqa: BLE001
            assert is_retryable(e)
        else:
            raise AssertionError("expected transient error")


# -- the port's objects against the reference's --------------------------------

import importlib  # noqa: E402

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")


def _mod(package, name):
    return importlib.import_module(f"{package}.{name}")


def _outcome(package, fn):
    """("ok", value) or ("error", type, message, code, retryable), the
    error classified by the package's own taxonomy."""
    errors = _mod(package, "controllers.errors")
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return ("error", type(e).__name__, str(e), errors.error_code(e),
                errors.is_retryable(e))


def _error(package, kind):
    """The scripted error `kind` as `package` would see it: the
    package's own AWSAPIError for coded ones, a builtin otherwise."""
    if kind is None:
        return None
    if kind == "conn":
        return ConnectionError("connection reset")
    return _mod(package, "cloudprovider.aws").AWSAPIError(
        f"{kind} said no", code=kind)


HEALTHY = {"health_status": "Healthy", "lifecycle_state": "InService"}
PENDING = {"health_status": "Healthy", "lifecycle_state": "Pending"}
SICK = {"health_status": "Unhealthy", "lifecycle_state": "InService"}

ASG_SCRIPTS = {
    "settled": ([HEALTHY, HEALTHY], 2, None),
    "converging": ([HEALTHY, PENDING, SICK], 3, None),
    "legacy": ([PENDING], None, None),
    "throttled": ([], None, "ThrottlingException"),
    "denied": ([], None, "AccessDenied"),
    "conn": ([], None, "conn"),
}


class TestParityWithReference:
    """The port's AWS provider objects and the reference's, driven
    through the same call sequence of the same fakes: equal replicas,
    stabilized tuples, templates, API calls, and error codes and
    retryability."""

    @pytest.mark.parametrize("script", sorted(ASG_SCRIPTS))
    def test_auto_scaling_group(self, script):
        instances, desired, err = ASG_SCRIPTS[script]
        got = []
        for package in PACKAGES:
            aws = _mod(package, "cloudprovider.aws")
            api = FakeAutoscalingAPI(instances, _error(package, err))
            if desired is not None:
                real = api.describe_auto_scaling_groups
                api.describe_auto_scaling_groups = (
                    lambda names, max_records, real=real: [
                        dict(g, desired_capacity=desired)
                        for g in real(names, max_records)])
            group = aws.AutoScalingGroup(ASG_ARN, api)
            got.append((
                _outcome(package, group.stabilized),
                _outcome(package, group.get_replicas),
                _outcome(package, lambda: group.set_replicas(4)),
                api.updated,
            ))
        assert got[0] == got[1]

    @pytest.mark.parametrize("err", [None, "ThrottlingException",
                                     "ResourceInUseException", "conn"])
    def test_managed_node_group(self, err):
        got = []
        for package in PACKAGES:
            aws = _mod(package, "cloudprovider.aws")
            core = _mod(package, "api.core")
            store = _mod(package, "store").Store()
            for i, (ready, schedulable) in enumerate(
                    [(True, True), (True, False), (False, True),
                     (True, True)]):
                store.create(core.Node(
                    metadata=core.ObjectMeta(
                        name=f"n{i}",
                        labels={aws.NODE_GROUP_LABEL: "ng-0b663e8a"}),
                    spec=core.NodeSpec(unschedulable=not schedulable),
                    status=core.NodeStatus(
                        allocatable=core.resource_list(cpu="4"),
                        conditions=[core.NodeCondition(
                            "Ready", "True" if ready else "False")]),
                ))
            api = FakeEKSAPI(_error(package, err))
            group = aws.ManagedNodeGroup(MNG_ARN, api, store)
            got.append((
                _outcome(package, group.get_replicas),
                _outcome(package, lambda: group.set_replicas(6)),
                _outcome(package, group.stabilized),
                _outcome(package, lambda: group.template()),
                api.updated,
            ))
        assert got[0] == got[1]

    @pytest.mark.parametrize("err", [None, "ThrottlingException",
                                     "AWS.SimpleQueueService.NonExistentQueue"])
    def test_sqs_queue(self, err):
        got = []
        for package in PACKAGES:
            aws = _mod(package, "cloudprovider.aws")
            api = FakeSQSAPI(
                attributes={"ApproximateNumberOfMessages": "42"},
                messages=[{"Attributes": {"SentTimestamp": "910000"}},
                          {"Attributes": {"SentTimestamp": "700000"}}],
                want_err=_error(package, err))
            queue = aws.SQSQueue(SQS_ARN, api, clock=lambda: 1000.0)
            got.append((
                _outcome(package, queue.name),
                _outcome(package, queue.length),
                _outcome(package, queue.oldest_message_age_seconds),
                api.receive_calls,
            ))
        assert got[0] == got[1]

    @pytest.mark.parametrize("value", [
        ASG_ARN, "my-asg", "", MNG_ARN, SQS_ARN, "arn:aws:eks:x",
        "arn:aws:autoscaling:region:1:autoScalingGroup:u:autoScalingGroupName/",
    ])
    def test_parsers(self, value):
        got = []
        for package in PACKAGES:
            aws = _mod(package, "cloudprovider.aws")
            got.append((
                _outcome(package, lambda: aws.normalize_asg_id(value)),
                _outcome(package, lambda: aws.parse_mng_id(value)),
                _outcome(package, lambda: tuple(
                    vars(aws.parse_arn(value)).values())),
            ))
        assert got[0] == got[1]

    @pytest.mark.parametrize("err", [None, "Throttling", "AccessDenied",
                                     "conn"])
    def test_transient_error(self, err):
        got = []
        for package in PACKAGES:
            aws = _mod(package, "cloudprovider.aws")
            errors = _mod(package, "controllers.errors")
            wrapped = aws.transient_error(_error(package, err))
            got.append(None if wrapped is None else (
                type(wrapped).__name__, str(wrapped),
                errors.error_code(wrapped), errors.is_retryable(wrapped)))
        assert got[0] == got[1]

    def test_factory_dispatch_and_guidance(self):
        got = []
        for package in PACKAGES:
            aws = _mod(package, "cloudprovider.aws")
            sng = _mod(package, "api.scalablenodegroup")
            mp = _mod(package, "api.metricsproducer")
            factory = aws.AWSFactory(_mod(package, "cloudprovider").Options(
                store=_mod(package, "store").Store()))
            row = []
            for kind, id_ in ((sng.AWS_EC2_AUTO_SCALING_GROUP, ASG_ARN),
                              (sng.AWS_EKS_NODE_GROUP, MNG_ARN),
                              ("FakeNodeGroup", "x")):
                group = factory.node_group_for(
                    sng.ScalableNodeGroupSpec(type=kind, id=id_))
                row.append((type(group).__name__,
                            _outcome(package, group.get_replicas),
                            _outcome(package, lambda: group.set_replicas(1))))
            queue = factory.queue_for(mp.QueueSpec(
                type=mp.AWS_SQS_QUEUE_TYPE, id=SQS_ARN))
            row.append((type(queue).__name__,
                        _outcome(package, queue.length)))
            got.append(row)
        assert got[0] == got[1]
