"""TPU pod-slice pool provider: the TPU-native node-group analog of the
reference's AWS providers (managednodegroup.go observation posture, plus a
real Stabilized instead of the reference's TODO-true).

The port's copy of tests/test_tpu_provider.py: the same cases on
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
from karpenter_tpu_torch.api.scalablenodegroup import (
    TPU_POD_SLICE_POOL,
    ScalableNodeGroup,
    ScalableNodeGroupSpec,
)
from karpenter_tpu_torch.cloudprovider import Options
from karpenter_tpu_torch.cloudprovider.tpu import (
    NODE_POOL_LABEL,
    TPU_TOPOLOGY_LABEL,
    TPUFactory,
    TPUPodSlicePool,
    parse_pool_id,
)
from karpenter_tpu_torch.runtime import KarpenterRuntime
from karpenter_tpu_torch.runtime import Options as RuntimeOptions
from karpenter_tpu_torch.store import Store

POOL_ID = "projects/p/locations/us-central2-b/clusters/c/nodePools/train"
POOL_ID_SHORT = "projects/p/locations/us-central2-b/nodePools/train"


class FakeContainerAPI:
    def __init__(self):
        self.sizes = {}
        self.operations = []
        self.want_err = None

    def set_node_pool_size(self, project, location, cluster, pool, size):
        if self.want_err:
            raise self.want_err
        self.sizes[(project, location, cluster, pool)] = size

    def pending_operations(self, project, location, cluster, pool):
        return list(self.operations)


def pool_node(name, pool="train", ready=True, topology=None):
    labels = {NODE_POOL_LABEL: pool}
    if topology:
        labels[TPU_TOPOLOGY_LABEL] = topology
    return Node(
        metadata=ObjectMeta(name=name, labels=labels),
        spec=NodeSpec(),
        status=NodeStatus(
            allocatable=resource_list(cpu="4", memory="8Gi", pods="16"),
            conditions=[NodeCondition("Ready", "True" if ready else "False")],
        ),
    )


class TestParsePoolID:
    def test_full_form(self):
        assert parse_pool_id(POOL_ID) == ("p", "us-central2-b", "c", "train")

    def test_short_form(self):
        assert parse_pool_id(POOL_ID_SHORT) == (
            "p",
            "us-central2-b",
            "",
            "train",
        )

    @pytest.mark.parametrize(
        "bad", ["train", "projects/p/nodePools/x", "projects//locations/l/nodePools/x"]
    )
    def test_invalid(self, bad):
        with pytest.raises(ValueError):
            parse_pool_id(bad)


class TestReplicas:
    def test_counts_ready_single_host_slices(self):
        store = Store()
        store.create(pool_node("n1"))
        store.create(pool_node("n2"))
        store.create(pool_node("n3", ready=False))
        store.create(pool_node("other", pool="serve"))
        pool = TPUPodSlicePool(POOL_ID, FakeContainerAPI(), store)
        assert pool.get_replicas() == 2

    def test_multi_host_slices_count_whole_slices(self):
        store = Store()
        # 2x4 topology = 8 chips = 2 hosts per slice; 3 ready hosts = 1 slice
        for i in range(3):
            store.create(pool_node(f"n{i}", topology="2x4"))
        pool = TPUPodSlicePool(POOL_ID, FakeContainerAPI(), store)
        assert pool.get_replicas() == 1

    def test_set_replicas_actuates_api(self):
        api = FakeContainerAPI()
        TPUPodSlicePool(POOL_ID, api, Store()).set_replicas(4)
        assert api.sizes[("p", "us-central2-b", "c", "train")] == 4

    def test_resize_error_is_retryable(self):
        from karpenter_tpu_torch.controllers.errors import is_retryable

        api = FakeContainerAPI()
        api.want_err = RuntimeError("stockout")
        with pytest.raises(Exception) as e:
            TPUPodSlicePool(POOL_ID, api, Store()).set_replicas(4)
        assert is_retryable(e.value)


class TestStabilized:
    def test_stable_when_no_operations(self):
        pool = TPUPodSlicePool(POOL_ID, FakeContainerAPI(), Store())
        assert pool.stabilized() == (True, "")

    def test_unstable_during_resize(self):
        api = FakeContainerAPI()
        api.operations = ["resize-op-1"]
        stable, message = TPUPodSlicePool(POOL_ID, api, Store()).stabilized()
        assert not stable
        assert "resize-op-1" in message

    def test_pending_operations_error_is_retryable(self):
        """A GKE API blip polling operations must not deactivate the SNG —
        same transient posture as set_replicas resize errors."""
        from karpenter_tpu_torch.controllers.errors import is_retryable

        class ThrowingAPI(FakeContainerAPI):
            def pending_operations(self, project, location, cluster, pool):
                raise RuntimeError("throttled")

        with pytest.raises(Exception) as e:
            TPUPodSlicePool(POOL_ID, ThrowingAPI(), Store()).stabilized()
        assert is_retryable(e.value)


class TestThroughController:
    def test_scale_up_via_controller(self):
        store = Store()
        api = FakeContainerAPI()
        provider = TPUFactory(Options(store=store), container_api=api)
        runtime = KarpenterRuntime(RuntimeOptions(device="cpu"), store=store,
                                   cloud_provider_factory=provider)
        store.create(pool_node("n1"))
        store.create(
            ScalableNodeGroup(
                metadata=ObjectMeta(name="train"),
                spec=ScalableNodeGroupSpec(
                    type=TPU_POD_SLICE_POOL, id=POOL_ID, replicas=3
                ),
            )
        )
        runtime.manager.reconcile_all()
        sng = store.get("ScalableNodeGroup", "default", "train")
        assert sng.status.replicas == 1  # observed from store
        assert api.sizes[("p", "us-central2-b", "c", "train")] == 3
        assert sng.status_conditions().is_happy()

    def test_validation_rejects_bad_pool_id(self):
        sng = ScalableNodeGroup(
            metadata=ObjectMeta(name="bad"),
            spec=ScalableNodeGroupSpec(type=TPU_POD_SLICE_POOL, id="nope"),
        )
        with pytest.raises(Exception):
            sng.validate()


class TestChipsPerHostDerivation:
    def test_v5e_single_host_8_chip_slice(self):
        """A 2x4 v5e slice on ONE 8-chip host must count 1 slice per host,
        not 1 per 2 hosts."""
        from karpenter_tpu_torch.utils.quantity import Quantity

        store = Store()
        for i in range(3):
            n = pool_node(f"n{i}", topology="2x4")
            n.status.allocatable["google.com/tpu"] = Quantity.parse("8")
            store.create(n)
        pool = TPUPodSlicePool(POOL_ID, FakeContainerAPI(), store)
        assert pool.get_replicas() == 3

    def test_v4_multi_host_slice(self):
        from karpenter_tpu_torch.utils.quantity import Quantity

        store = Store()
        # 2x2x4 = 16 chips, 4 chips/host -> 4 hosts per slice; 8 ready
        # hosts -> 2 slices
        for i in range(8):
            n = pool_node(f"n{i}", topology="2x2x4")
            n.status.allocatable["google.com/tpu"] = Quantity.parse("4")
            store.create(n)
        pool = TPUPodSlicePool(POOL_ID, FakeContainerAPI(), store)
        assert pool.get_replicas() == 2


class TestNodeTemplate:
    """Scale-from-zero seam: template() surfaces the pool's declared host
    shape when the bound API exposes node_pool_template; absent that, None
    (live nodes are then the only shape source)."""

    def test_no_template_hook_returns_none(self):
        pool = TPUPodSlicePool(POOL_ID, FakeContainerAPI(), Store())
        assert pool.template() is None

    def test_template_from_api(self):
        class TemplateAPI(FakeContainerAPI):
            def node_pool_template(self, project, location, cluster, pool):
                assert (project, location, cluster, pool) == (
                    "p", "us-central2-b", "c", "train",
                )
                return {
                    "allocatable": {
                        "cpu": "240",
                        "memory": "400Gi",
                        "google.com/tpu": "4",
                    },
                    "labels": {TPU_TOPOLOGY_LABEL: "2x2x4"},
                }

        pool = TPUPodSlicePool(POOL_ID, TemplateAPI(), Store())
        template = pool.template()
        assert template.allocatable["google.com/tpu"].to_float() == 4
        assert template.allocatable["cpu"].to_float() == 240
        # pool label is stamped so selectors over the pool match
        assert template.labels[NODE_POOL_LABEL] == "train"
        assert template.labels[TPU_TOPOLOGY_LABEL] == "2x2x4"

    def test_template_taints_convert_to_core_taints(self):
        """GKE returns taints as dicts with NO_SCHEDULE-style enum
        effects; template() must yield api.core.Taint with core/v1
        effects, or the resolver's attribute access / effect filter
        breaks on exactly the tainted pools TPU pools are."""
        class TaintedAPI(FakeContainerAPI):
            def node_pool_template(self, project, location, cluster, pool):
                return {
                    "allocatable": {"cpu": "240", "google.com/tpu": "4"},
                    "taints": [
                        {
                            "key": "google.com/tpu",
                            "value": "present",
                            "effect": "NO_SCHEDULE",
                        },
                        {
                            "key": "already-core",
                            "effect": "NoExecute",
                        },
                    ],
                }

        pool = TPUPodSlicePool(POOL_ID, TaintedAPI(), Store())
        taints = pool.template().taints
        assert [(t.key, t.value, t.effect) for t in taints] == [
            ("google.com/tpu", "present", "NoSchedule"),
            ("already-core", "", "NoExecute"),
        ]

    def test_template_api_returning_none(self):
        class NoneAPI(FakeContainerAPI):
            def node_pool_template(self, project, location, cluster, pool):
                return None

        pool = TPUPodSlicePool(POOL_ID, NoneAPI(), Store())
        assert pool.template() is None


class TestPubSubQueue:
    """The GCP analog of the reference's SQS queue (sqsqueue.go) — both
    gauges real (the reference stubs message age, sqsqueue.go:78-80)."""

    SUB_ID = "projects/p/subscriptions/work"

    class MetricsAPI:
        def __init__(self, undelivered=0, age=0, err=None):
            self.undelivered, self.age, self.err = undelivered, age, err

        def num_undelivered_messages(self, project, subscription):
            if self.err:
                raise self.err
            assert (project, subscription) == ("p", "work")
            return self.undelivered

        def oldest_unacked_message_age_seconds(self, project, subscription):
            if self.err:
                raise self.err
            return self.age

    def test_reads_depth_and_age(self):
        from karpenter_tpu_torch.cloudprovider.tpu import PubSubSubscriptionQueue

        queue = PubSubSubscriptionQueue(
            self.SUB_ID, self.MetricsAPI(undelivered=41, age=17)
        )
        assert queue.name() == "work"
        assert queue.length() == 41
        assert queue.oldest_message_age_seconds() == 17

    def test_monitoring_blip_is_retryable(self):
        from karpenter_tpu_torch.cloudprovider.tpu import PubSubSubscriptionQueue
        from karpenter_tpu_torch.controllers.errors import is_retryable

        queue = PubSubSubscriptionQueue(
            self.SUB_ID, self.MetricsAPI(err=RuntimeError("deadline"))
        )
        with pytest.raises(Exception) as excinfo:
            queue.length()
        assert is_retryable(excinfo.value)

    def test_invalid_subscription_id_rejected(self):
        from karpenter_tpu_torch.cloudprovider.tpu import (
            PubSubSubscriptionQueue,
            parse_subscription_id,
        )

        with pytest.raises(ValueError):
            parse_subscription_id("not-a-subscription")
        with pytest.raises(ValueError):
            PubSubSubscriptionQueue("projects/p/topics/t", self.MetricsAPI())

    def test_factory_dispatch_and_validator(self):
        from karpenter_tpu_torch.api.metricsproducer import (
            QueueSpec,
            validate_queue,
        )
        from karpenter_tpu_torch.cloudprovider.tpu import (
            GCP_PUBSUB_SUBSCRIPTION,
            PubSubSubscriptionQueue,
            TPUFactory,
        )

        factory = TPUFactory(pubsub_api=self.MetricsAPI(undelivered=3))
        spec = QueueSpec(type=GCP_PUBSUB_SUBSCRIPTION, id=self.SUB_ID)
        queue = factory.queue_for(spec)
        assert isinstance(queue, PubSubSubscriptionQueue)
        assert queue.length() == 3
        validate_queue(spec)  # registered validator accepts
        with pytest.raises(ValueError):
            validate_queue(
                QueueSpec(type=GCP_PUBSUB_SUBSCRIPTION, id="bogus")
            )

    def test_queue_producer_end_to_end(self):
        """A queue MetricsProducer over a Pub/Sub subscription updates
        status + both gauges through the runtime — the reference's SQS
        suite flow (queue/producer.go:30-57) on the GCP provider."""
        from karpenter_tpu_torch.api.core import ObjectMeta
        from karpenter_tpu_torch.api.metricsproducer import (
            MetricsProducer,
            MetricsProducerSpec,
            QueueSpec,
        )
        from karpenter_tpu_torch.cloudprovider.tpu import (
            GCP_PUBSUB_SUBSCRIPTION,
            TPUFactory,
        )
        from karpenter_tpu_torch.runtime import KarpenterRuntime
        from karpenter_tpu_torch.runtime import Options as RuntimeOptions

        factory = TPUFactory(
            pubsub_api=self.MetricsAPI(undelivered=41, age=99)
        )
        runtime = KarpenterRuntime(RuntimeOptions(device="cpu"),
                                   cloud_provider_factory=factory)
        runtime.store.create(
            MetricsProducer(
                metadata=ObjectMeta(name="work"),
                spec=MetricsProducerSpec(
                    queue=QueueSpec(
                        type=GCP_PUBSUB_SUBSCRIPTION, id=self.SUB_ID
                    )
                ),
            )
        )
        runtime.manager.reconcile_all()
        mp = runtime.store.get("MetricsProducer", "default", "work")
        assert mp.status.queue.length == 41
        assert mp.status.queue.oldest_message_age_seconds == 99


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


def _template_tuple(template):
    if template is None:
        return None
    return (
        sorted((k, str(v)) for k, v in template.allocatable.items()),
        sorted(template.labels.items()),
        [(t.key, t.value, t.effect) for t in template.taints],
    )


class ScriptedContainerAPI:
    """One scripted ContainerAPI double per package: the same answers
    and the same raised errors (builtins, so both packages see one
    exception type)."""

    def __init__(self, resize_error=None, pending=(), pending_error=None,
                 template=None, template_error=None, has_template=True):
        self.resize_error = resize_error
        self.pending = list(pending)
        self.pending_error = pending_error
        self.template_raw = template
        self.template_error = template_error
        self.calls = []
        if has_template:
            self.node_pool_template = self._template

    def set_node_pool_size(self, project, location, cluster, pool, size):
        self.calls.append((project, location, cluster, pool, size))
        if self.resize_error is not None:
            raise self.resize_error

    def pending_operations(self, project, location, cluster, pool):
        if self.pending_error is not None:
            raise self.pending_error
        return list(self.pending)

    def _template(self, project, location, cluster, pool):
        if self.template_error is not None:
            raise self.template_error
        return self.template_raw


def _pool_store(package, hosts):
    """A store of `package` holding one TPU host per (name, ready,
    schedulable, topology, chips) of `hosts`, in pool "train"."""
    core = _mod(package, "api.core")
    Quantity = _mod(package, "utils.quantity").Quantity
    store = _mod(package, "store").Store()
    for name, ready, schedulable, topology, chips in hosts:
        labels = {"cloud.google.com/gke-nodepool": "train"}
        if topology:
            labels["cloud.google.com/gke-tpu-topology"] = topology
        allocatable = {"cpu": Quantity.parse("8")}
        if chips:
            allocatable["google.com/tpu"] = Quantity.parse(str(chips))
        store.create(core.Node(
            metadata=core.ObjectMeta(name=name, labels=labels),
            spec=core.NodeSpec(unschedulable=not schedulable),
            status=core.NodeStatus(
                allocatable=allocatable,
                conditions=[core.NodeCondition(
                    "Ready", "True" if ready else "False")],
            ),
        ))
    return store


HOST_SETS = {
    "none": [],
    "single_host_slices": [("a", True, True, "2x2", 4),
                           ("b", True, True, "2x2", 4),
                           ("c", False, True, "2x2", 4)],
    "multi_host_slice": [(f"h{i}", True, True, "4x4", 4) for i in range(7)],
    "v5e_8_chip_hosts": [("a", True, True, "2x4", 8),
                         ("b", True, False, "2x4", 8)],
    "no_chip_resource": [(f"h{i}", True, True, "2x2x2", 0) for i in range(5)],
    "bad_topology": [("a", True, True, "2xq", 4)],
}

SCRIPTS = {
    "ok": dict(),
    "resize_race": dict(resize_error=RuntimeError("operation in progress")),
    "resize_conn": dict(resize_error=ConnectionError("reset")),
    "in_flight": dict(pending=["op-1", "op-2"]),
    "poll_blip": dict(pending_error=TimeoutError("poll timed out")),
    "no_template_hook": dict(has_template=False),
    "template_none": dict(template=None),
    "template": dict(template={
        "allocatable": {"google.com/tpu": "4", "cpu": "112"},
        "labels": {"cloud.google.com/gke-tpu-topology": "2x4"},
        "taints": [{"key": "google.com/tpu", "value": "present",
                    "effect": "NO_SCHEDULE"}],
    }),
    "template_blip": dict(template_error=OSError("api down")),
}

POOL_IDS = (
    "projects/p/locations/us-central2-b/clusters/c/nodePools/train",
    "projects/p/locations/us-central2-b/nodePools/train",
    "projects/p/zones/x/nodePools/train",
    "",
)


class TestParityWithReference:
    """The port's TPU provider objects and the reference's, driven
    through the same call sequence of the same scripted API: equal
    replicas, stabilized tuples, templates, API calls, and error codes
    and retryability."""

    @pytest.mark.parametrize("hosts", sorted(HOST_SETS))
    def test_replicas(self, hosts):
        got = []
        for package in PACKAGES:
            tpu = _mod(package, "cloudprovider.tpu")
            pool = tpu.TPUPodSlicePool(
                POOL_IDS[0], ScriptedContainerAPI(),
                _pool_store(package, HOST_SETS[hosts]))
            got.append(_outcome(package, pool.get_replicas))
        assert got[0] == got[1]

    @pytest.mark.parametrize("script", sorted(SCRIPTS))
    def test_call_sequence(self, script):
        got = []
        for package in PACKAGES:
            tpu = _mod(package, "cloudprovider.tpu")
            api = ScriptedContainerAPI(**SCRIPTS[script])
            pool = tpu.TPUPodSlicePool(POOL_IDS[1], api,
                                       _pool_store(package, []))
            got.append((
                _outcome(package, lambda: pool.set_replicas(5)),
                _outcome(package, pool.stabilized),
                _outcome(package, lambda: _template_tuple(pool.template())),
                api.calls,
            ))
        assert got[0] == got[1]

    @pytest.mark.parametrize("pool_id", POOL_IDS)
    def test_pool_ids(self, pool_id):
        got = [_outcome(p, lambda p=p: _mod(p, "cloudprovider.tpu")
                        .parse_pool_id(pool_id)) for p in PACKAGES]
        assert got[0] == got[1]

    def test_gke_client_over_the_deployment_pools(self):
        """GKEContainerClient of both packages over the Deployment
        world's fake cluster manager: the same templates (chips per
        host from the machine type), resizes and operation filter."""
        from karpenter_tpu_torch import workloads

        got = []
        for package in PACKAGES:
            gke = _mod(package, "cloudprovider.gke_sdk")
            manager = workloads.FakeClusterManager()
            link = ("https://container.googleapis.com/v1/projects/example/"
                    "locations/us-central2-b/clusters//nodePools/")
            manager.operations = [
                types_ns(name="op-a", status=types_ns(name="RUNNING"),
                         target_link=link + "tpu-v5e-2x2"),
                types_ns(name="op-b", status=types_ns(name="DONE"),
                         target_link=link + "tpu-v5e-4x4"),
            ]
            client = gke.GKEContainerClient(manager)
            row = []
            for pool, *_ in workloads.TPU_POOLS:
                row.append(client.node_pool_template(
                    "example", "us-central2-b", "", pool))
                row.append(client.pending_operations(
                    "example", "us-central2-b", "", pool))
                client.set_node_pool_size("example", "us-central2-b", "",
                                          pool, 3)
            got.append((row, manager.take_resizes()))
        assert got[0] == got[1]
        assert got[1][0][0]["allocatable"] == {"google.com/tpu": "4"}
        assert got[1][0][1] == ["op-a"]

    def test_factory_fence_and_fallback(self):
        """The factory's shared fence rejects a superseded generation the
        same way, and a non-TPU spec falls back to not-implemented."""
        got = []
        for package in PACKAGES:
            tpu = _mod(package, "cloudprovider.tpu")
            fence = _mod(package, "recovery.fence")
            sng = _mod(package, "api.scalablenodegroup")
            factory = tpu.TPUFactory(
                _mod(package, "cloudprovider").Options(
                    store=_pool_store(package, [])),
                container_api=ScriptedContainerAPI())
            pool = factory.node_group_for(sng.ScalableNodeGroupSpec(
                type=tpu.TPU_POD_SLICE_POOL, id=POOL_IDS[0]))
            row = [_outcome(package, lambda: pool.set_replicas(
                2, fence.FenceToken(generation=5)))]
            row.append(_outcome(package, lambda: pool.set_replicas(
                2, fence.FenceToken(generation=4))))
            other = factory.node_group_for(sng.ScalableNodeGroupSpec(
                type="FakeNodeGroup", id="x"))
            row.append(_outcome(package, other.get_replicas))
            got.append(row)
        assert got[0] == got[1]
        assert got[1][1][0] == "error"


def types_ns(**kwargs):
    import types

    return types.SimpleNamespace(**kwargs)
