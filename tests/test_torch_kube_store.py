"""Real-cluster mode in the port (karpenter_tpu_torch/store/kube.py)
against tests/fake_apiserver.py, over real HTTP, on the CPU.

  * the reference's tests/test_kube_store.py classes, run against the
    port's KubeClient / KubeStore / LeaderElector / KarpenterRuntime
    (Options(device="cpu")), with the scale test under the same
    KARPENTER_SCALE_TESTS gate;
  * the informer conformance sweep of tests/test_apiserver_conformance.py
    (the watch contract, and mirror == server after any write sequence,
    across the 410 relist) and tests/test_stress.py's
    TestKubeStoreUnderConcurrency, against the port;
  * parity with the reference: encode_for_write / decode_from_read of
    every kind in a seeded world equal the reference's byte for byte as
    JSON, and the same world seeded into two fakes and ticked 4 times with
    the same churn by the reference's runtime and the port's leaves the
    same MetricsProducer, ScalableNodeGroup and HorizontalAutoscaler
    documents after every tick (exact, less the apiserver's
    resourceVersion, uid and creationTimestamp and the conditions'
    transition times);
  * the port's divergences (store/kube.py docstring): a status patch
    reaches the watchers on the writer's thread, so an event-driven plane
    over the apiserver settles where the reference's re-reconciles every
    patched object forever; a stale watch event cannot move the mirror
    back; observed_version.
"""

import importlib
import os
import time

import pytest

from karpenter_tpu_torch.api import ScalableNodeGroup
from karpenter_tpu_torch.api.core import ObjectMeta
from karpenter_tpu_torch.api.scalablenodegroup import ScalableNodeGroupSpec
from karpenter_tpu_torch.leaderelection import LeaderElector
from karpenter_tpu_torch.store import ConflictError, Scale
from karpenter_tpu_torch.store.kube import KubeClient, KubeStore
from tests.fake_apiserver import FakeApiServer


@pytest.fixture()
def api():
    server = FakeApiServer()
    server.start()
    yield server
    server.stop()


@pytest.fixture()
def kube(api):
    client = KubeClient(base_url=api.url, timeout=5.0)
    store = KubeStore(client, resync_backoff=0.05)
    yield store
    store.close()


def sng(name="group", replicas=None):
    return ScalableNodeGroup(
        metadata=ObjectMeta(name=name, namespace="default"),
        spec=ScalableNodeGroupSpec(
            replicas=replicas, type="FakeNodeGroup", id=name
        ),
    )


def wait_for(predicate, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


class TestCrud:
    def test_create_stamps_callers_object(self, kube):
        """Same contract as the local Store (store.py create/update): the
        caller's object gets the server-assigned identity in place, so
        return-value-ignoring code behaves identically on both stores."""
        obj = sng(replicas=3, name="stamped")
        kube.create(obj)
        assert obj.metadata.uid
        assert obj.metadata.resource_version
        obj.spec.replicas = 4
        kube.update(obj)  # carries the stamped rv: no conflict

    def test_create_echoes_into_mirror(self, kube):
        created = kube.create(sng(replicas=3))
        assert created.metadata.resource_version > 0
        assert wait_for(
            lambda: kube.try_get("ScalableNodeGroup", "default", "group")
            is not None
        )
        got = kube.get("ScalableNodeGroup", "default", "group")
        assert got.spec.replicas == 3

    def test_update_with_stale_rv_conflicts(self, kube):
        created = kube.create(sng(replicas=1))
        fresh = kube.client.get("ScalableNodeGroup", "default", "group")
        fresh.spec.replicas = 5
        kube.update(fresh)
        created.spec.replicas = 9
        with pytest.raises(ConflictError):
            kube.update(created)  # stale resourceVersion must lose

    def test_patch_status_is_merge_patch(self, api, kube):
        kube.create(sng(replicas=2))
        obj = kube.client.get("ScalableNodeGroup", "default", "group")
        obj.status.replicas = 2
        kube.patch_status(obj)
        doc = next(
            d for d in api.objects("scalablenodegroups")
            if d["metadata"]["name"] == "group"
        )
        assert doc["status"]["replicas"] == 2
        assert doc["spec"]["replicas"] == 2  # spec untouched by status patch

    def test_patch_status_deletes_vanished_map_keys(self, api, kube):
        """merge-patch only sets keys, so a reservedCapacity resource entry
        removed locally used to linger upstream forever; the store now
        nulls keys the mirror saw upstream but the local object dropped
        (RFC 7386 deletion)."""
        from karpenter_tpu_torch.api.metricsproducer import (
            MetricsProducer,
            MetricsProducerSpec,
            ReservedCapacitySpec,
        )

        kube.create(
            MetricsProducer(
                metadata=ObjectMeta(name="mp", namespace="default"),
                spec=MetricsProducerSpec(
                    reserved_capacity=ReservedCapacitySpec(
                        node_selector={"group": "a"}
                    )
                ),
            )
        )
        obj = kube.client.get("MetricsProducer", "default", "mp")
        obj.status.reserved_capacity = {
            "cpu": "10.00%, 1/10",
            "memory": "5.00%, 1Gi/20Gi",
        }
        kube.patch_status(obj)
        assert wait_for(
            lambda: "memory"
            in (
                (m := kube.try_get("MetricsProducer", "default", "mp"))
                and m.status.reserved_capacity
                or {}
            )
        )
        obj = kube.client.get("MetricsProducer", "default", "mp")
        obj.status.reserved_capacity = {"cpu": "20.00%, 2/10"}
        kube.patch_status(obj)
        doc = next(
            d
            for d in api.objects("metricsproducers")
            if d["metadata"]["name"] == "mp"
        )
        assert doc["status"]["reservedCapacity"] == {"cpu": "20.00%, 2/10"}

    def test_opaque_string_resource_version_survives_decode(self):
        """k8s resourceVersions are opaque strings per the API conventions;
        a non-numeric rv must decode (mirror only needs equality), not
        kill the informer path with int()."""
        from karpenter_tpu_torch.store.kube import decode_from_read
        from karpenter_tpu_torch.store.store import ADDED, MODIFIED
        from karpenter_tpu_torch.store.store import Store as LocalStore

        doc = {
            "apiVersion": "autoscaling.karpenter.sh/v1alpha1",
            "kind": "ScalableNodeGroup",
            "metadata": {
                "name": "g",
                "namespace": "default",
                "resourceVersion": "0x1f-opaque",
            },
            "spec": {"type": "FakeNodeGroup", "id": "g"},
        }
        obj = decode_from_read(doc)
        assert obj.metadata.resource_version == "0x1f-opaque"
        mirror = LocalStore()
        mirror.apply_event(ADDED, obj)  # must not raise on max()
        echo = decode_from_read(doc)
        mirror.apply_event(MODIFIED, echo)  # equality dedup still works
        assert (
            mirror.get(
                "ScalableNodeGroup", "default", "g"
            ).metadata.resource_version
            == "0x1f-opaque"
        )

    def test_delete_and_watch_removal(self, kube):
        kube.create(sng())
        assert wait_for(
            lambda: kube.try_get("ScalableNodeGroup", "default", "group")
        )
        kube.delete("ScalableNodeGroup", "default", "group")
        assert wait_for(
            lambda: kube.try_get("ScalableNodeGroup", "default", "group")
            is None
        )

    def test_external_writer_visible_through_watch(self, api, kube):
        """Objects created by OTHER clients (kubectl) arrive via watch."""
        api.put_object(
            "scalablenodegroups",
            {
                "apiVersion": "autoscaling.karpenter.sh/v1alpha1",
                "kind": "ScalableNodeGroup",
                "metadata": {"name": "external"},
                "spec": {"type": "FakeNodeGroup", "id": "external"},
            },
        )
        assert wait_for(
            lambda: kube.try_get("ScalableNodeGroup", "default", "external")
            is not None
        )

    def test_scale_subresource(self, kube):
        kube.create(sng(replicas=2))
        scale = kube.get_scale("ScalableNodeGroup", "default", "group")
        assert scale.spec_replicas == 2
        kube.update_scale(
            "ScalableNodeGroup",
            Scale(
                namespace="default", name="group",
                spec_replicas=7, status_replicas=2,
            ),
        )
        assert wait_for(
            lambda: (
                kube.try_get("ScalableNodeGroup", "default", "group") or sng()
            ).spec.replicas == 7
        )

    def test_real_apiserver_pod_dialect_decodes(self, api, kube):
        """Real pods carry fields we don't model + resources.requests
        nesting; the mirror must decode leniently and keep the requests."""
        api.put_object(
            "pods",
            {
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {
                    "name": "real",
                    "creationTimestamp": "2026-07-29T12:00:00Z",
                    "managedFields": [{"manager": "kubelet"}],
                },
                "spec": {
                    "schedulerName": "default-scheduler",
                    "containers": [
                        {
                            "name": "app",
                            "image": "nginx",
                            "resources": {
                                "requests": {"cpu": "250m", "memory": "1Gi"}
                            },
                        }
                    ],
                },
                "status": {"phase": "Pending", "qosClass": "Burstable"},
            },
        )
        assert wait_for(
            lambda: kube.try_get("Pod", "default", "real") is not None
        )
        pod = kube.get("Pod", "default", "real")
        assert pod.requests()["cpu"].to_float() == pytest.approx(0.25)
        assert pod.metadata.creation_timestamp > 1.7e9

    def test_real_apiserver_pod_scheduling_fields_decode(self, api, kube):
        """Affinity (required + preferred), init containers and overhead
        survive the lenient apiserver decode — real scheduler-shaped pods
        feed the solver with full constraint fidelity."""
        api.put_object(
            "pods",
            {
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {"name": "constrained"},
                "spec": {
                    "schedulerName": "default-scheduler",
                    "containers": [
                        {
                            "name": "app",
                            "resources": {"requests": {"cpu": "250m"}},
                        }
                    ],
                    "initContainers": [
                        {
                            "name": "init",
                            "resources": {"requests": {"cpu": "2"}},
                        }
                    ],
                    "overhead": {"memory": "64Mi"},
                    "affinity": {
                        "nodeAffinity": {
                            "requiredDuringSchedulingIgnoredDuringExecution": {
                                "nodeSelectorTerms": [
                                    {
                                        "matchExpressions": [
                                            {
                                                "key": "zone",
                                                "operator": "NotIn",
                                                "values": ["z9"],
                                            }
                                        ]
                                    }
                                ]
                            },
                            "preferredDuringSchedulingIgnoredDuringExecution": [
                                {
                                    "weight": 50,
                                    "preference": {
                                        "matchExpressions": [
                                            {
                                                "key": "disk",
                                                "operator": "Exists",
                                            }
                                        ]
                                    },
                                }
                            ],
                        }
                    },
                },
                "status": {"phase": "Pending"},
            },
        )
        assert wait_for(
            lambda: kube.try_get("Pod", "default", "constrained") is not None
        )
        pod = kube.get("Pod", "default", "constrained")
        from karpenter_tpu_torch.api.core import (
            affinity_shape,
            preference_score,
            preferred_shape,
        )

        assert pod.effective_requests()["cpu"].to_float() == pytest.approx(2)
        assert affinity_shape(pod.spec.affinity) == (
            (("zone", "NotIn", ("z9",)),),
        )
        assert (
            preference_score(
                {"disk": "ssd"}, preferred_shape(pod.spec.affinity)
            )
            == 50
        )


class TestOccupancyOnKube:
    def test_census_fed_by_http_watch(self, api, kube):
        """Existing-pod occupancy over the REAL-cluster path: a bound
        replica arriving through the apiserver watch spends its zone,
        and the pending-pods solve routes the next replica elsewhere —
        the ScheduledOccupancy adoption + watch contract certified
        against HTTP, not just the in-memory store."""
        from karpenter_tpu_torch.metrics.producers.pendingcapacity import (
            group_profile,
            solve_pending,
        )
        from karpenter_tpu_torch.metrics.registry import GaugeRegistry
        from karpenter_tpu_torch.store.columnar import PendingFeed

        zone = "topology.kubernetes.io/zone"
        for z in ("a", "b"):
            api.put_object(
                "nodes",
                {
                    "apiVersion": "v1",
                    "kind": "Node",
                    "metadata": {
                        "name": f"n-{z}",
                        "labels": {"group": z, zone: f"us-{z}"},
                    },
                    "status": {
                        "allocatable": {
                            "cpu": "64",
                            "memory": "64Gi",
                            "pods": "110",
                        },
                        "conditions": [
                            {"type": "Ready", "status": "True"}
                        ],
                    },
                },
            )
            api.put_object(
                "metricsproducers",
                {
                    "apiVersion": "autoscaling.karpenter.sh/v1alpha1",
                    "kind": "MetricsProducer",
                    "metadata": {"name": f"group-{z}"},
                    "spec": {
                        "pendingCapacity": {"nodeSelector": {"group": z}}
                    },
                },
            )

        def pod_doc(name, bound_to=None):
            return {
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {
                    "name": name,
                    "labels": {"app": "db"},
                },
                "spec": {
                    **({"nodeName": bound_to} if bound_to else {}),
                    "containers": [
                        {
                            "name": "c",
                            "resources": {
                                "requests": {
                                    "cpu": "1",
                                    "memory": "1Gi",
                                }
                            },
                        }
                    ],
                    "affinity": {
                        "podAntiAffinity": {
                            "requiredDuringSchedulingIgnoredDuringExecution": [
                                {
                                    "labelSelector": {
                                        "matchLabels": {"app": "db"}
                                    },
                                    "topologyKey": zone,
                                }
                            ]
                        }
                    },
                },
                "status": {
                    "phase": "Running" if bound_to else "Pending"
                },
            }

        api.put_object("pods", pod_doc("db-live", bound_to="n-a"))
        api.put_object("pods", pod_doc("db-pending"))

        feed = PendingFeed(kube, group_profile)
        assert wait_for(lambda: len(feed.pods) == 1)
        assert wait_for(lambda: feed.occupancy.generation >= 1)
        # each kind rides its own watch stream: synchronize on ALL the
        # mirrors the solve reads, not just the pod arena
        assert wait_for(lambda: len(kube.list("MetricsProducer")) == 2)
        assert wait_for(lambda: len(feed.nodes.nodes()) == 2)

        mps = [
            mp
            for mp in kube.list("MetricsProducer")
            if mp.spec.pending_capacity is not None
        ]
        assert len(mps) == 2
        # the default solver is the card: the plain program on the CPU
        import functools

        from karpenter_tpu_torch.ops import binpack

        solve_pending(kube, mps, GaugeRegistry(), feed=feed,
                      solver=functools.partial(binpack.solve, device="cpu"))
        by_name = {
            mp.metadata.name: mp.status.pending_capacity for mp in mps
        }
        # zone a is spent by db-live (seen over HTTP): the pending
        # replica lands in b
        assert by_name["group-a"].pending_pods == 0
        assert by_name["group-b"].pending_pods == 1
        assert by_name["group-b"].unschedulable_pods == 0


class TestDialect:
    def test_strict_manifests_still_reject_resources_nesting(self):
        """Only the apiserver-read (lenient) path accepts the core/v1
        `resources` nesting; user manifests keep the hard error so limits
        are never silently dropped."""
        from karpenter_tpu_torch.api.serialization import from_manifest

        doc = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {"name": "p"},
            "spec": {
                "containers": [
                    {"resources": {"requests": {"cpu": "1"}}}
                ]
            },
        }
        with pytest.raises(ValueError, match="resources"):
            from_manifest(doc)
        pod = from_manifest(doc, lenient=True)
        assert pod.requests()["cpu"].to_float() == 1.0

    def test_resync_echo_does_not_spam_watchers(self, kube):
        """apply_event must drop relist echoes of unchanged objects, or
        every reconnect re-notifies the whole fleet into the feed."""
        kube.create(sng(replicas=1))
        assert wait_for(
            lambda: kube.try_get("ScalableNodeGroup", "default", "group")
        )
        events = []
        kube.watch("ScalableNodeGroup", lambda ev, o: events.append(ev))
        kube._resync("ScalableNodeGroup")  # same rv: no notification
        assert events == []
        kube._resync("ScalableNodeGroup")
        assert events == []


class TestLease:
    def test_leader_election_over_coordination_api(self, kube):
        clock = lambda: 5000.0
        elector = LeaderElector(kube, identity="me", clock=clock)
        assert elector.try_acquire()
        lease = kube.get("Lease", "kube-system", "karpenter-leader")
        assert lease.holder == "me"
        other = LeaderElector(kube, identity="rival", clock=clock)
        assert not other.try_acquire()  # lease held and fresh

    def test_lease_takeover_after_expiry(self, kube):
        t = {"now": 5000.0}
        elector = LeaderElector(kube, identity="a", clock=lambda: t["now"])
        assert elector.try_acquire()
        t["now"] += 1000  # way past lease_duration
        rival = LeaderElector(kube, identity="b", clock=lambda: t["now"])
        assert rival.try_acquire()
        assert kube.get("Lease", "kube-system", "karpenter-leader").holder == "b"


class TestControlPlaneOnKube:
    def test_runtime_converges_through_real_http(self, api, kube):
        """The whole control plane (manager + controllers + feed) running
        against the apiserver protocol: an SNG actuates through the fake
        provider and its status lands back on the apiserver."""
        from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
        from karpenter_tpu_torch.runtime import KarpenterRuntime, Options

        provider = FakeFactory()
        provider.node_replicas["group"] = 5
        clock = {"t": 1000.0}
        runtime = KarpenterRuntime(
            Options(device="cpu"),
            store=kube,
            cloud_provider_factory=provider,
            clock=lambda: clock["t"],
        )
        kube.create(sng(replicas=3))
        assert wait_for(
            lambda: kube.try_get("ScalableNodeGroup", "default", "group")
            is not None
        )
        runtime.manager.reconcile_all()
        # status + conditions written via merge-patch /status
        def happy():
            doc = [
                d for d in api.objects("scalablenodegroups")
                if d["metadata"]["name"] == "group"
            ]
            if not doc:
                return False
            conditions = doc[0].get("status", {}).get("conditions", [])
            return any(
                c["type"] == "Active" and c["status"] == "True"
                for c in conditions
            )
        clock["t"] += 61
        runtime.manager.reconcile_all()
        assert wait_for(happy), api.objects("scalablenodegroups")
        runtime.close()


class TestChunkedList:
    def test_relist_pages_through_continue_tokens(self, api):
        """The mirror's relist uses limit+continue chunking (one giant
        LIST at 100k pods would spike memory on both ends); all pages
        must be gathered and the first page's collection rv kept."""
        from karpenter_tpu_torch.store.kube import KubeClient

        for i in range(23):
            api.put_object(
                "pods",
                {
                    "apiVersion": "v1",
                    "kind": "Pod",
                    "metadata": {"name": f"p{i:02}"},
                    "spec": {"containers": [{"requests": {"cpu": "1"}}]},
                },
            )
        client = KubeClient(base_url=api.url)
        client.list_chunk_size = 10
        before = api.list_pages_served
        objs, rv = client.list("Pod")
        assert len(objs) == 23
        assert sorted(o.metadata.name for o in objs) == [
            f"p{i:02}" for i in range(23)
        ]
        assert api.list_pages_served - before == 3  # 10 + 10 + 3
        assert rv and rv != "0"


class TestArbitraryScaleTargetOnKube:
    """Discovery-based scale-target resolution (reference:
    autoscaler.go:196-237 — GVK->GVR via RESTMapper over discovery).
    Kinds outside the static RESOURCES table resolve through /apis."""

    def deployment_doc(self, name="web", replicas=5):
        return {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas},
            "status": {"replicas": replicas},
        }

    def test_scale_via_explicit_api_version(self, api, kube):
        api.put_object("deployments", self.deployment_doc())
        scale = kube.get_scale(
            "Deployment", "default", "web", api_version="apps/v1"
        )
        assert (scale.spec_replicas, scale.status_replicas) == (5, 5)
        scale.spec_replicas = 9
        kube.update_scale("Deployment", scale, api_version="apps/v1")
        (doc,) = [
            d for d in api.objects("deployments")
            if d["metadata"]["name"] == "web"
        ]
        assert doc["spec"]["replicas"] == 9

    def test_discovery_without_api_version_walks_groups(self, api):
        client = KubeClient(base_url=api.url, timeout=5.0)
        assert client.resolve_kind("Deployment") == (
            "apis/apps/v1", "deployments", True
        )

    def test_unknown_kind_reports_not_served(self, api):
        client = KubeClient(base_url=api.url, timeout=5.0)
        with pytest.raises(Exception, match="not served"):
            client.resolve_kind("FlumeJob", "flume.example.com/v9")

    def test_ha_targeting_deployment_converges(self, api, kube):
        """The whole control plane over HTTP: an HA whose scaleTargetRef
        names a Deployment (apps/v1) resolves via discovery and actuates
        through PUT .../deployments/web/scale."""
        from karpenter_tpu_torch.api.core import ObjectMeta as Meta
        from karpenter_tpu_torch.api.horizontalautoscaler import (
            CrossVersionObjectReference,
            HorizontalAutoscaler,
            HorizontalAutoscalerSpec,
            Metric,
            MetricTarget,
            PrometheusMetricSource,
        )
        from karpenter_tpu_torch.runtime import KarpenterRuntime, Options

        api.put_object("deployments", self.deployment_doc())
        runtime = KarpenterRuntime(Options(device="cpu"), store=kube)
        gauge = runtime.registry.register(
            "reserved_capacity", "cpu_utilization"
        )
        gauge.set("web", "default", 0.85)
        kube.create(
            HorizontalAutoscaler(
                metadata=Meta(name="web", namespace="default"),
                spec=HorizontalAutoscalerSpec(
                    scale_target_ref=CrossVersionObjectReference(
                        api_version="apps/v1", kind="Deployment", name="web"
                    ),
                    min_replicas=1,
                    max_replicas=23,
                    metrics=[
                        Metric(
                            prometheus=PrometheusMetricSource(
                                query=(
                                    "karpenter_reserved_capacity_cpu_"
                                    'utilization{name="web"}'
                                ),
                                target=MetricTarget(
                                    type="Utilization", value=60
                                ),
                            )
                        )
                    ],
                ),
            )
        )
        assert wait_for(
            lambda: kube.try_get("HorizontalAutoscaler", "default", "web")
            is not None
        )
        runtime.manager.reconcile_all()

        def scaled():
            docs = [
                d for d in api.objects("deployments")
                if d["metadata"]["name"] == "web"
            ]
            return docs and docs[0]["spec"]["replicas"] == 8

        assert wait_for(scaled), api.objects("deployments")
        runtime.close()

    def test_same_kind_across_groups_resolves_per_api_version(self, api):
        """Two CRDs may share a kind across API groups; resolution (and
        the memo) must key on (kind, apiVersion), not kind alone."""
        from tests import fake_apiserver as f

        f.API_GROUPS.setdefault("b.example.com", ["v1"])
        f.API_RESOURCES["apis/b.example.com/v1"] = [
            ("widgets", "Deployment", True)
        ]
        try:
            client = KubeClient(base_url=api.url, timeout=5.0)
            assert client.resolve_kind("Deployment", "apps/v1") == (
                "apis/apps/v1", "deployments", True
            )
            # the apps/v1 answer must not be served for b.example.com/v1
            assert client.resolve_kind(
                "Deployment", "b.example.com/v1"
            ) == ("apis/b.example.com/v1", "widgets", True)
        finally:
            f.API_GROUPS.pop("b.example.com", None)
            f.API_RESOURCES.pop("apis/b.example.com/v1", None)

    def test_blind_walk_tolerates_broken_group(self):
        """A stale APIService (503 on its APIResourceList) must not
        poison blind resolution of a kind served by a healthy group —
        the RESTMapper's partial-discovery posture. The broken group is
        walked FIRST, so only the skip keeps resolution alive; with an
        EXPLICIT apiVersion naming the broken group, the failure must
        surface instead."""
        client = KubeClient(base_url="http://127.0.0.1:1", timeout=1.0)

        def fake_request(method, path, *args, **kwargs):
            if path == "apis":
                return {
                    "groups": [
                        {
                            "name": "broken.example.com",
                            "preferredVersion": {
                                "groupVersion": "broken.example.com/v1"
                            },
                            "versions": [
                                {"groupVersion": "broken.example.com/v1"}
                            ],
                        },
                        {
                            "name": "apps",
                            "preferredVersion": {
                                "groupVersion": "apps/v1"
                            },
                            "versions": [{"groupVersion": "apps/v1"}],
                        },
                    ]
                }
            if path == "api/v1":
                return {"resources": []}
            if path == "apis/broken.example.com/v1":
                raise RuntimeError("GET: 503 service unavailable")
            if path == "apis/apps/v1":
                return {
                    "resources": [
                        {
                            "name": "deployments",
                            "kind": "Deployment",
                            "namespaced": True,
                        }
                    ]
                }
            raise AssertionError(f"unexpected discovery GET {path}")

        client._request = fake_request
        assert client.resolve_kind("Deployment") == (
            "apis/apps/v1", "deployments", True
        )
        with pytest.raises(RuntimeError, match="503"):
            client.resolve_kind("Widget", "broken.example.com/v1")


class TestDiscoveryFuzz:
    """Property sweep over randomized discovery documents: resolve_kind
    must honor (kind, apiVersion) addressing, preferred-version order,
    and partial-discovery tolerance for ANY served layout."""

    def _client_for(self, groups, broken):
        """groups: {group: {version: [(plural, kind, namespaced)]}};
        broken: set of 'group/version' whose APIResourceList 500s."""
        client = KubeClient(base_url="http://127.0.0.1:1", timeout=1.0)

        def fake_request(method, path, *args, **kwargs):
            if path == "apis":
                return {
                    "groups": [
                        {
                            "name": g,
                            "preferredVersion": {
                                "groupVersion": f"{g}/{sorted(vs)[0]}"
                            },
                            "versions": [
                                {"groupVersion": f"{g}/{v}"}
                                for v in sorted(vs)
                            ],
                        }
                        for g, vs in groups.items()
                    ]
                }
            if path == "api/v1":
                return {"resources": []}
            assert path.startswith("apis/"), path
            gv = path[len("apis/"):]
            if gv in broken:
                raise RuntimeError(f"GET {path}: 503")
            g, _, v = gv.partition("/")
            entries = groups.get(g, {}).get(v)
            if entries is None:
                from karpenter_tpu_torch.store import NotFoundError

                raise NotFoundError(f"GET {path}: 404")
            return {
                "resources": [
                    {"name": plural, "kind": kind, "namespaced": ns}
                    for plural, kind, ns in entries
                ]
            }

        client._request = fake_request
        return client

    @staticmethod
    def _walk_order(groups):
        """The exact group-version order _discovery_prefixes promises:
        /apis group order, preferred version (sorted(vs)[0] in the fake)
        first within each group."""
        order = []
        for group, versions in groups.items():
            ordered = sorted(versions)
            order.extend(f"{group}/{v}" for v in ordered)
        return order

    def test_fuzzed_layouts(self):
        import random

        from karpenter_tpu_torch.store import NotFoundError

        rng = random.Random(7)
        kinds = ["Widget", "Gadget", "Sprocket", "Deployment"]
        for case in range(60):
            groups = {}
            broken = set()
            # kind -> {group/version: (plural, namespaced)}
            serving = {}
            for g in range(rng.randint(1, 4)):
                group = f"g{g}.example.com"
                versions = {}
                for v in range(rng.randint(1, 3)):
                    version = f"v{v + 1}"
                    entries = []
                    for kind in kinds:
                        if rng.random() < 0.3:
                            # irregular plurals and cluster-scoped kinds
                            # are both legal; the resolver must return
                            # the WIRE values, not conventions
                            plural = kind.lower() + rng.choice(
                                ["s", "es", "-irregular"]
                            )
                            namespaced = rng.random() < 0.5
                            entries.append((plural, kind, namespaced))
                            serving.setdefault(kind, {})[
                                f"{group}/{version}"
                            ] = (plural, namespaced)
                    versions[version] = entries
                    if rng.random() < 0.2:
                        broken.add(f"{group}/{version}")
                groups[group] = versions
            client = self._client_for(groups, broken)
            for kind in kinds:
                served = serving.get(kind, {})
                # explicit apiVersion: exact group-version addressing,
                # echoing the wire plural/namespaced values
                for gv, (plural, namespaced) in sorted(served.items()):
                    if gv in broken:
                        with pytest.raises(RuntimeError, match="503"):
                            client.resolve_kind(kind, gv)
                        continue
                    assert client.resolve_kind(kind, gv) == (
                        f"apis/{gv}", plural, namespaced
                    )
                # blind: the FIRST healthy serving group-version in the
                # documented walk order wins (not just any member)
                expected_gv = next(
                    (
                        gv
                        for gv in self._walk_order(groups)
                        if gv in served and gv not in broken
                    ),
                    None,
                )
                fresh = self._client_for(groups, broken)
                if expected_gv is not None:
                    plural, namespaced = served[expected_gv]
                    assert fresh.resolve_kind(kind) == (
                        f"apis/{expected_gv}", plural, namespaced
                    ), (case, kind)
                else:
                    with pytest.raises(NotFoundError):
                        fresh.resolve_kind(kind)

    def test_miss_is_negative_cached_with_ttl(self, monkeypatch):
        """A misconfigured scaleTargetRef must not re-walk the whole
        discovery surface every reconcile: misses cache for
        DISCOVERY_MISS_TTL, then retry (a late-installed CRD is picked
        up without a restart)."""
        from karpenter_tpu_torch.store import NotFoundError
        from karpenter_tpu_torch.store import kube as kube_mod

        client = KubeClient(base_url="http://127.0.0.1:1", timeout=1.0)
        calls = {"n": 0}
        resources = {"resources": []}

        def fake_request(method, path, *args, **kwargs):
            if path == "apis":
                calls["n"] += 1
                return {"groups": []}
            if path == "api/v1":
                return resources
            raise AssertionError(path)

        client._request = fake_request
        clock = {"t": 1000.0}
        monkeypatch.setattr(
            kube_mod.time, "monotonic", lambda: clock["t"]
        )
        with pytest.raises(NotFoundError):
            client.resolve_kind("Widget")
        assert calls["n"] == 1
        # within the TTL: no new walk, same typed error
        with pytest.raises(NotFoundError, match="cached"):
            client.resolve_kind("Widget")
        assert calls["n"] == 1
        # after the TTL: the walk retries; the now-served kind resolves
        # and clears the miss entry
        clock["t"] += kube_mod.DISCOVERY_MISS_TTL + 1
        resources["resources"] = [
            {"name": "widgets", "kind": "Widget", "namespaced": True}
        ]
        assert client.resolve_kind("Widget") == (
            "api/v1", "widgets", True
        )
        assert ("Widget", "") not in client._discovery_misses

    def test_degraded_walk_is_not_negative_cached(self, monkeypatch):
        """A blind walk that SKIPPED a broken group may have skipped
        exactly the serving one: the miss must NOT enter the negative
        cache, so the next reconcile retries immediately (the r5 review
        case: a momentary aggregated-API 503 must not become a 30 s
        resolution outage)."""
        from karpenter_tpu_torch.store import NotFoundError

        client = KubeClient(base_url="http://127.0.0.1:1", timeout=1.0)
        state = {"healthy": False}

        def fake_request(method, path, *args, **kwargs):
            if path == "apis":
                return {
                    "groups": [
                        {
                            "name": "agg.example.com",
                            "preferredVersion": {
                                "groupVersion": "agg.example.com/v1"
                            },
                            "versions": [
                                {"groupVersion": "agg.example.com/v1"}
                            ],
                        }
                    ]
                }
            if path == "api/v1":
                return {"resources": []}
            assert path == "apis/agg.example.com/v1", path
            if not state["healthy"]:
                raise RuntimeError(f"GET {path}: 503")
            return {
                "resources": [
                    {"name": "widgets", "kind": "Widget", "namespaced": True}
                ]
            }

        client._request = fake_request
        with pytest.raises(NotFoundError, match="skipped"):
            client.resolve_kind("Widget")
        assert ("Widget", "") not in client._discovery_misses
        # the backend recovers: the VERY NEXT resolve succeeds (no TTL)
        state["healthy"] = True
        assert client.resolve_kind("Widget") == (
            "apis/agg.example.com/v1", "widgets", True
        )


@pytest.mark.skipif(
    not os.environ.get("KARPENTER_SCALE_TESTS"),
    reason="50k-object HTTP mirror; battletest sets KARPENTER_SCALE_TESTS=1",
)
class TestMirrorAtScale:
    def test_50k_pod_mirror_syncs_and_converges_after_churn(self, api):
        """The informer mirror at fleet scale over REAL HTTP: a 50k-pod
        initial sync pages through the continue protocol, and a churn
        slab (deletes + adds from another client) converges through the
        watch stream — the mirror equals server state afterward."""

        # seed server-side directly (the load is the protocol, not the
        # fake's put_object lock)
        with api._lock:
            for i in range(50_000):
                api._rv += 1
                doc = {
                    "apiVersion": "v1",
                    "kind": "Pod",
                    "metadata": {
                        "name": f"s{i:05}",
                        "namespace": "default",
                        "resourceVersion": str(api._rv),
                        "uid": f"uid-{i}",
                    },
                    "spec": {
                        "containers": [
                            {
                                "name": "main",
                                "resources": {
                                    "requests": {"cpu": "100m"}
                                },
                            }
                        ]
                    },
                }
                api._objects[("pods", "default", f"s{i:05}")] = doc
        client = KubeClient(base_url=api.url, timeout=30.0)
        store = KubeStore(
            client, watch_kinds=("Pod",), resync_backoff=0.1
        )
        try:
            assert wait_for(
                lambda: len(store.list("Pod")) == 50_000, timeout=60.0
            ), f"mirror stuck at {len(store.list('Pod'))}"
            # churn through the public protocol: 200 deletes + 200 adds
            for i in range(200):
                api.delete_object("pods", "default", f"s{i:05}")
                api.put_object(
                    "pods",
                    {
                        "apiVersion": "v1",
                        "kind": "Pod",
                        "metadata": {"name": f"c{i:03}"},
                        "spec": {
                            "containers": [
                                {
                                    "name": "main",
                                    "resources": {
                                        "requests": {"cpu": "50m"}
                                    },
                                }
                            ]
                        },
                    },
                )

            def converged():
                names = {
                    o.metadata.name for o in store.list("Pod")
                }
                return (
                    len(names) == 50_000
                    and "s00000" not in names
                    and "c000" in names
                    and "c199" in names
                )

            assert wait_for(converged, timeout=60.0)
        finally:
            store.close()


# -- the conformance sweep (tests/test_apiserver_conformance.py) --------------


def pod_doc(name, node=""):
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"nodeName": node},
    }


class TestWatchContract:
    """A watch from rv R delivers exactly the events after R (DELETED
    included), in order; a watch from before the server's history window
    raises ConflictError (the in-stream 410); rv 0 serves current state."""

    def _collect(self, client, since, idle=1.0):
        import threading

        client.timeout = idle  # idle socket timeout ends the one pass
        events = []

        def handler(etype, obj):
            events.append(
                (etype, obj.metadata.name, obj.metadata.resource_version)
            )

        client.watch("Pod", str(since), handler, threading.Event())
        return events

    def test_replay_excludes_seen_and_includes_deletes(self, api):
        from karpenter_tpu_torch.store.store import ADDED, DELETED

        client = KubeClient(base_url=api.url)
        api.put_object("pods", pod_doc("a"))
        seen = api.put_object("pods", pod_doc("b"))
        since = int(seen["metadata"]["resourceVersion"])
        api.put_object("pods", pod_doc("c"))
        api.delete_object("pods", "default", "a")
        events = self._collect(client, since)
        names = [(etype, name) for etype, name, _ in events]
        assert (ADDED, "c") in names
        assert (DELETED, "a") in names
        assert all(name != "b" for _, name in names)
        rvs = [int(rv) for _, _, rv in events]
        assert rvs == sorted(rvs) and all(rv > since for rv in rvs)

    def test_too_old_rv_raises_conflict(self):
        import threading

        fake = FakeApiServer(history_limit=4)
        fake.start()
        try:
            client = KubeClient(base_url=fake.url, timeout=1.0)
            first = fake.put_object("pods", pod_doc("p0"))
            for i in range(1, 10):
                fake.put_object("pods", pod_doc(f"p{i}"))
            with pytest.raises(ConflictError, match="410"):
                client.watch("Pod", first["metadata"]["resourceVersion"],
                             lambda *a: None, threading.Event())
        finally:
            fake.stop()

    def test_fresh_watch_rv_zero_serves_current_state(self, api):
        from karpenter_tpu_torch.store.store import ADDED

        client = KubeClient(base_url=api.url)
        api.put_object("pods", pod_doc("x"))
        api.put_object("pods", pod_doc("y"))
        api.delete_object("pods", "default", "x")
        events = self._collect(client, 0)
        assert [(t, n) for t, n, _ in events] == [(ADDED, "y")]

    def test_client_list_spans_pages_coherently(self, api):
        client = KubeClient(base_url=api.url)
        for i in range(12):
            api.put_object("pods", pod_doc(f"p{i:02d}"))
        client.list_chunk_size = 5
        objs, rv = client.list("Pod")
        assert sorted(o.metadata.name for o in objs) == [
            f"p{i:02d}" for i in range(12)
        ]
        assert int(rv) >= 12


class TestMirrorFuzz:
    """After any write sequence plus quiescence the port's mirror equals
    the server, also across the history horizon (the 410 -> relist path
    of KubeStore._watch_loop)."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_randomized_ops_converge(self, seed):
        import numpy as np

        rng = np.random.default_rng(seed)
        fake = FakeApiServer(history_limit=16)  # tiny window: force 410s
        fake.start()
        store = None
        try:
            store = KubeStore(KubeClient(base_url=fake.url),
                              watch_kinds=("Pod",))
            live = {}
            for step in range(120):
                op = rng.random()
                if op < 0.6 or not live:
                    name = f"p{step}"
                    fake.put_object("pods", pod_doc(name))
                    live[name] = ""
                elif op < 0.8:
                    name = sorted(live)[int(rng.integers(0, len(live)))]
                    fake.put_object("pods", pod_doc(name, node=f"n{step}"),
                                    event="MODIFIED")
                    live[name] = f"n{step}"
                else:
                    name = sorted(live)[int(rng.integers(0, len(live)))]
                    fake.delete_object("pods", "default", name)
                    del live[name]

            def mirrored():
                return {p.metadata.name: p.spec.node_name
                        for p in store.list("Pod")}

            assert wait_for(lambda: mirrored() == live, timeout=10.0)
        finally:
            if store is not None:
                store.close()
            fake.stop()


# -- tests/test_stress.py::TestKubeStoreUnderConcurrency ---------------------


class TestKubeStoreUnderConcurrency:
    def test_concurrent_rest_writers_converge_mirror(self, api):
        """Writers race conflict-retried updates over real HTTP while the
        informer mirror ingests the watch stream; the mirror converges
        exactly to the apiserver's final truth."""
        import threading

        store = KubeStore(KubeClient(base_url=api.url, timeout=5.0),
                          resync_backoff=0.05)
        errors = []
        try:
            for k in range(4):
                store.create(sng(f"g{k}"))

            def writer(wid):
                try:
                    for i in range(40):
                        name = f"g{(wid + i) % 4}"
                        for _ in range(10):  # conflict-retry loop
                            try:
                                obj = store.client.get(
                                    "ScalableNodeGroup", "default", name)
                                obj.spec.replicas = wid * 1000 + i
                                store.update(obj)
                                break
                            except ConflictError:
                                continue
                except Exception as err:  # noqa: BLE001
                    errors.append(err)

            threads = [threading.Thread(target=writer, args=(w,))
                       for w in range(6)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join()
            assert errors == []
            truth = {
                d["metadata"]["name"]: d["spec"].get("replicas")
                for d in api.objects("scalablenodegroups")
            }

            def converged():
                return all(
                    (m := store.try_get("ScalableNodeGroup", "default", n))
                    is not None and m.spec.replicas == want
                    for n, want in truth.items()
                )

            assert wait_for(converged)
        finally:
            store.close()


# -- the port's divergences (store/kube.py docstring) -------------------------


class TestOwnWrites:
    def test_status_patch_reaches_watchers_on_the_writers_thread(self, kube):
        import threading

        kube.create(sng(replicas=2))
        assert wait_for(
            lambda: kube.try_get("ScalableNodeGroup", "default", "group"))
        seen = []
        kube.watch("ScalableNodeGroup", lambda ev, o: seen.append(
            (threading.current_thread(), o.status.replicas,
             o.metadata.resource_version)))
        obj = kube.client.get("ScalableNodeGroup", "default", "group")
        obj.status.replicas = 2
        written = kube.patch_status(obj)
        # delivered before patch_status returned, on this thread
        assert seen == [(threading.current_thread(), 2,
                         written.metadata.resource_version)]
        mirrored = kube.get("ScalableNodeGroup", "default", "group")
        assert mirrored.status.replicas == 2
        time.sleep(0.3)  # the stream's echo has arrived: no second event
        assert len(seen) == 1

    def test_stale_event_does_not_move_the_mirror_back(self, kube):
        from karpenter_tpu_torch.store.kube import decode_from_read
        from karpenter_tpu_torch.store.store import MODIFIED

        kube.create(sng(replicas=2))
        assert wait_for(
            lambda: kube.try_get("ScalableNodeGroup", "default", "group"))
        newer = kube.get("ScalableNodeGroup", "default", "group")
        doc = {
            "apiVersion": "autoscaling.karpenter.sh/v1alpha1",
            "kind": "ScalableNodeGroup",
            "metadata": {"name": "group", "namespace": "default",
                         "resourceVersion": str(
                             newer.metadata.resource_version - 1)},
            "spec": {"type": "FakeNodeGroup", "id": "group", "replicas": 9},
        }
        kube._apply("ScalableNodeGroup", MODIFIED, decode_from_read(doc))
        got = kube.get("ScalableNodeGroup", "default", "group")
        assert got.spec.replicas == 2
        assert kube.observed_version("ScalableNodeGroup") == str(
            newer.metadata.resource_version - 1)

    def test_observed_version_follows_the_stream(self, api, kube):
        assert kube.observed_version("Pod") == "0"  # the empty relist
        written = api.put_object("pods", pod_doc("p"))
        rv = written["metadata"]["resourceVersion"]
        assert wait_for(lambda: kube.observed_version("Pod") == rv)

    def test_counters_count_each_reconcile_once(self, api):
        """Over the apiserver an event-driven runtime's karpenter_runtime_*
        counters equal the same runtime's over the in-process Store that
        holds the same world: its status patches' echoes add no
        reconcile and no event pass."""
        from karpenter_tpu_torch import workloads

        cluster = workloads.build_kube_world([api], 400, 6, 0,
                                             node_groups=2)
        kube = KubeStore(KubeClient(base_url=api.url, timeout=5.0),
                         resync_backoff=0.05)
        counters = []
        try:
            assert len(kube.keys("Pod")) == 400  # the constructor's relist
            self._count_reconciles(cluster, kube, counters)
        finally:
            kube.close()
        assert counters[0] == counters[1]
        assert any('name="MetricsProducer"' in line and line.endswith(" 18.0")
                   for line in counters[1])  # 6 producers x 3 ticks

    @staticmethod
    def _count_reconciles(cluster, kube, counters):
        from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
        from karpenter_tpu_torch.runtime import KarpenterRuntime, Options

        for store in (cluster.store, kube):
            provider = FakeFactory()
            provider.node_replicas.update(cluster.node_replicas)
            clock = {"t": 1000.0}
            runtime = KarpenterRuntime(
                Options(device="cpu", event_driven=True, event_thread=False),
                store=store, cloud_provider_factory=provider,
                clock=lambda: clock["t"])
            try:
                for _ in range(3):
                    clock["t"] += 10.0
                    runtime.manager.reconcile_all()
                    for _ in range(3):
                        time.sleep(0.2)  # the stream's echoes arrive
                        runtime.manager.run_event_pass()
                counters.append([
                    line for line in runtime.registry.expose_text()
                    .splitlines()
                    if line.startswith(("karpenter_runtime_reconciles_total",
                                        "karpenter_runtime_event_pass"))])
            finally:
                runtime.close()

    @pytest.mark.parametrize("package", ["karpenter_tpu",
                                         "karpenter_tpu_torch"])
    def test_event_driven_plane_settles(self, package):
        """An event-driven runtime over the apiserver: after one tick the
        port runs a bounded number of event passes (its status patches do
        not re-dirty their objects), while the reference's informer-thread
        echoes keep re-dirtying every patched object."""
        from karpenter_tpu_torch import workloads

        runtime_mod = importlib.import_module(f"{package}.runtime")
        kube_mod = importlib.import_module(f"{package}.store.kube")
        fake_mod = importlib.import_module(f"{package}.cloudprovider.fake")
        extra = {"device": "cpu"} if package == "karpenter_tpu_torch" else {}
        server = FakeApiServer()
        server.start()
        store = runtime = None
        try:
            cluster = workloads.build_kube_world([server], 300, 4, 0,
                                                 node_groups=1)
            store = kube_mod.KubeStore(
                kube_mod.KubeClient(server.url, timeout=5.0),
                resync_backoff=0.05)
            provider = fake_mod.FakeFactory()
            provider.node_replicas.update(cluster.node_replicas)
            clock = {"t": 1000.0}
            runtime = runtime_mod.KarpenterRuntime(
                runtime_mod.Options(event_driven=True, **extra),
                store=store, cloud_provider_factory=provider,
                clock=lambda: clock["t"])
            runtime.manager.reconcile_all()
            passes = runtime.registry.gauge("runtime", "event_passes_total")
            time.sleep(0.6)
            first = passes.get("manager", "-") or 0.0
            time.sleep(0.6)
            later = passes.get("manager", "-") or 0.0
            if package == "karpenter_tpu_torch":
                assert later == first <= 2
            else:
                assert later > first  # the reference's echo loop
        finally:
            if runtime is not None:
                runtime.close()
            if store is not None:
                store.close()
            server.stop()


# -- parity with the reference -----------------------------------------------

WORLD = dict(pods=2000, types=16, seed=0, node_groups=2)
CHURN = 20
TICKS = 4  # churned ticks after the first
# the clock's step per tick: the longest controller interval (the node
# groups', 60 s), so every object is due every tick on both runtimes. The
# reference re-reconciles an object whose own status patch echoes after
# its requeue (a race between its informer and tick threads); the port,
# whose echo changes nothing, reconciles on its interval
TICK_S = 60.0
PLURALS = ("metricsproducers", "scalablenodegroups", "horizontalautoscalers")
MIRRORED = ("MetricsProducer", "ScalableNodeGroup", "HorizontalAutoscaler")


def reference_kube_api():
    from karpenter_tpu import store as ref_store
    from karpenter_tpu.api import (
        core,
        horizontalautoscaler,
        metricsproducer,
        scalablenodegroup,
        serialization,
    )
    from karpenter_tpu.metrics import registry
    from karpenter_tpu.metrics.producers import pendingcapacity
    from karpenter_tpu.store import columnar
    from karpenter_tpu.utils import quantity
    from karpenter_tpu_torch import workloads

    return workloads.kube_api_namespace({
        "api.core": core,
        "api.horizontalautoscaler": horizontalautoscaler,
        "api.metricsproducer": metricsproducer,
        "api.scalablenodegroup": scalablenodegroup,
        "api.serialization": serialization,
        "metrics.producers.pendingcapacity": pendingcapacity,
        "metrics.registry": registry,
        "store": ref_store,
        "store.columnar": columnar,
        "utils.quantity": quantity,
    })


class TestCodecParity:
    def test_every_kind_encodes_and_decodes_as_the_reference(self):
        import json

        from karpenter_tpu.store import kube as ref_kube
        from karpenter_tpu_torch import workloads
        from karpenter_tpu_torch.store import kube as port_kube

        server = FakeApiServer()  # never started: documents only
        ref_server = FakeApiServer()
        workloads.build_kube_world([server], 300, 8, 1, node_groups=2)
        workloads.build_kube_world([ref_server], 300, 8, 1, node_groups=2,
                                   api=reference_kube_api())
        docs = sorted(server._objects.items())
        assert docs == sorted(ref_server._objects.items())
        kinds = set()
        for (plural, _, _), doc in docs:
            kinds.add(doc["kind"])
            port_obj = port_kube.decode_from_read(json.loads(json.dumps(doc)))
            ref_obj = ref_kube.decode_from_read(json.loads(json.dumps(doc)))
            port_doc = json.dumps(port_kube.encode_for_write(port_obj))
            assert port_doc == json.dumps(ref_kube.encode_for_write(ref_obj))
            assert port_obj.metadata.resource_version == int(
                doc["metadata"]["resourceVersion"])
        assert kinds == set(port_kube.WATCHED_KINDS) - {"Namespace"}


def _tick_parity(runtimes, servers, stores, clock, cluster):
    """Ticks both runtimes over their fakes, TICKS churned ticks after the
    first, and compares the documents after every tick."""
    from karpenter_tpu_torch import workloads

    for t in range(TICKS + 1):
        if t:
            rvs = workloads.churn_apiserver(servers, cluster, CHURN)()
            # the reference's store keeps no observed version: its wait
            # compares every pod's version
            workloads.wait_mirrored(servers[0], stores[0])
            workloads.wait_mirrored(servers[1], stores[1], rvs[1])
        # the last tick's writes (the autoscalers' scale updates echo
        # only through the watch) are in both mirrors before either ticks
        for server, store in zip(servers, stores):
            for kind in MIRRORED:
                workloads.wait_mirrored(server, store, kind=kind)
        clock["t"] += TICK_S
        for runtime in runtimes:
            runtime.manager.reconcile_all()
        for plural in PLURALS:
            want = workloads.server_documents(servers[0], plural)
            got = workloads.server_documents(servers[1], plural)
            assert got == want, (t, plural, {
                k: (got.get(k), v) for k, v in want.items()
                if got.get(k) != v})
            assert want and all("status" in d for d in want.values())


class TestRuntimeParityWithReference:
    def test_four_churned_ticks_write_the_reference_documents(self):
        """The same world in two fakes: the reference's KarpenterRuntime
        (JAX_PLATFORMS=cpu) over its KubeStore and the port's
        (device="cpu") over its own write the same MetricsProducer,
        ScalableNodeGroup and HorizontalAutoscaler documents after the
        first tick and after each of 4 churned ticks. Exact."""
        from karpenter_tpu import runtime as ref_runtime
        from karpenter_tpu.cloudprovider.fake import FakeFactory as RefFake
        from karpenter_tpu.store import kube as ref_kube
        from karpenter_tpu_torch import workloads
        from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
        from karpenter_tpu_torch.runtime import KarpenterRuntime, Options

        servers = [FakeApiServer(), FakeApiServer()]
        stores, runtimes = [], []
        for server in servers:
            server.start()
        try:
            cluster = workloads.build_kube_world(servers, **WORLD)
            stores = [
                ref_kube.KubeStore(ref_kube.KubeClient(servers[0].url,
                                                       timeout=5.0),
                                   resync_backoff=0.05),
                KubeStore(KubeClient(servers[1].url, timeout=5.0),
                          resync_backoff=0.05),
            ]
            providers = [RefFake(), FakeFactory()]
            for provider in providers:
                provider.node_replicas.update(cluster.node_replicas)
            clock = {"t": 1000.0}
            runtimes = [
                ref_runtime.KarpenterRuntime(
                    ref_runtime.Options(), store=stores[0],
                    cloud_provider_factory=providers[0],
                    clock=lambda: clock["t"]),
                KarpenterRuntime(
                    Options(device="cpu"), store=stores[1],
                    cloud_provider_factory=providers[1],
                    clock=lambda: clock["t"]),
            ]
            _tick_parity(runtimes, servers, stores, clock, cluster)
            assert providers[0].node_replicas == providers[1].node_replicas
        finally:
            for runtime in runtimes:
                runtime.close()
            for store in stores:
                store.close()
            for server in servers:
                server.stop()


class TestKubeWorld:
    def test_reference_classes_seed_the_same_documents(self):
        from karpenter_tpu_torch import workloads

        ours, theirs = FakeApiServer(), FakeApiServer()
        a = workloads.build_kube_world([ours], 400, 6, 3, node_groups=2)
        b = workloads.build_kube_world([theirs], 400, 6, 3, node_groups=2,
                                       api=reference_kube_api())
        assert ours._objects == theirs._objects
        assert a.node_replicas == b.node_replicas == {"ng0": 1, "ng1": 1}
        workloads.churn_apiserver([ours], a, 10)()
        workloads.churn_apiserver([theirs], b, 10, api=reference_kube_api())()
        assert ours._objects == theirs._objects
        assert len([k for k in ours._objects if k[0] == "pods"]) == 400

    def test_churn_is_churn_reconciles_draw(self):
        """The apiserver churn deletes and creates exactly the pods
        churn_reconcile does on a Store drawn from the same seed."""
        from karpenter_tpu_torch import workloads
        from karpenter_tpu_torch.api.serialization import to_dict

        server = FakeApiServer()
        kube_world = workloads.build_kube_world([server], 300, 4, 5)
        local = workloads.build_reconcile_cluster(300, 4, 5)
        for _ in range(3):
            workloads.churn_apiserver([server], kube_world, 7)()
            workloads.churn_reconcile(local, 7)()
        want = {p.metadata.name: to_dict(p)["spec"]
                for p in local.store.list("Pod")}
        got = {d["metadata"]["name"]: d["spec"]
               for d in server.objects("pods")}
        assert got == want
