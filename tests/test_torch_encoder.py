"""The port's host encode path against the reference's: the same seeded
cluster, built once into a reference Store and once into a port Store
(each from its own package's classes, by one draw routine that takes the
classes as an argument), must encode to the same BinPackInputs field by
field and byte for byte, on all three solve paths (oracle store.list,
pod_cache, feed) and through a 5-tick churn of the delta cache.

`solve_pending` resolves `encode_snapshot` through its module's globals
at call time; the tests wrap it in each package to record what the
reconcile tick encoded. The port's solves run on the CPU
(`solve(device="cpu")`), the reference's through its numpy backend.

The helpers here (cluster scenarios, the state reset, the recorder) are
shared with tests/test_torch_pendingcapacity.py.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib

import numpy as np
import pytest

from karpenter_tpu_torch import workloads as W

PKGS = {"ref": "karpenter_tpu", "port": "karpenter_tpu_torch"}
PC = "metrics.producers.pendingcapacity"

# the classes the hand-built scenarios need beyond workloads.RECONCILE_API
EXTRA_API = {
    "api.core": ("NodeSpec", "Taint", "Toleration", "resource_list"),
    "constraints.spec": ("ConstraintGroup", "SpreadSpec"),
    "metrics.producers.pendingcapacity": ("encode_snapshot",),
}


@functools.lru_cache(maxsize=None)
def api_of(side: str):
    """workloads.RECONCILE_API plus EXTRA_API, from the reference
    (side 'ref') or the port ('port')."""
    root = PKGS[side]
    modules = {
        name: importlib.import_module(f"{root}.{name}")
        for name in set(W.RECONCILE_API) | set(EXTRA_API)
    }
    api = W.api_namespace(modules)
    for name, attrs in EXTRA_API.items():
        for attr in attrs:
            setattr(api, attr, getattr(modules[name], attr))
    return api


def module(side: str, name: str):
    return importlib.import_module(f"{PKGS[side]}.{name}")


def reset_state() -> None:
    """Module-level state exists once per package: the constraint breaker
    and stats, the delta cache and its resident plans, and in the port the
    solve's reroute counts."""
    for side in PKGS:
        enc = module(side, f"{PC}.encoder")
        enc.reset_constraint_state()
        enc.reset_delta_cache()
    from karpenter_tpu_torch.ops import binpack as TB

    for key in TB.REROUTES:
        TB.REROUTES[key] = 0


@pytest.fixture(autouse=True)
def _fresh_state():
    reset_state()
    yield
    reset_state()


def port_cpu_solver():
    from karpenter_tpu_torch.ops.binpack import solve

    return functools.partial(solve, device="cpu")


def ref_solver(backend: str = "numpy"):
    from karpenter_tpu.ops.binpack import solve

    return functools.partial(solve, backend=backend)


def solver_of(side: str, backend: str = "numpy"):
    return port_cpu_solver() if side == "port" else ref_solver(backend)


class Recorder:
    """Wraps a package's encode_snapshot; keeps (args, kwargs, inputs) of
    every call the reconcile tick makes."""

    def __init__(self, monkeypatch, side: str):
        self.mod = module(side, PC)
        self.inner = self.mod.encode_snapshot
        self.calls = []
        monkeypatch.setattr(self.mod, "encode_snapshot", self)

    def __call__(self, snap, profiles, **kwargs):
        inputs = self.inner(snap, profiles, **kwargs)
        self.calls.append((snap, profiles, kwargs, inputs))
        return inputs


def assert_inputs_identical(got, want, context=""):
    """Every BinPackInputs field equal in None-ness, dtype, shape and
    bytes."""
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if a is None or b is None:
            assert a is None and b is None, f"{context}{name}: None-ness"
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert isinstance(getattr(got, name), np.ndarray), name
        assert a.dtype == b.dtype, f"{context}{name}: {a.dtype} != {b.dtype}"
        assert a.shape == b.shape, f"{context}{name}: {a.shape} != {b.shape}"
        assert a.tobytes() == b.tobytes(), f"{context}{name}: bytes differ"


# -- scenarios ---------------------------------------------------------------


@dataclasses.dataclass
class Cluster:
    store: object
    producers: list
    feed: object
    pod_cache: object
    template_resolver: object = None
    draw: object = None  # the workloads.ReconcileCluster, for churn

    def kwargs(self, path: str) -> dict:
        if path == "feed":
            return {"feed": self.feed}
        if path == "pod_cache":
            return {"pod_cache": self.pod_cache}
        return {}


def _mp(api, name, selector, ref="", constraints=()):
    return api.MetricsProducer(
        metadata=api.ObjectMeta(name=name),
        spec=api.MetricsProducerSpec(
            pending_capacity=api.PendingCapacitySpec(
                node_selector=selector,
                node_group_ref=ref,
                constraints=list(constraints),
            )
        ),
    )


def _node(api, name, labels, cpu, memory, taints=(), extra=None):
    alloc = api.resource_list(cpu=cpu, memory=memory, **(extra or {}))
    return api.Node(
        metadata=api.ObjectMeta(name=name, labels=dict(labels)),
        spec=api.NodeSpec(taints=list(taints)),
        status=api.NodeStatus(
            allocatable=alloc,
            conditions=[api.NodeCondition(type="Ready", status="True")],
        ),
    )


ZONE = "topology.kubernetes.io/zone"


def hand_cluster(api, seed, pods=240, taints=False, gpu=False,
                 template=False, poisoned=False, constraint=False):
    """Six groups of two nodes (zones z0-z2), a pendingCapacity producer
    per group, and `pods` pending pods drawn from `seed`. Options add:
    hard and soft taints with pods tolerating some (taints); a GPU node
    group and GPU pods, one pod asking for a GPU type nobody offers
    (gpu); a scale-from-zero producer with no nodes resolved through a
    template (template); a producer whose selector is None (poisoned);
    one declarative zone-spread constraint group (constraint)."""
    rng = np.random.default_rng(seed)
    store = api.Store()
    feed = api.PendingFeed(store, api.group_profile)
    cache = api.PendingPodCache(store)
    hard = [api.Taint(key="dedicated", value="infra", effect="NoSchedule"),
            api.Taint(key="batch", value="", effect="NoExecute")]
    soft = api.Taint(key="spot", value="yes", effect="PreferNoSchedule")
    for g in range(6):
        node_taints = []
        if taints and g in (1, 4):
            node_taints = [hard[g % 2]]
        if taints and g == 2:
            node_taints = [soft]
        extra = {"nvidia.com/gpu": "4"} if gpu and g == 5 else None
        cores = str(int(rng.choice([4, 8, 16, 32])))
        for k in range(2):
            store.create(_node(
                api, f"n{g}-{k}",
                {"group": f"g{g}", ZONE: f"z{g % 3}",
                 "disk": "ssd" if g % 2 else "hdd"},
                cores, f"{int(cores) * 4}Gi", node_taints, extra,
            ))
    cons = []
    if constraint:
        cons = [api.ConstraintGroup(
            name="web-spread", pod_selector={"tier": "web"},
            spread=api.SpreadSpec(topology_key=ZONE),
        )]
    producers = [
        store.create(_mp(api, f"mp{g}", {"group": f"g{g}"},
                         constraints=cons if g == 0 else ()))
        for g in range(6)
    ]
    resolver = None
    if template:
        producers.append(store.create(
            _mp(api, "mp-zero", {"group": "zero"}, ref="pool-zero")
        ))

        def resolver(namespace, ref):
            if ref != "pool-zero":
                return None
            return ({"cpu": 48.0, "memory": 192.0 * 1024**3, "pods": 110.0},
                    {("group", "zero"), (ZONE, "z1")},
                    {("dedicated", "infra", "NoSchedule")})

    if poisoned:
        producers.append(store.create(_mp(api, "mp-poisoned", None)))

    tolerate = [
        [api.Toleration(key="dedicated", operator="Equal", value="infra",
                        effect="NoSchedule")],
        [api.Toleration(key="batch", operator="Exists")],
        [api.Toleration(operator="Exists")],
    ]
    cpus = ("100m", "500m", "1", "2", "6")
    mems = ("256Mi", "1Gi", "3Gi")
    for i in range(pods):
        requests = {"cpu": api.Quantity.parse(str(rng.choice(cpus))),
                    "memory": api.Quantity.parse(str(rng.choice(mems)))}
        if gpu and rng.random() < 0.15:
            requests["nvidia.com/gpu"] = api.Quantity.parse(
                str(int(rng.integers(1, 3))))
        if gpu and i == 0:
            requests["amd.com/gpu"] = api.Quantity.parse("1")
        tol = []
        if taints and rng.random() < 0.4:
            tol = list(tolerate[int(rng.integers(0, len(tolerate)))])
        selector = {}
        if rng.random() < 0.2:
            selector = {"disk": "ssd"}
        labels = {"app": f"a{int(rng.integers(0, 4))}"}
        if constraint and rng.random() < 0.3:
            labels["tier"] = "web"
        store.create(api.Pod(
            metadata=api.ObjectMeta(name=f"p{i}", labels=labels),
            spec=api.PodSpec(
                containers=[api.Container(requests=requests)],
                node_selector=selector,
                tolerations=tol,
            ),
        ))
    return Cluster(store, producers, feed, cache, resolver)


def draw_cluster(api, pods, types, seed, **fractions):
    c = W.build_reconcile_cluster(pods, types, seed, api=api, **fractions)
    return Cluster(c.store, c.producers, c.feed,
                   api.PendingPodCache(c.store), draw=c)


SCENARIOS = {
    "e2e": lambda api: draw_cluster(api, 2000, 40, 0),
    "mixed": lambda api: draw_cluster(
        api, 2500, 24, 0, affinity=0.3, anti=0.05, spread=0.1),
    "affinity": lambda api: draw_cluster(api, 1200, 16, 1, affinity=0.5),
    "anti": lambda api: draw_cluster(api, 1200, 16, 2, anti=0.2),
    "spread": lambda api: draw_cluster(api, 1200, 32, 3, spread=0.3),
    "taints": lambda api: hand_cluster(api, 4, taints=True),
    "gpu": lambda api: hand_cluster(api, 5, gpu=True),
    "template": lambda api: hand_cluster(api, 6, template=True, taints=True),
    "poisoned": lambda api: hand_cluster(api, 7, poisoned=True),
    "constraint": lambda api: hand_cluster(api, 8, constraint=True),
}


def build_both(scenario: str):
    return {side: SCENARIOS[scenario](api_of(side)) for side in PKGS}


def run_tick(side, cluster, path, solver=None, registry=None):
    api = api_of(side)
    registry = registry if registry is not None else api.GaugeRegistry()
    errors = api.solve_pending(
        cluster.store, cluster.producers, registry,
        solver=solver if solver is not None else solver_of(side),
        template_resolver=cluster.template_resolver,
        **cluster.kwargs(path),
    )
    return errors, registry


# -- tests -------------------------------------------------------------------


class TestEncodeParity:
    @pytest.mark.parametrize("path", ["oracle", "pod_cache", "feed"])
    @pytest.mark.parametrize("scenario", sorted(SCENARIOS))
    def test_encode_equals_reference(self, monkeypatch, scenario, path):
        clusters = build_both(scenario)
        recs = {side: Recorder(monkeypatch, side) for side in PKGS}
        for side in PKGS:
            run_tick(side, clusters[side], path)
        assert len(recs["port"].calls) == len(recs["ref"].calls) == 1
        got = recs["port"].calls[0][3]
        want = recs["ref"].calls[0][3]
        assert_inputs_identical(got, want, f"{scenario}/{path}: ")

    def test_scenarios_reach_their_operands(self, monkeypatch):
        """The scenarios exercise what they are named for: extended
        resources widen R, the mixed draw carries the forbidden, score
        and exclusive operands, the constraint group its spread operands,
        the poisoned producer an error."""
        seen = {}
        for scenario in ("mixed", "gpu", "constraint", "poisoned",
                         "taints", "template"):
            rec = Recorder(monkeypatch, "port")
            cluster = SCENARIOS[scenario](api_of("port"))
            errors, _ = run_tick("port", cluster, "feed")
            seen[scenario] = (rec.calls[-1][3], errors)
            monkeypatch.undo()
            reset_state()
        mixed = seen["mixed"][0]
        assert mixed.pod_group_forbidden is not None
        assert mixed.pod_group_score is not None
        assert mixed.pod_exclusive is not None
        assert seen["gpu"][0].pod_requests.shape[1] == 8  # cpu mem 2 gpus pods
        assert seen["constraint"][0].pod_spread_slot is not None
        assert seen["taints"][0].pod_intolerant.any()
        # the scale-from-zero row takes the template's shape and taint
        template = seen["template"][0]
        (row,) = np.flatnonzero(template.group_allocatable[:, 0] == 48.0)
        assert template.group_taints[row].any()
        errors = seen["poisoned"][1]
        assert errors[("default", "mp-poisoned")] is not None
        assert sum(e is not None for e in errors.values()) == 1


class TestDeltaChurn:
    def test_five_tick_churn(self, monkeypatch):
        """Five churned ticks through the feed and the delta cache: each
        tick's encode equals the reference's and the port's own full
        re-encode; an unchanged tick re-uses the previous inputs object."""
        from karpenter_tpu_torch.metrics.producers.pendingcapacity import (
            encoder as port_encoder,
        )

        clusters = build_both("e2e")
        recs = {side: Recorder(monkeypatch, side) for side in PKGS}
        for side in PKGS:
            run_tick(side, clusters[side], "feed")
        deltas0 = port_encoder._default_delta.deltas
        for tick in range(5):
            for side in PKGS:
                W.churn_reconcile(clusters[side].draw, 40)()
                run_tick(side, clusters[side], "feed")
            snap, profiles, kwargs, got = recs["port"].calls[-1]
            want = recs["ref"].calls[-1][3]
            assert_inputs_identical(got, want, f"tick {tick}: ")
            full = port_encoder._encode_full(snap, profiles, **kwargs)
            assert_inputs_identical(got, full, f"tick {tick} full: ")
        assert port_encoder._default_delta.deltas - deltas0 == 5
        assert len(recs["port"].calls) == len(recs["ref"].calls) == 6

        # unchanged tick: the feed memo hands back the same inputs object
        # without encoding, and the delta cache returns the same object
        # for an unchanged dedup set
        port = clusters["port"]
        last = port.feed.encode_memo[1]
        run_tick("port", port, "feed")
        assert len(recs["port"].calls) == 6
        assert port.feed.encode_memo[1] is last
        snap, profiles, kwargs, _ = recs["port"].calls[-1]
        again = recs["port"].inner(snap, profiles, **kwargs)
        assert again is last
