"""The port's device-resident fleet state (karpenter_tpu_torch/solver/
resident.py) against the reference's (karpenter_tpu/solver/resident.py),
on the CPU.

A TwinWorld drives the REAL pipeline of BOTH packages in lockstep: the
same watch-style churn into each package's PendingPodCache, delta
encoding through each package's SnapshotDeltaCache (which publishes the
scatter plans), and dispatch through each package's SolverService with
residency on and the scatter rung forced (the auto gate keeps it off
CPU memory in both packages). Every tick asserts:

  * the port service's outputs equal the reference service's (xla rung)
    and a residency-OFF port service's on the same inputs, all five
    outputs exactly;
  * the port's RESIDENT TENSORS equal pad_to_bucket(cold full encode)
    leaf for leaf, byte for byte — scattering changed rows reproduces
    the full upload exactly — and equal the reference's resident
    buffers byte for byte;
  * both packages report the same serve kind (hit / scatter / rebuild).
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest

from tests.test_torch_encoder import _fresh_state  # noqa: F401 — autouse reset

BUCKETS = 8
PKGS = {"ref": "karpenter_tpu", "port": "karpenter_tpu_torch"}
OUTPUT_FIELDS = (
    "assigned", "assigned_count", "nodes_needed", "lp_bound", "unschedulable"
)


def mod(side, name):
    return importlib.import_module(f"{PKGS[side]}.{name}")


def pod(side, name, cpu="100m", mem="128Mi", selector=None):
    core = mod(side, "api.core")
    q = mod(side, "utils.quantity").Quantity
    return core.Pod(
        metadata=core.ObjectMeta(name=name, namespace="default"),
        spec=core.PodSpec(
            containers=[core.Container(requests={
                "cpu": q.parse(cpu), "memory": q.parse(mem),
            })],
            node_selector=dict(selector or {}),
        ),
        status=core.PodStatus(phase="Pending"),
    )


def make_profiles():
    """Stable profile tuples — reused across ticks, which is what arms
    the delta cache's identity check."""
    return [
        ({"cpu": 8.0, "memory": 32.0 * 1024**3, "pods": 110.0},
         {("zone", "z"), ("group", "a")}, set()),
        ({"cpu": 64.0, "memory": 256.0 * 1024**3, "pods": 110.0},
         {("group", "b")}, set()),
    ]


class Side:
    """One package's encode -> solve pipeline."""

    def __init__(self, side, svc=None):
        self.side = side
        self.cache = mod(side, "store.columnar").PendingPodCache(
            store=None, capacity=64
        )
        self.delta = mod(side, "metrics.producers.pendingcapacity.encoder"
                         ).SnapshotDeltaCache()
        registry = mod(side, "metrics.registry").GaugeRegistry
        service = mod(side, "solver").SolverService
        kwargs = {"device": "cpu"} if side == "port" else {"shard_threshold": 0}
        self.backend = "torch" if side == "port" else "xla"
        self.svc = svc if svc is not None else service(
            registry=registry(), **kwargs
        )
        self.svc._resident.scatter = "always"

    def kinds(self):
        s = self.svc.stats
        return (s.resident_hits, s.resident_scatters, s.resident_rebuilds)


class TwinWorld:
    def __init__(self):
        self.profiles = {"ref": make_profiles(), "port": make_profiles()}
        self.sides = {s: Side(s) for s in PKGS}
        from karpenter_tpu_torch.metrics.registry import GaugeRegistry
        from karpenter_tpu_torch.solver import SolverService

        self.cold = SolverService(
            registry=GaugeRegistry(), device="cpu", resident=False
        )

    def close(self):
        for side in self.sides.values():
            side.svc.close()
        self.cold.close()

    @property
    def port(self):
        return self.sides["port"]

    def upsert(self, name, **kw):
        for s, side in self.sides.items():
            p = pod(s, name, **kw)
            side.cache._upsert((p.metadata.namespace, p.metadata.name), p)

    def remove(self, name):
        for side in self.sides.values():
            side.cache._remove(("default", name))

    def renew_profiles(self):
        self.profiles = {"ref": make_profiles(), "port": make_profiles()}

    def encode(self, s):
        side = self.sides[s]
        return side.delta.encode(side.cache.snapshot(), self.profiles[s])

    def tick(self, expect=None):
        outs, inputs, deltas = {}, {}, {}
        for s, side in self.sides.items():
            inputs[s] = self.encode(s)
            before = side.kinds()
            outs[s] = side.svc.solve(
                inputs[s], buckets=BUCKETS, backend=side.backend
            )
            deltas[s] = tuple(b - a for a, b in zip(before, side.kinds()))
        for name in OUTPUT_FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(outs["port"], name)),
                np.asarray(getattr(outs["ref"], name)), err_msg=name,
            )
        enc = mod("port", "metrics.producers.pendingcapacity.encoder")
        cold_inputs = enc._encode_full(
            self.port.cache.snapshot(), self.profiles["port"]
        )
        cold = self.cold.solve(cold_inputs, buckets=BUCKETS, backend="torch")
        for name in OUTPUT_FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(outs["port"], name)),
                np.asarray(getattr(cold, name)), err_msg=f"cold {name}",
            )
        self._assert_buffers(inputs, cold_inputs)
        assert deltas["port"] == deltas["ref"], deltas
        if expect is not None:
            want = {"hit": (1, 0, 0), "scatter": (0, 1, 0),
                    "rebuild": (0, 0, 1)}[expect]
            assert deltas["port"] == want, (expect, deltas["port"])
        return outs["port"]

    @staticmethod
    def entry_of(svc, inputs):
        with svc._resident._lock:
            for e in svc._resident._entries.values():
                if e.host is inputs:
                    return e
        return None

    def _assert_buffers(self, inputs, cold_inputs):
        """The port's resident tensors byte-equal the padded cold encode
        and the reference's resident buffers."""
        from karpenter_tpu_torch.solver.bucketing import pad_to_bucket

        entry = self.entry_of(self.port.svc, inputs["port"])
        ref_entry = self.entry_of(self.sides["ref"].svc, inputs["ref"])
        assert entry is not None and ref_entry is not None
        assert entry.shape == ref_entry.shape
        padded = pad_to_bucket(cold_inputs, entry.shape[:5])
        for field in dataclasses.fields(padded):
            want = getattr(padded, field.name)
            got = getattr(entry.stacked, field.name)
            ref = getattr(ref_entry.stacked, field.name)
            if want is None or got is None:
                assert want is None and got is None and ref is None, field.name
                continue
            got = got.numpy()[0]
            assert got.dtype == np.asarray(want).dtype, field.name
            assert got.tobytes() == np.asarray(want).tobytes(), field.name
            assert got.tobytes() == np.asarray(ref)[0].tobytes(), field.name


@pytest.fixture
def world():
    w = TwinWorld()
    yield w
    w.close()


class TestResidentChurn:
    def test_unchanged_fleet_is_identity_hit(self, world):
        for i in range(12):
            world.upsert(f"p{i}", cpu=f"{100 + i}m")
        world.tick(expect="rebuild")
        world.tick(expect="hit")
        world.tick(expect="hit")

    def test_five_tick_churn_scatter_equals_cold_upload(self, world):
        """Adds, removes, a resize and a replica of an existing shape
        (weight-only), one per tick: every tick scatters, and every
        tick's resident tensors equal a cold upload byte for byte."""
        for i in range(16):
            world.upsert(f"p{i}", cpu=f"{100 + i}m")
        world.tick(expect="rebuild")
        world.upsert("fresh-a", cpu="900m")
        world.upsert("fresh-b", cpu="901m")
        world.tick(expect="scatter")
        world.remove("p3")
        world.remove("p7")
        world.tick(expect="scatter")
        world.upsert("p4", cpu="750m")
        world.tick(expect="scatter")
        world.upsert("p5-replica", cpu="105m")
        plan = mod("port", "metrics.producers.pendingcapacity.encoder"
                   ).resident_plan(world.encode("port"))
        assert plan is not None and len(plan.weight_rows) >= 1
        world.tick(expect="scatter")
        world.upsert("fresh-c", cpu="902m")
        world.remove("p9")
        world.tick(expect="scatter")

    def test_relabel_within_universe_scatter(self, world):
        for i in range(12):
            world.upsert(f"p{i}", cpu=f"{100 + i}m", selector={"zone": "z"})
        world.upsert("seed", cpu="400m", selector={"group": "a"})
        world.tick(expect="rebuild")
        world.upsert("p5", cpu="105m", selector={"group": "a"})
        world.upsert("p0", cpu="100m", selector={"group": "a"})
        world.tick(expect="scatter")

    def test_group_churn_full_reencode_rebuild(self, world):
        for i in range(10):
            world.upsert(f"p{i}", cpu=f"{100 + i}m")
        world.tick(expect="rebuild")
        world.renew_profiles()
        world.upsert("extra", cpu="500m")
        world.tick(expect="rebuild")

    def test_reset_caches_drops_every_entry(self, world):
        for i in range(10):
            world.upsert(f"p{i}", cpu=f"{100 + i}m")
        world.tick(expect="rebuild")
        world.upsert("fresh", cpu="800m")
        for side in world.sides.values():
            side.svc.reset_caches()
            side.delta.reset()
        assert world.port.svc._resident.resident_bytes() == 0
        world.tick(expect="rebuild")
        world.upsert("fresh-2", cpu="801m")
        world.tick(expect="scatter")

    def test_tenant_chains_keep_separate_entries(self):
        """Two tenants' identity chains on ONE shared service each keep
        their own entry; churn scatters only its own chain."""
        from karpenter_tpu_torch.metrics.registry import GaugeRegistry
        from karpenter_tpu_torch.solver import SolverService

        shared = SolverService(registry=GaugeRegistry(), device="cpu")
        a, b = Side("port", shared), Side("port", shared)
        profiles = make_profiles()

        def tick(side, expect):
            before = side.kinds()
            inputs = side.delta.encode(side.cache.snapshot(), profiles)
            side.svc.solve(inputs, buckets=BUCKETS, backend="torch")
            want = {"hit": (1, 0, 0), "scatter": (0, 1, 0),
                    "rebuild": (0, 0, 1)}[expect]
            assert tuple(x - y for x, y in zip(side.kinds(), before)) == want

        try:
            for i in range(8):
                for side, prefix, base in ((a, "a", 100), (b, "b", 300)):
                    p = pod("port", f"{prefix}{i}", cpu=f"{base + i}m")
                    side.cache._upsert(("default", p.metadata.name), p)
            tick(a, "rebuild")
            tick(b, "rebuild")
            tick(a, "hit")
            tick(b, "hit")
            p = pod("port", "a-new", cpu="950m")
            a.cache._upsert(("default", "a-new"), p)
            tick(a, "scatter")
            tick(b, "hit")
            with shared._resident._lock:
                assert len(shared._resident._entries) == 2
        finally:
            shared.close()


class TestNeverBlock:
    def test_device_failure_drops_residency_and_recovers(self, world):
        for i in range(10):
            world.upsert(f"p{i}", cpu=f"{100 + i}m")
        world.tick(expect="rebuild")
        world.upsert("during-fault", cpu="600m")
        for s, side in world.sides.items():
            faults = mod(s, "faults")
            with faults.injected_faults(seed=7) as reg:
                reg.plan("solver.dispatch", mode="error")
                inputs = world.encode(s)
                out = side.svc.solve(
                    inputs, buckets=BUCKETS, backend=side.backend
                )
            want = mod(s, "ops.numpy_binpack").binpack_numpy(
                inputs, buckets=BUCKETS
            )
            np.testing.assert_array_equal(
                np.asarray(out.assigned), np.asarray(want.assigned)
            )
            assert side.svc._resident.resident_bytes() == 0, s
            assert side.svc.stats.fallbacks == 1, s
        world.upsert("after-fault", cpu="601m")
        world.tick(expect="rebuild")
        world.tick(expect="hit")

    def test_poisoned_plan_falls_back_to_rebuild(self, world):
        for i in range(10):
            world.upsert(f"p{i}", cpu=f"{100 + i}m")
        world.tick(expect="rebuild")
        world.upsert("fresh", cpu="888m")
        for s in PKGS:
            plan = mod(s, "metrics.producers.pendingcapacity.encoder"
                       ).resident_plan(world.encode(s))
            assert plan is not None
            plan.rows = np.asarray([10**6], np.int32)
        world.tick(expect="rebuild")


class TestUnchangedTickSkipsEncodeAndUpload:
    def test_unchanged_tick_zero_encode_zero_upload(self, world):
        for i in range(12):
            world.upsert(f"p{i}", cpu=f"{100 + i}m")
        svc = world.port.svc
        first = world.encode("port")
        svc.solve(first, buckets=BUCKETS, backend="torch")
        fulls = world.port.delta.fulls
        uploads_before = list(svc._stages.get("upload", ()))
        bytes_before = svc.stats.upload_bytes
        again = world.encode("port")
        assert again is first  # zero host encode
        svc.solve(again, buckets=BUCKETS, backend="torch")
        assert world.port.delta.fulls == fulls
        assert svc.stats.resident_hits >= 1
        uploads = list(svc._stages["upload"])
        new = uploads[len(uploads_before):]
        assert new and max(new) == 0.0
        assert svc.stats.upload_bytes == bytes_before  # nothing crossed

    def test_scatter_ships_only_changed_rows(self, world):
        for i in range(40):
            world.upsert(f"p{i}", cpu=f"{100 + i}m")
        world.tick(expect="rebuild")
        svc = world.port.svc
        full = svc.stats.upload_bytes
        world.upsert("fresh", cpu="990m")
        world.tick(expect="scatter")
        scattered = svc.stats.upload_bytes - full
        assert 0 < scattered < full / 4, (scattered, full)

    def test_resident_gauges_exposed(self, world):
        for i in range(8):
            world.upsert(f"p{i}", cpu=f"{100 + i}m")
        world.tick(expect="rebuild")
        world.port.svc.publish_gauges()
        reg = world.port.svc.registry
        assert reg.gauge("solver", "resident_bytes").get("-", "-") > 0
        assert reg.gauge("solver", "resident_rows").get("-", "-") > 0


class TestEntryLifecycle:
    def test_scatter_chain_keeps_one_live_entry(self, world):
        for i in range(10):
            world.upsert(f"p{i}", cpu=f"{100 + i}m")
        world.tick(expect="rebuild")
        resident = world.port.svc._resident
        for k in range(resident.MAX_ENTRIES + 2):
            world.upsert(f"churn-{k}", cpu=f"{500 + k}m")
            world.tick(expect="scatter")
        with resident._lock:
            assert len(resident._entries) == 1

    def test_lru_bounds_distinct_chains(self):
        """More identity chains than MAX_ENTRIES: the least recently used
        entries are evicted, the newest stay."""
        from karpenter_tpu_torch.metrics.registry import GaugeRegistry
        from karpenter_tpu_torch.solver import SolverService

        svc = SolverService(registry=GaugeRegistry(), device="cpu")
        try:
            resident = svc._resident
            chains = []
            for k in range(resident.MAX_ENTRIES + 3):
                side = Side("port", svc)
                p = pod("port", f"t{k}", cpu=f"{100 + k}m")
                side.cache._upsert(("default", p.metadata.name), p)
                inputs = side.delta.encode(side.cache.snapshot(),
                                           make_profiles())
                svc.solve(inputs, buckets=BUCKETS, backend="torch")
                chains.append(inputs)
            with resident._lock:
                hosts = [e.host for e in resident._entries.values()]
            assert len(hosts) == resident.MAX_ENTRIES
            assert hosts == chains[-resident.MAX_ENTRIES:]
        finally:
            svc.close()

    def test_auto_gate_rebuilds_on_cpu_tensors(self, world):
        """The shipped default: on CPU tensors the scatter rung stays OFF
        (scatter ~ upload there), so churn rebuilds — in both packages —
        and identity hits still serve with zero upload."""
        for side in world.sides.values():
            side.svc._resident.scatter = "auto"
        for i in range(10):
            world.upsert(f"p{i}", cpu=f"{100 + i}m")
        world.tick(expect="rebuild")
        world.tick(expect="hit")
        world.upsert("fresh", cpu="900m")
        world.tick(expect="rebuild")
        world.tick(expect="hit")
        with world.port.svc._resident._lock:
            assert len(world.port.svc._resident._entries) == 1
