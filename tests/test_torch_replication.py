"""The port's replicated control plane (karpenter_tpu_torch/replication,
`--partitions`, /debug/replicas, `--simulate --failover`) against the
reference's (karpenter_tpu/replication), on the CPU.

tests/test_failover.py's classes run on both packages where they repeat
(clock discipline, split brain, partitions and rendezvous, partition
leases, tenant handoff, the plane, the failover world, the
single-replica path, /debug/replicas). Parity with the reference:

  * partition_of and rendezvous_rank on 10,000 tenant ids at partitions
    1, 2, 7, 16 and 64, and for 1-8 replicas;
  * simulate_failover's report at seed 20260807, key for key, and its
    writes_digest at bench-failover's width (256 tenants x 4 replicas x
    16 partitions x 40 ticks; BASELINE.json's pinned digest);
  * two KarpenterRuntime replicas of each package over one store
    (workloads.ReplicaFleet), the bigger owner killed: equal ownership,
    adoptions, fence generations and karpenter_replica_* /
    karpenter_handoff_* series, tick by tick.

The plane is host code: it runs no device program. A replicated runtime
on the default device raises without a card before any Lease is written.
"""

from __future__ import annotations

import importlib
import json
import os
import urllib.request

import pytest

from karpenter_tpu_torch import workloads

REF, PORT = "karpenter_tpu", "karpenter_tpu_torch"
PACKAGES = (REF, PORT)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAILOVER_SEED = 20260807
# bench-failover's width (Makefile bench-failover) and BASELINE.json's
# published digest of it
BENCH_WIDTH = dict(tenants=256, replicas=4, partitions=16, ticks=40, seed=0)
BENCH_DIGEST = (
    "0ffab1567ef410bda2ba3e9ae58ab63d2ecaafdd06cdba931a9be850d2f4969b"
)


def mod(package: str, name: str):
    return importlib.import_module(f"{package}.{name}")


@pytest.fixture(autouse=True)
def _no_leaked_registry():
    yield
    for package in PACKAGES:
        mod(package, "faults").uninstall()


class FakeClock:
    def __init__(self, start=1000.0):
        self.now = start

    def __call__(self):
        return self.now

    def advance(self, seconds):
        self.now += seconds


def elector(package, store, identity, clock, **kw):
    return mod(package, "leaderelection").LeaderElector(
        store, identity=identity, clock=clock, **kw
    )


def store_of(package):
    return mod(package, "store").Store()


# -- clock discipline, split brain ------------------------------------------


@pytest.mark.parametrize("package", PACKAGES)
class TestClockDiscipline:
    def test_backward_wall_step_cannot_extend_stale_lease(self, package):
        R = mod(package, "replication")
        store, wall = store_of(package), FakeClock(1000.0)
        holder = elector(package, store, "a", wall, lease_duration=5.0)
        assert holder.try_acquire()
        mono = FakeClock(0.0)
        candidate = elector(
            package, store, "b", R.SkewedClock(wall, offset_s=-30.0),
            monotonic=mono, lease_duration=5.0,
        )
        assert not candidate.try_acquire()
        mono.advance(4.0)
        assert not candidate.try_acquire()
        mono.advance(3.0)
        assert candidate.try_acquire()
        assert candidate.is_leader()

    @pytest.mark.parametrize("offset,steals", [(5.5, False), (7.0, True)])
    def test_forward_step_steals_only_past_the_margin(self, package, offset,
                                                      steals):
        R = mod(package, "replication")
        store, wall = store_of(package), FakeClock(1000.0)
        holder = elector(package, store, "a", wall, lease_duration=5.0)
        candidate = elector(
            package, store, "b", R.SkewedClock(wall, offset_s=offset),
            monotonic=FakeClock(0.0), lease_duration=5.0,
        )
        assert holder.try_acquire()
        if steals:
            assert candidate.try_acquire()
            return
        for _ in range(20):
            wall.advance(2.0)
            assert holder.try_acquire()
            assert not candidate.try_acquire()
        assert holder.is_leader()

    def test_own_leadership_lapses_on_monotonic_clock(self, package):
        store, wall, mono = store_of(package), FakeClock(), FakeClock(0.0)
        holder = elector(package, store, "a", wall, monotonic=mono,
                         lease_duration=5.0)
        assert holder.try_acquire() and holder.is_leader()
        mono.advance(6.0)
        assert not holder.is_leader()

    def test_release_allows_immediate_takeover(self, package):
        store, clock = store_of(package), FakeClock()
        a = elector(package, store, "a", clock, lease_duration=15.0)
        b = elector(package, store, "b", clock, lease_duration=15.0)
        assert a.try_acquire()
        assert not b.try_acquire()
        a.release()
        assert b.try_acquire() and b.is_leader()

    def test_skewed_clock_steps(self, package):
        clock = mod(package, "replication").SkewedClock(lambda: 100.0, 2.0)
        assert clock() == 102.0
        clock.step(-5.0)
        assert clock() == 97.0


@pytest.mark.parametrize("package", PACKAGES)
class TestSplitBrainRegression:
    def test_stale_resource_version_loses_the_cas(self, package):
        ConflictError = mod(package, "store.store").ConflictError
        store, clock = store_of(package), FakeClock()
        old = elector(package, store, "old", clock, lease_duration=5.0)
        new = elector(package, store, "new", clock, lease_duration=5.0)
        assert old.try_acquire()
        clock.advance(7.0)
        stale = store.try_get("Lease", old.namespace, old.name)
        assert new.try_acquire()
        stale.holder = "old"
        stale.renew_time = clock()
        with pytest.raises(ConflictError):
            store.update(stale)
        assert new.is_leader()
        assert not old.try_acquire()

    def test_loser_actuation_fence_rejected_and_recorded(self, package,
                                                         tmp_path):
        R = mod(package, "replication")
        fence = mod(package, "recovery.fence")
        obs = mod(package, "observability")
        fr = mod(package, "observability.flightrecorder")
        journal_dir = str(tmp_path / "tenant")
        validator = fence.FenceValidator()
        clock = FakeClock()
        deposed = R.TenantHandoff("t0", journal_dir=journal_dir,
                                  validator=validator, clock=clock)
        winner = R.TenantHandoff("t0", journal_dir=journal_dir,
                                 validator=validator, clock=clock)
        assert (deposed.generation, winner.generation) == (1, 2)
        saved = fr.default_flight_recorder()
        recorder = fr.reset_default_flight_recorder()
        try:
            with obs.default_tracer().trace("reconcile-deposed") as span:
                loser_trace = span.trace_id
                with pytest.raises(fence.FenceRejectedError) as err:
                    validator.admit(deposed.token())
                assert err.value.code == "FenceRejected"
                deposed.recovery.count_fence_rejection()
            events = recorder.events(kind="fence_rejection")
            assert len(events) == 1
            assert events[0]["generation"] == 1
            assert loser_trace in events[0]["trace_ids"]
        finally:
            fr.set_default_flight_recorder(saved)
            deposed.release()
            winner.release()
        validator.admit(winner.token())


# -- partitions and rendezvous ------------------------------------------------

TENANT_IDS = [f"tenant-{i:05d}" for i in range(10_000)]


class TestPartitionsAndRendezvous:
    @pytest.mark.parametrize("partitions", [1, 2, 7, 16, 64])
    def test_partition_of_equals_the_reference(self, partitions):
        ref = mod(REF, "replication").partition_of
        port = mod(PORT, "replication").partition_of
        got = [port(t, partitions) for t in TENANT_IDS]
        assert got == [ref(t, partitions) for t in TENANT_IDS]
        assert all(0 <= p < partitions for p in got)
        if partitions > 1:
            assert len(set(got)) == partitions

    @pytest.mark.parametrize("replicas", range(1, 9))
    def test_rendezvous_rank_equals_the_reference(self, replicas):
        ref = mod(REF, "replication").rendezvous_rank
        port = mod(PORT, "replication").rendezvous_rank
        ids = [f"replica-{i}" for i in range(replicas)]
        for partition in range(64):
            rank = port(partition, ids)
            assert rank == ref(partition, ids)
            assert sorted(rank) == sorted(ids)
            assert rank == port(partition, list(reversed(ids)))

    def test_digest_is_blake2b_8_big_endian(self):
        import hashlib

        P = mod(PORT, "replication.partitions")
        digest = hashlib.blake2b(b"tenant:x", digest_size=8).digest()
        assert P._digest("tenant:x") == int.from_bytes(digest, "big")
        assert P._digest("p3@r0") == mod(
            REF, "replication.partitions")._digest("p3@r0")

    def test_partition_of_rejects_nonpositive(self):
        with pytest.raises(ValueError):
            mod(PORT, "replication").partition_of("t", 0)

    def test_rendezvous_minimal_disruption(self):
        rank = mod(PORT, "replication").rendezvous_rank
        replicas = ["r0", "r1", "r2", "r3"]
        tops = {p: rank(p, replicas)[0] for p in range(64)}
        survivors = [r for r in replicas if r != "r1"]
        for p, top in tops.items():
            if top != "r1":
                assert rank(p, survivors)[0] == top


# -- partition leases ----------------------------------------------------------


def lease_managers(package, ids, partitions=6):
    R = mod(package, "replication")
    store, clock = store_of(package), FakeClock()
    return store, clock, [
        R.PartitionLeaseManager(store, replica_id=rid, partitions=partitions,
                                lease_duration=5.0, clock=clock)
        for rid in ids
    ]


def rounds(clock, managers, n):
    for _ in range(n):
        clock.advance(1.0)
        for m in managers:
            m.round()


@pytest.mark.parametrize("package", PACKAGES)
class TestPartitionLeases:
    def test_single_replica_owns_everything(self, package):
        _, clock, (m,) = lease_managers(package, ["a"])
        m.round()
        clock.advance(1.0)
        round_ = m.round()
        assert round_.owned == set(range(6))
        assert round_.live == ["a"]

    def test_two_replicas_partition_disjointly(self, package):
        _, clock, (a, b) = lease_managers(package, ["a", "b"])
        rounds(clock, [a, b], 3)
        assert a.owned | b.owned == set(range(6))
        assert not (a.owned & b.owned)
        assert a.owned and b.owned

    def test_ownership_sticky_when_a_replica_joins(self, package):
        store, clock, (a,) = lease_managers(package, ["a"])
        rounds(clock, [a], 2)
        before = set(a.owned)
        assert before == set(range(6))
        c = mod(package, "replication").PartitionLeaseManager(
            store, replica_id="c", partitions=6, lease_duration=5.0,
            clock=clock)
        rounds(clock, [a, c], 3)
        assert a.owned == before
        assert not c.owned

    def test_dead_replica_partitions_adopted_after_expiry(self, package):
        _, clock, (a, b) = lease_managers(package, ["a", "b"])
        rounds(clock, [a, b], 3)
        assert a.owned
        clock.advance(7.0)
        rounds(clock, [b], 2)
        assert b.owned == set(range(6))
        assert b.live_replicas() == ["b"]

    def test_release_all_hands_over_without_expiry_wait(self, package):
        _, clock, (a, b) = lease_managers(package, ["a", "b"])
        rounds(clock, [a, b], 3)
        a.release_all()
        rounds(clock, [b], 2)
        assert b.owned == set(range(6))

    def test_holder_of_reads_the_store(self, package):
        _, clock, (a, b) = lease_managers(package, ["a", "b"])
        rounds(clock, [a, b], 3)
        for p in range(6):
            assert a.holder_of(p) == ("a" if p in a.owned else "b")

    def test_nonpositive_partitions_rejected(self, package):
        with pytest.raises(ValueError):
            mod(package, "replication").PartitionLeaseManager(
                store_of(package), replica_id="a", partitions=0)


class TestLeaseRoundsEqualTheReference:
    """Three replicas join one at a time, one releases, one dies: every
    round's LeaseRound and every Lease in the store are the reference's."""

    @staticmethod
    def script(package):
        R = mod(package, "replication")
        store, clock = store_of(package), FakeClock()

        def manager(rid):
            return R.PartitionLeaseManager(
                store, replica_id=rid, partitions=7, lease_duration=5.0,
                clock=clock)

        managers = {"a": manager("a")}
        trail = []
        for step in range(14):
            clock.advance(1.5)
            if step == 2:
                managers["b"] = manager("b")
            if step == 4:
                managers["c"] = manager("c")
            if step == 7:
                managers.pop("a").release_all()
            if step == 9:
                managers.pop("b")  # dies: its leases lapse
            for rid, m in sorted(managers.items()):
                r = m.round()
                trail.append((step, rid, sorted(r.owned), sorted(r.gained),
                              sorted(r.lost), r.live, r.failures))
        leases = sorted(
            (lease.metadata.name, lease.holder, lease.renew_time)
            for lease in store.list("Lease")
        )
        return trail, leases

    def test_rounds_and_leases(self):
        assert self.script(PORT) == self.script(REF)


# -- tenant handoff --------------------------------------------------------------


@pytest.mark.parametrize("package", PACKAGES)
class TestTenantHandoff:
    def test_unfenced_warmup_gates_disruption(self, package):
        h = mod(package, "replication").TenantHandoff("t", warmup_ticks=2)
        assert (h.state, h.ready(), h.allow_disruption()) == (
            "warmup", False, False)
        h.on_tick()
        assert not h.ready()
        h.on_tick()
        assert (h.state, h.ready(), h.allow_disruption()) == (
            "serving", True, True)
        assert h.token() is None and h.generation == 0
        h.release()
        assert (h.state, h.ready()) == ("released", False)

    def test_fenced_adoption_replays_predecessor_intent(self, package,
                                                        tmp_path):
        R = mod(package, "replication")
        key_str = mod(package, "recovery.journal").key_str
        journal_dir = str(tmp_path / "tenant")
        first = R.TenantHandoff("t", journal_dir=journal_dir)
        first.recovery.handle("intent").set(("t",), {"desired": 7})
        first.release()
        second = R.TenantHandoff("t", journal_dir=journal_dir)
        try:
            assert second.generation == first.generation + 1
            assert second.recovery.table("intent")[key_str(("t",))] == {
                "desired": 7}
            assert second.state == "warmup"
            second.on_tick()
            assert second.state == "serving"
        finally:
            second.release()

    def test_journal_dirs_cross_packages(self, package, tmp_path):
        """A tenant dir claimed by one package is adopted by the other at
        the next generation, with the predecessor's intent."""
        other = REF if package == PORT else PORT
        key_str = mod(other, "recovery.journal").key_str
        journal_dir = str(tmp_path / "tenant")
        first = mod(package, "replication").TenantHandoff(
            "t", journal_dir=journal_dir)
        first.recovery.handle("intent").set(("t",), {"desired": 3})
        first.release()
        second = mod(other, "replication").TenantHandoff(
            "t", journal_dir=journal_dir)
        try:
            assert second.generation == 2
            assert second.recovery.table("intent")[key_str(("t",))] == {
                "desired": 3}
        finally:
            second.release()


# -- the plane ---------------------------------------------------------------------


def plane_of(package, store, clock, rid, tenants, registry=None, partitions=4,
             **kw):
    return mod(package, "replication").ReplicatedControlPlane(
        store, replica_id=rid, partitions=partitions, lease_duration=5.0,
        tenants_source=lambda: tenants, warmup_ticks=1, registry=registry,
        clock=clock, **kw,
    )


def registry_of(package):
    return mod(package, "metrics.registry").GaugeRegistry()


@pytest.mark.parametrize("package", PACKAGES)
class TestReplicatedControlPlane:
    def test_adoption_metrics_and_scoreboard(self, package):
        store, clock, registry = store_of(package), FakeClock(), registry_of(
            package)
        tenants = ["t0", "t1", "t2"]
        plane = plane_of(package, store, clock, "a", tenants, registry)
        assert plane.slo_source() is None
        plane.on_tick()
        clock.advance(1.0)
        plane.on_tick()
        assert {t for t in tenants if plane.owns(t)} == set(tenants)
        assert plane.slo_source() is True
        clock.advance(1.0)
        plane.on_tick()
        assert plane.slo_source() is False
        assert all(plane.serving(t) and plane.allow_disruption(t)
                   for t in tenants)
        board = plane.scoreboard()
        assert board["replica"] == "a"
        assert set(board["tenants"]) == set(tenants)
        assert board["adopted_total"] == 3
        assert all(i["state"] == "serving" for i in board["tenants"].values())
        text = registry.expose_text()
        assert "karpenter_replica_partitions_owned" in text
        assert "karpenter_handoff_tenants_adopted_total" in text
        plane.close()
        assert plane.scoreboard()["tenants"] == {}
        assert store.list("Lease") and all(
            lease.holder == "" for lease in store.list("Lease"))

    def test_crash_plan_kills_the_tick(self, package):
        F = mod(package, "faults")
        R = mod(package, "replication")
        store, clock = store_of(package), FakeClock()
        plane = plane_of(package, store, clock, "a", ["t0"])
        registry = F.FaultRegistry(seed=1)
        R.crash_plan(registry, "a", times=1)
        F.install(registry)
        with pytest.raises(F.ProcessCrash):
            plane.on_tick()
        F.uninstall()
        plane.on_tick()

    def test_partition_plans_cut_off_the_lease_store(self, package):
        F = mod(package, "faults")
        R = mod(package, "replication")
        store, clock = store_of(package), FakeClock()
        plane = plane_of(package, store, clock, "a", ["t0"])
        acquire_plan, renew_plan = R.partition_plans(
            F.install(F.FaultRegistry(seed=1)), "a")
        for _ in range(4):
            clock.advance(1.0)
            round_ = plane.on_tick()
        assert not round_.owned
        assert acquire_plan.fired > 0 and renew_plan.fired == 0
        F.uninstall()
        for _ in range(2):
            clock.advance(1.0)
            round_ = plane.on_tick()
        assert round_.owned == set(range(4))
        _, renew_plan2 = R.partition_plans(
            F.install(F.FaultRegistry(seed=2)), "a")
        clock.advance(2.0)
        round_ = plane.on_tick()
        assert renew_plan2.fired > 0
        assert round_.failures > 0
        assert not round_.owned
        assert plane.slo_source() is True

    def test_generated_replica_id(self, package):
        plane = plane_of(package, store_of(package), FakeClock(), None, [])
        assert plane.replica_id.startswith("karpenter-")
        assert len(plane.replica_id) == len("karpenter-") + 8

    def test_adoption_recorded_and_validator_seeded(self, package, tmp_path):
        fence = mod(package, "recovery.fence")
        fr = mod(package, "observability.flightrecorder")
        recorder = fr.FlightRecorder()
        validator = fence.FenceValidator()
        store, clock = store_of(package), FakeClock()

        def journal_dir_for(tenant):
            path = tmp_path / tenant
            path.mkdir(exist_ok=True)
            return str(path)

        plane = plane_of(package, store, clock, "a", ["t0", "t1"],
                         journal_dir_for=journal_dir_for,
                         validator=validator, recorder=recorder)
        try:
            plane.on_tick()
            clock.advance(1.0)
            plane.on_tick()
            events = recorder.events(kind="tenant_handoff")
            assert sorted(e["tenant"] for e in events) == ["t0", "t1"]
            assert all(e["generation"] == 1 and e["replica"] == "a"
                       for e in events)
            assert plane.token_for("t0") is not None
            assert plane.token_for("nobody") is None
            validator.admit(plane.token_for("t0"))
            assert plane.handoff_for("t1").generation == 1
        finally:
            plane.close()


def scoreboards(package, tmp_path):
    """Two planes over one store, tenants with journal dirs: every
    round's scoreboard (less the replay time) and series."""
    store, clock = store_of(package), FakeClock()
    tenants = [f"t{i}" for i in range(12)]

    def journal_dir_for(tenant):
        path = tmp_path / package / tenant
        path.mkdir(parents=True, exist_ok=True)
        return str(path)

    registries = {rid: registry_of(package) for rid in ("a", "b")}
    planes = {
        rid: plane_of(package, store, clock, rid, tenants, registries[rid],
                      partitions=5, journal_dir_for=journal_dir_for)
        for rid in ("a", "b")
    }
    trail = []
    try:
        for step in range(8):
            clock.advance(2.0)
            if step == 5:
                planes.pop("a").close()
            for rid, plane in sorted(planes.items()):
                plane.on_tick()
                board = plane.scoreboard()
                for info in board["tenants"].values():
                    info.pop("replay_seconds")
                trail.append((step, rid, board, plane.slo_source(),
                              workloads.replica_series(registries[rid])))
    finally:
        for plane in planes.values():
            plane.close()
    return trail


def test_planes_equal_the_reference(tmp_path):
    """Two planes per package over one store with fenced tenant dirs, one
    closed mid-run: equal scoreboards, SLO verdicts and series."""
    assert scoreboards(PORT, tmp_path) == scoreboards(REF, tmp_path)


# -- the failover world --------------------------------------------------------


@pytest.fixture(scope="module")
def failover_reports():
    return {
        package: mod(package, "simulate").simulate_failover(
            seed=FAILOVER_SEED)
        for package in PACKAGES
    }


class TestFailoverWorld:
    def test_report_equals_the_reference(self, failover_reports):
        got, want = failover_reports[PORT], failover_reports[REF]
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key] == want[key], key

    def test_victim_tenants_reassigned(self, failover_reports):
        r = failover_reports[PORT]
        assert r["victim"] is not None and r["victim_tenants"]
        assert r["tenants_reassigned"] == r["victim_tenants"]
        assert set(r["adopters"].values()).isdisjoint({r["victim"], None})

    def test_reconverges_within_ten_ticks(self, failover_reports):
        r = failover_reports[PORT]
        assert r["converged"]
        assert r["reconverge_ticks"] is not None
        assert r["reconverge_ticks"] <= 10

    def test_exactly_once_actuation_across_handoff(self, failover_reports):
        r = failover_reports[PORT]
        assert r["duplicate_actuations"] == 0
        assert r["lost_actuations"] == 0

    def test_deposed_late_write_fence_rejected(self, failover_reports):
        r = failover_reports[PORT]
        assert r["stale_write_rejected"] and not r["stale_write_applied"]
        assert r["fence_rejections"] >= 1
        assert all(gen >= 2 for gen in r["fence_generations"].values())

    def test_world_is_deterministic(self, failover_reports):
        again = mod(PORT, "simulate").simulate_failover(seed=FAILOVER_SEED)
        assert again == failover_reports[PORT]

    @pytest.mark.parametrize("kw", [
        dict(replicas=2, seed=1),
        dict(tenants=24, replicas=4, partitions=6, kill_tick=8, seed=3),
        dict(tenants=12, replicas=3, warmup_ticks=2, lease_duration=3.0,
             seed=5),
    ], ids=["2-replicas", "4-replicas-6-partitions", "warmup-2-lease-3"])
    def test_other_worlds_equal_the_reference(self, kw):
        got = mod(PORT, "simulate").simulate_failover(**kw)
        assert got == mod(REF, "simulate").simulate_failover(**kw)

    def test_journal_dir_is_kept(self, tmp_path):
        root = str(tmp_path / "j")
        report = mod(PORT, "simulate").simulate_failover(
            tenants=6, journal_dir=root)
        assert report["converged"]
        tenant_dirs = sorted(os.listdir(os.path.join(root, "tenants")))
        assert tenant_dirs == [f"t{i:03d}" for i in range(6)]


def test_bench_width_digest_equals_the_reference():
    """bench-failover's world (256 x 4 x 16, 40 ticks): the port's
    writes_digest is the reference's and BASELINE.json's."""
    got = mod(PORT, "simulate").simulate_failover(**BENCH_WIDTH)
    want = mod(REF, "simulate").simulate_failover(**BENCH_WIDTH)
    assert got == want
    assert got["writes_digest"] == BENCH_DIGEST
    with open(os.path.join(REPO_ROOT, "BASELINE.json")) as f:
        published = json.load(f)["published"]
    record = published["256 tenants x 4 replicas failover (cpu)"]
    assert record["writes_digest"] == got["writes_digest"]
    assert record["victim_tenants"] == len(got["victim_tenants"])
    assert record["blackout_ticks_p99"] == got["blackout_ticks_p99"]


# -- replicated runtimes ----------------------------------------------------------

FLEET_WORLD = dict(pods=600, types=20, n_has=24, metrics=2, seed=0, groups=2)
FLEET_TENANTS = 10


def world_api(package):
    return workloads.runtime_api_namespace({
        key: mod(package, key) for key in workloads.RUNTIME_API
    })


def replica_api(package):
    return workloads.replica_api_namespace({
        key: mod(package, key) for key in workloads.REPLICA_API
    })


def run_fleet(package, root, ids=("r0", "r1"), before=3, after=3,
              partitions=8):
    """`ids` replicas of `package` over one store: `before` ticks, the
    bigger owner killed on the next, `after` more (5 s each, the first
    past lease + skew of the victim's last renew). Returns the victim
    and every tick's (died, fleet snapshot)."""
    store = store_of(package)
    provider = mod(package, "cloudprovider.fake").FakeFactory()
    world = workloads.build_runtime_world(store, provider, **FLEET_WORLD,
                                          api=world_api(package))
    config = os.path.join(root, "tenants.json")
    with open(config, "w") as f:
        json.dump([{"id": f"tenant-{i}"} for i in range(FLEET_TENANTS)], f)
    options = dict(partitions=partitions, lease_duration_s=5.0,
                   tenant_config=config,
                   journal_dir=os.path.join(root, "j"))
    if package == PORT:
        options["device"] = "cpu"
    clock = FakeClock(1_000_000.0)
    fleet = workloads.ReplicaFleet(store, provider, list(ids), clock,
                                   options, api=replica_api(package))
    to_dict = mod(package, "api.serialization").to_dict
    trail = []
    try:
        victim = fleet.failover(
            world, before, after, churn=20, tick_s=5.0,
            record=lambda tick, died: trail.append((died, fleet.snapshot(
                to_dict, skip=workloads.SNAPSHOT_SKIP))))
    finally:
        fleet.close()
    return victim, trail


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    out = {}
    for package in PACKAGES:
        root = tmp_path_factory.mktemp(package)
        out[package] = run_fleet(package, str(root))
    return out


class TestReplicatedRuntimes:
    def test_ownership_handoffs_and_series_equal_the_reference(self, fleets):
        (victim, got), (ref_victim, want) = fleets[PORT], fleets[REF]
        assert victim == ref_victim
        assert len(got) == len(want)
        for tick, ((died, g), (ref_died, w)) in enumerate(zip(got, want)):
            assert died == ref_died, f"tick {tick}"
            assert g["state"] == w["state"], f"tick {tick}"

    def test_store_cloud_and_exposition_equal_the_reference(self, fleets):
        """Every replica ticks the whole world (ownership gates nothing
        in the reference's binary): the store's objects, the cloud's
        replicas and each replica's exposition equal the reference's."""
        got, want = fleets[PORT][1], fleets[REF][1]
        for tick, ((_, g), (_, w)) in enumerate(zip(got, want)):
            assert g["objects"].keys() == w["objects"].keys()
            for key, doc in w["objects"].items():
                assert g["objects"][key] == doc, f"tick {tick}: {key}"
            assert g["replicas"] == w["replicas"], f"tick {tick}"
            assert g["exposition"] == w["exposition"], f"tick {tick}"

    def test_survivor_adopts_every_victim_tenant(self, fleets):
        victim, trail = fleets[PORT]
        before = trail[2][1]["state"][victim]["tenants"]
        assert before, "the victim owned no tenant"
        died = [d for d, _ in trail if d]
        assert died == [[victim]]
        (survivor, final), = trail[-1][1]["state"].items()
        assert final["owned"] == list(range(8))
        assert final["live"] == [survivor]
        for tenant in before:
            state, generation, _ = final["tenants"][tenant]
            assert state == "serving" and generation >= 2
        assert len(final["tenants"]) == FLEET_TENANTS

    def test_warmup_then_serving(self, fleets):
        victim, trail = fleets[PORT]
        adopted = trail[2][1]["state"][victim]["tenants"]
        states = [
            {s["tenants"][t][0] for s in snap["state"].values()
             for t in adopted if t in s["tenants"]}
            for _, snap in trail[4:]
        ]
        assert "warmup" in states[0] or "warmup" in states[1]
        assert states[-1] == {"serving"}


class TestRuntimeWiring:
    def _runtime(self, **kw):
        rt = mod(PORT, "runtime")
        fake = mod(PORT, "cloudprovider.fake")
        clock = FakeClock()
        return clock, rt.KarpenterRuntime(
            rt.Options(device="cpu", **kw),
            cloud_provider_factory=fake.FakeFactory(), clock=clock,
        )

    def test_no_partitions_builds_nothing_and_touches_nothing(self):
        F = mod(PORT, "faults")
        R = mod(PORT, "replication")
        registry = F.FaultRegistry(seed=0)
        lease_plans = R.partition_plans(registry)
        crash_plans = [registry.plan("replica.crash.*", mode="error")]
        F.install(registry)
        clock, runtime = self._runtime()
        try:
            assert runtime.replication is None
            assert runtime.selfslo.replica_source is None
            for _ in range(3):
                clock.advance(61.0)
                runtime.manager.reconcile_all()
            assert runtime.store.list("Lease") == []
            assert all(p.fired == 0 for p in lease_plans + crash_plans)
            text = runtime.registry.expose_text()
            assert "karpenter_replica_" not in text
            assert "karpenter_handoff_" not in text
        finally:
            F.uninstall()
            runtime.close()

    def test_partitions_builds_the_plane(self):
        clock, runtime = self._runtime(
            partitions=4, replica_id="r0", lease_duration_s=5.0)
        try:
            plane = runtime.replication
            assert plane is not None and plane.replica_id == "r0"
            assert runtime.selfslo.replica_source == plane.slo_source
            for _ in range(2):
                clock.advance(61.0)
                runtime.manager.reconcile_all()
            assert plane.leases.owned == set(range(4))
            assert runtime.store.list("Lease") != []
            assert "karpenter_replica_partitions_owned" in (
                runtime.registry.expose_text())
        finally:
            runtime.close()
        assert runtime.replication is None
        assert all(lease.holder == "" for lease in runtime.store.list("Lease"))

    def test_tenants_adopted_with_their_journal_dirs(self, tmp_path):
        config = tmp_path / "tenants.json"
        config.write_text(json.dumps([{"id": "a"}, {"id": "b"}]))
        clock, runtime = self._runtime(
            partitions=2, replica_id="r0",
            tenant_config=str(config), journal_dir=str(tmp_path / "j"))
        try:
            for _ in range(2):
                clock.advance(61.0)
                runtime.manager.reconcile_all()
            board = runtime.replication.scoreboard()
            assert sorted(board["tenants"]) == ["a", "b"]
            assert all(t["generation"] == 1
                       for t in board["tenants"].values())
            assert os.path.isdir(tmp_path / "j" / "tenants" / "a")
        finally:
            runtime.close()

    def test_default_device_raises_before_any_lease(self, monkeypatch):
        """No card: the replicated runtime's construction raises before
        the plane exists, so no Lease is ever written."""
        import torch

        rt = mod(PORT, "runtime")
        store = mod(PORT, "store").Store()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(Exception, match="CUDA"):
            rt.KarpenterRuntime(
                rt.Options(partitions=2, replica_id="r0"), store=store,
                cloud_provider_factory=mod(
                    PORT, "cloudprovider.fake").FakeFactory())
        assert store.list("Lease") == []


class TestDebugReplicasEndpoint:
    def _get(self, port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
            return json.loads(r.read())

    def _served(self, package, plane=None):
        obs = mod(package, "observability")
        server = obs.MetricsServer(registry_of(package), port=0,
                                   host="127.0.0.1", replication=plane)
        port = server.start()
        try:
            return self._get(port, "/debug/replicas")
        finally:
            server.stop()

    def test_disabled_without_replication(self):
        assert self._served(PORT) == {"enabled": False}

    def test_scoreboard_served_as_the_reference(self):
        boards = {}
        for package in PACKAGES:
            store, clock = store_of(package), FakeClock()
            plane = plane_of(package, store, clock, "a", ["t0"],
                             partitions=2)
            plane.on_tick()
            clock.advance(1.0)
            plane.on_tick()
            try:
                boards[package] = self._served(package, plane)
            finally:
                plane.close()
        board = boards[PORT]
        assert board["enabled"] is True
        assert board["replica"] == "a"
        assert board["owned"] == [0, 1]
        assert "t0" in board["tenants"]
        assert board == boards[REF]
