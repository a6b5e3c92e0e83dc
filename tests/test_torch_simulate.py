"""The port's operator dry run (karpenter_tpu_torch/simulate.py: simulate,
simulate_delta, simulate_consolidation) and its `--simulate` CLI against
the reference's, on the CPU.

  * every case of the reference's tests/test_simulate.py fixture (rows
    mapped back to pods, what-if groups absorbing only unserved pods,
    labels and taints in both dialects, scale-from-zero through the
    template resolver, a poisoned producer, preferred affinity that must
    not steal into a what-if group, name collisions) gives the same
    report on both packages, and the reference's asserted values hold on
    the port's;
  * the consolidation report on both packages over the same world;
  * the CLI over data dirs written by either package's DurableStore: the
    port's `--simulate --device cpu` prints the reference's stdout byte
    for byte (dry run, --what-if, --consolidate, --list);
  * `--multitenant` and `--failover` print the reference's reports;
    without a card and without --device cpu the dry run exits 1 with
    the reason; a non-list --what-if exits 2.

The port's dry runs solve on a CPU SolverService; the reference's on its
own default service (JAX on the CPU), as its tests run them.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json

import pytest

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.solver.service import SolverService

REF, PORT = "karpenter_tpu", "karpenter_tpu_torch"


def mod(package: str, name: str):
    return importlib.import_module(f"{package}.{name}")


@pytest.fixture(scope="module")
def port_svc():
    service = SolverService(registry=GaugeRegistry(), device="cpu")
    try:
        yield service
    finally:
        service.close()


class World:
    """One package's classes and a store holding the fixture's cluster:
    one Ready node (4 cpu, 8Gi) selected by one pendingCapacity
    producer."""

    def __init__(self, package):
        self.package = package
        self.core = mod(package, "api.core")
        self.mp = mod(package, "api.metricsproducer")
        self.simulate = mod(package, "simulate")
        self.store = mod(package, "store.store").Store()
        self.store.create(self.node("n-a", {"group": "a"}))
        self.store.create(self.producer("group-a", {"group": "a"}))

    def node(self, name, labels, cpu="4", memory="8Gi", pods="16"):
        c = self.core
        return c.Node(
            metadata=c.ObjectMeta(name=name, labels=dict(labels)),
            spec=c.NodeSpec(),
            status=c.NodeStatus(
                allocatable=c.resource_list(cpu=cpu, memory=memory, pods=pods),
                conditions=[c.NodeCondition("Ready", "True")],
            ),
        )

    def pod(self, name, cpu="1", memory="1Gi", node_selector=None):
        c = self.core
        return c.Pod(
            metadata=c.ObjectMeta(name=name),
            spec=c.PodSpec(
                node_name="",
                containers=[c.Container(
                    requests=c.resource_list(cpu=cpu, memory=memory))],
                node_selector=dict(node_selector or {}),
            ),
        )

    def producer(self, name, selector):
        m = self.mp
        return m.MetricsProducer(
            metadata=self.core.ObjectMeta(name=name),
            spec=m.MetricsProducerSpec(pending_capacity=m.PendingCapacitySpec(
                node_selector=dict(selector))),
        )

    def prefers_ssd(self, name):
        c = self.core
        pod = self.pod(name)
        pod.spec.affinity = c.Affinity(node_affinity=c.NodeAffinity(
            preferred_during_scheduling_ignored_during_execution=[
                c.PreferredSchedulingTerm(
                    weight=100,
                    preference=c.NodeSelectorTerm(match_expressions=[
                        c.NodeSelectorRequirement(
                            key="disk", operator="In", values=["ssd"])
                    ]),
                )
            ]))
        return pod


METAL = {"name": "metal",
         "allocatable": {"cpu": "96", "memory": "128Gi", "pods": "110"}}


def _picky(w):
    w.store.create(w.pod("picky", cpu="1", node_selector={"disk": "ssd"}))


def _scale_from_zero(w):
    w.store = mod(w.package, "store.store").Store()
    mp = w.producer("empty-group", {"group": "zero"})
    mp.spec.pending_capacity.node_group_ref = "pool"
    w.store.create(mp)
    w.store.create(w.pod("p"))


def _poisoned(w):
    bad = w.producer("poisoned", {"group": "x"})
    bad.spec.pending_capacity.node_selector = None
    w.store.create(bad)
    w.store.create(w.pod("p"))


def _resolver(namespace, ref):
    assert (namespace, ref) == ("default", "pool")
    return ({"cpu": 8.0, "memory": 2**34, "pods": 110.0}, {("group", "zero")},
            set())


# (setup(world), call, what-if groups or None for a plain simulate(),
#  the reference test's assertions on the report)
CASES = {
    "rows_map_back_to_pods": (
        lambda w: [w.store.create(w.pod(f"small-{i}")) for i in range(3)]
        + [w.store.create(w.pod("huge", cpu="64"))],
        "simulate", None,
        lambda r: (r["groups"]["default/group-a"]["pending_pods"] == 3
                   and r["unschedulable_pods"] == 1
                   and [x["pods"] for x in r["rows"]
                        if x["pod"].startswith("default/small")] == [3])),
    "what_if_absorbs_only_unserved": (
        lambda w: [w.store.create(w.pod(f"small-{i}")) for i in range(2)]
        + [w.store.create(w.pod("huge", cpu="64", memory="64Gi"))],
        "simulate", [METAL],
        lambda r: (r["groups"]["default/group-a"]["pending_pods"] == 2
                   and r["groups"]["metal"]["what_if"]
                   and r["groups"]["metal"]["pending_pods"] == 1
                   and r["groups"]["metal"]["additional_nodes_needed"] == 1
                   and r["unschedulable_pods"] == 0)),
    "what_if_without_the_label": (
        _picky, "simulate",
        [{"name": "plain",
          "allocatable": {"cpu": "8", "memory": "16Gi", "pods": "64"}}],
        lambda r: r["unschedulable_pods"] == 1),
    "what_if_with_the_label": (
        _picky, "simulate",
        [{"name": "ssd", "labels": {"disk": "ssd"},
          "allocatable": {"cpu": "8", "memory": "16Gi", "pods": "64"}}],
        lambda r: r["groups"]["ssd"]["pending_pods"] == 1),
    "what_if_tainted": (
        _picky, "simulate",
        [{"name": "ssd-tainted", "labels": {"disk": "ssd"},
          "allocatable": {"cpu": "8", "memory": "16Gi", "pods": "64"},
          "taints": [{"key": "d", "value": "x", "effect": "NoSchedule"}]}],
        lambda r: r["unschedulable_pods"] == 1),
    "delta_report": (
        lambda w: w.store.create(w.pod("huge", cpu="64", memory="64Gi")),
        "simulate_delta", [METAL],
        lambda r: (r["delta"]["unschedulable_pods"] == -1
                   and r["delta"]["groups"]["metal"] == {
                       "pending_pods": 1, "additional_nodes_needed": 1})),
    "empty_pending_set": (
        lambda w: None, "simulate", None,
        lambda r: (r["rows"] == [] and r["unschedulable_pods"] == 0)),
    "pods_resource_defaults": (
        lambda w: w.store.create(w.pod("huge", cpu="64", memory="64Gi")),
        "simulate",
        [{"name": "metal", "allocatable": {"cpu": "96", "memory": "128Gi"}}],
        lambda r: (r["groups"]["metal"]["pending_pods"] == 1
                   and r["unschedulable_pods"] == 0)),
    "cloud_api_taint_dialect": (
        lambda w: w.store.create(w.pod("huge", cpu="64", memory="64Gi")),
        "simulate",
        [{"name": "metal", "allocatable": {"cpu": "96", "memory": "128Gi"},
          "taints": [{"key": "d", "value": "x", "effect": "NO_SCHEDULE"}]}],
        lambda r: r["unschedulable_pods"] == 1),
    "scale_from_zero_resolver": (
        _scale_from_zero, "simulate", None,
        lambda r: (r["groups"]["default/empty-group"]["pending_pods"] == 1
                   and r["unschedulable_pods"] == 0)),
    "poisoned_producer_row_isolated": (
        _poisoned, "simulate", None,
        lambda r: ("error" in r["groups"]["default/poisoned"]
                   and r["groups"]["default/group-a"]["pending_pods"] == 1)),
    "preferred_affinity_cannot_steal": (
        lambda w: w.store.create(w.prefers_ssd("prefers-ssd")),
        "simulate",
        [{"name": "ssd-pool", "labels": {"disk": "ssd"},
          "allocatable": {"cpu": "8", "memory": "16Gi"}}],
        lambda r: (r["groups"]["default/group-a"]["pending_pods"] == 1
                   and r["groups"]["ssd-pool"]["pending_pods"] == 0)),
    "what_if_name_collision": (
        lambda w: w.store.create(w.pod("p")), "simulate",
        [{"name": "metal", "allocatable": {"cpu": "8", "memory": "8Gi"}}] * 2,
        lambda r: "metal" in r["groups"] and "metal#2" in r["groups"]),
}


def run_case(package, name, solver):
    setup, call, what_if, _ = CASES[name]
    world = World(package)
    setup(world)
    kwargs = {"solver": solver}
    if name == "scale_from_zero_resolver":
        kwargs["template_resolver"] = _resolver
    return getattr(world.simulate, call)(world.store, what_if, **kwargs), world


class TestDryRunReports:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_report_equals_the_reference(self, name, port_svc):
        got, world = run_case(PORT, name, port_svc.solve)
        want, _ = run_case(REF, name, None)
        assert got == want
        assert CASES[name][3](got)

    def test_simulation_mutates_nothing(self, port_svc):
        world = World(PORT)
        world.store.create(world.pod("p"))
        before = world.store.get("MetricsProducer", "default", "group-a")
        world.simulate.simulate(world.store, solver=port_svc.solve)
        after = world.store.get("MetricsProducer", "default", "group-a")
        assert after.metadata.resource_version == \
            before.metadata.resource_version
        assert after.status.pending_capacity is None

    @pytest.mark.parametrize("backend", ["torch", "numpy"])
    def test_both_cpu_rungs_give_the_same_report(self, backend):
        svc = SolverService(registry=GaugeRegistry(), device="cpu",
                            backend=backend)
        try:
            got, _ = run_case(PORT, "what_if_absorbs_only_unserved",
                              svc.solve)
            want, _ = run_case(REF, "what_if_absorbs_only_unserved", None)
            assert got == want
        finally:
            svc.close()


DISRUPTION = dict(nodes=24, pods=240, pending_critical=4, seed=3)


def consolidation_report(package, service):
    api = workloads.disruption_api_namespace(
        {key: mod(package, key) for key in workloads.DISRUPTION_API})
    store = api.Store()
    workloads._draw_disruption(api, store, api.FakeFactory(), **DISRUPTION)
    return mod(package, "simulate").simulate_consolidation(
        store, service=service)


class TestConsolidationReport:
    def test_report_equals_the_reference(self, port_svc):
        ref_svc = mod(REF, "solver.service").SolverService(
            registry=mod(REF, "metrics.registry").GaugeRegistry())
        try:
            want = consolidation_report(REF, ref_svc)
        finally:
            ref_svc.close()
        got = consolidation_report(PORT, port_svc)
        assert got == want
        assert got["candidates_evaluated"] == DISRUPTION["nodes"]
        assert got["drainable"]

    def test_torch_rung_gives_the_same_report(self, port_svc):
        svc = SolverService(registry=GaugeRegistry(), device="cpu",
                            backend="torch")
        try:
            assert consolidation_report(PORT, svc) == \
                consolidation_report(PORT, port_svc)
        finally:
            svc.close()


# -- the CLI -------------------------------------------------------------------

DRY = dict(pods=600, types=12, seed=0)


def run_main(package, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod(package, "__main__").main(argv)
    return rc, out.getvalue()


def write_dir(package, path, kind):
    """A data dir written by `package`'s DurableStore."""
    open_store = mod(package, "store.persistence").open_store
    if kind == "dry":
        api = workloads.api_namespace(
            {key: mod(package, key) for key in workloads.RECONCILE_API})
        workloads.write_reconcile_dir(
            path, **DRY, open_store=lambda p: open_store(p), api=api)
    else:
        api = workloads.disruption_api_namespace(
            {key: mod(package, key) for key in workloads.DISRUPTION_API})
        workloads.write_disruption_dir(
            path, **DISRUPTION, open_store=lambda p: open_store(p), api=api)
    return path


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("simulate-cli")
    what_if = root / "what-if.json"
    what_if.write_text(json.dumps(workloads.what_if_specs()))
    return {
        "ref-dry": write_dir(REF, str(root / "ref-dry"), "dry"),
        "port-dry": write_dir(PORT, str(root / "port-dry"), "dry"),
        "ref-cons": write_dir(REF, str(root / "ref-cons"), "cons"),
        "what-if": str(what_if),
    }


CLI_CASES = {
    "dry_run": ("ref-dry", []),
    "what_if": ("ref-dry", ["--what-if", "what-if"]),
    "consolidate": ("ref-cons", ["--consolidate"]),
    "port_written_dry_run": ("port-dry", []),
}


class TestCLI:
    @pytest.mark.parametrize("case", sorted(CLI_CASES))
    def test_stdout_equals_the_reference(self, dirs, case):
        key, extra = CLI_CASES[case]
        extra = [dirs[e] if e in dirs else e for e in extra]
        argv = ["--simulate", "--data-dir", dirs[key], "--no-leader-elect",
                *extra]
        want_rc, want = run_main(REF, argv)
        got_rc, got = run_main(PORT, argv + ["--device", "cpu"])
        assert (got_rc, got) == (want_rc, want)
        assert got_rc == 0 and json.loads(got)

    def test_dry_run_totals(self, dirs):
        rc, out = run_main(PORT, ["--simulate", "--data-dir",
                                  dirs["ref-dry"], "--device", "cpu"])
        report = json.loads(out)
        assert rc == 0
        assert sum(g["pending_pods"] for g in report["groups"].values()) \
            == DRY["pods"]
        assert len(report["groups"]) == DRY["types"]

    def test_list_prints_the_reference_catalog(self, dirs, capsys):
        # --list runs no device program: no --device cpu needed
        rc, out = run_main(PORT, ["--simulate", "--list"])
        assert rc == 0
        assert out == run_main(REF, ["--simulate", "--list"])[1]
        assert "solver device" not in capsys.readouterr().err

    def test_no_card_exits_1_with_the_reason(self, dirs, capsys):
        rc, out = run_main(PORT, ["--simulate", "--data-dir",
                                  dirs["port-dry"]])
        assert (rc, out) == (1, "")
        err = capsys.readouterr().err
        assert "cannot start" in err and "CUDA device requested" in err

    def test_non_list_what_if_exits_2(self, tmp_path, capsys):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"name": "not-a-list"}))
        rc, _ = run_main(PORT, ["--simulate", "--what-if", str(bad),
                                "--data-dir", str(tmp_path / "s"),
                                "--device", "cpu"])
        assert rc == 2
        assert "expected a LIST" in capsys.readouterr().err

    def test_empty_what_if_list_still_yields_delta_shape(self, tmp_path):
        empty = tmp_path / "none.json"
        empty.write_text("[]")
        rc, out = run_main(PORT, ["--simulate", "--what-if", str(empty),
                                  "--data-dir", str(tmp_path / "s"),
                                  "--device", "cpu"])
        assert rc == 0
        assert set(json.loads(out)) == {"baseline", "what_if", "delta"}

    @pytest.mark.parametrize("argv", [
        ["--simulate", "--failover"],
        ["--simulate", "--failover", "--replicas", "4", "--sim-seed", "3"],
    ], ids=["default", "4-replicas-seed-3"])
    def test_failover_world_runs_as_the_reference(self, argv, tmp_path):
        """--simulate --failover used to exit 2 naming replication/; it
        now prints the reference's report, byte for byte."""
        rc, out = run_main(PORT, argv + ["--device", "cpu"])
        ref_rc, ref_out = run_main(REF, argv)
        assert rc == ref_rc == 0
        assert out == ref_out
        report = json.loads(out)
        assert report["converged"] and report["stale_write_rejected"]

    def test_multitenant_world_runs_as_the_reference(self):
        """--simulate --multitenant used to exit 2 naming tenancy/; it
        now prints the reference's report (the service's own request and
        dispatch counters aside: the rungs differ)."""
        argv = ["--simulate", "--multitenant", "--tenants", "6"]
        rc, out = run_main(PORT, argv + ["--device", "cpu"])
        ref_rc, ref_out = run_main(REF, argv)
        assert rc == ref_rc == 0
        got, want = json.loads(out), json.loads(ref_out)
        got.pop("solver")
        want.pop("solver")
        assert got == want

    def test_multitenant_and_failover_trails_still_work(self):
        from karpenter_tpu_torch.simlab import get_scenario

        for name in ("multitenant", "failover"):
            trails = get_scenario(name).trails(0)
            assert trails.demand.shape == (64, 8)

    def test_sim_seed_option_is_carried(self):
        runtime = mod(PORT, "runtime")
        rt = runtime.KarpenterRuntime(runtime.Options(device="cpu",
                                                      sim_seed=8))
        try:
            assert rt.options.sim_seed == 8
        finally:
            rt.close()
