"""The port's `solve_pending` against the reference's on the CPU: the same
cluster (tests/test_torch_encoder.py's scenarios, one store per package)
reconciled with the port's `solve(device="cpu")` and with the
reference's CPU solve (numpy and xla backends) must leave the same
PendingCapacityStatus on every due producer, the same gauges and
counters on the registry (its whole text exposition: the four gauges of
every producer, the constraint verdict gauges and the encode-cache
hit/miss counters), and the same error map.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import workloads as W
from tests.test_torch_encoder import (  # noqa: F401 — autouse state reset
    PKGS,
    SCENARIOS,
    _fresh_state,
    api_of,
    build_both,
    port_cpu_solver,
    ref_solver,
    reset_state,
    run_tick,
)

FIELDS = ("pending_pods", "additional_nodes_needed", "lp_lower_bound",
          "unschedulable_pods")


def statuses(cluster):
    out = {}
    for mp in cluster.producers:
        st = mp.status.pending_capacity
        key = (mp.metadata.namespace, mp.metadata.name)
        out[key] = None if st is None else tuple(getattr(st, f) for f in FIELDS)
    return out


def error_map(errors):
    return {
        key: None if e is None else (type(e).__name__, str(e))
        for key, e in errors.items()
    }


def assert_same_reconcile(port, ref, port_errors, ref_errors, port_reg,
                          ref_reg):
    assert statuses(port) == statuses(ref)
    assert error_map(port_errors) == error_map(ref_errors)
    assert port_reg.expose_text() == ref_reg.expose_text()


class TestReconcileParity:
    @pytest.mark.parametrize("path", ["oracle", "pod_cache", "feed"])
    @pytest.mark.parametrize("scenario", sorted(SCENARIOS))
    def test_numpy_backend(self, scenario, path):
        clusters = build_both(scenario)
        port_errors, port_reg = run_tick("port", clusters["port"], path)
        ref_errors, ref_reg = run_tick("ref", clusters["ref"], path)
        assert_same_reconcile(clusters["port"], clusters["ref"],
                              port_errors, ref_errors, port_reg, ref_reg)
        assert any(s is not None for s in statuses(clusters["port"]).values())

    @pytest.mark.parametrize("scenario", sorted(SCENARIOS))
    def test_xla_backend(self, scenario):
        clusters = build_both(scenario)
        port_errors, port_reg = run_tick("port", clusters["port"], "feed")
        ref_errors, ref_reg = run_tick(
            "ref", clusters["ref"], "feed", solver=ref_solver("xla"))
        assert_same_reconcile(clusters["port"], clusters["ref"],
                              port_errors, ref_errors, port_reg, ref_reg)

    def test_churn_and_cache_counters(self):
        """A first tick, two unchanged ticks and three churned ticks
        through the feed: statuses and the whole registry (the
        encode_cache_total hit and miss counters included) stay equal."""
        clusters = build_both("mixed")
        regs = {side: api_of(side).GaugeRegistry() for side in PKGS}
        for step in range(6):
            if step >= 3:
                for side in PKGS:
                    W.churn_reconcile(clusters[side].draw, 25)()
            errs = {
                side: run_tick(side, clusters[side], "feed",
                               registry=regs[side])[0]
                for side in PKGS
            }
            assert_same_reconcile(clusters["port"], clusters["ref"],
                                  errs["port"], errs["ref"], regs["port"],
                                  regs["ref"])
        text = regs["port"].expose_text()
        assert 'karpenter_runtime_encode_cache_total{name="hit"' in text
        assert 'karpenter_runtime_encode_cache_total{name="miss"' in text
        hit = regs["port"].gauge("runtime", "encode_cache_total")
        assert hit.get("hit", "-") == 2.0
        assert hit.get("miss", "-") == 4.0

    def test_constraint_verdict_gauges(self):
        clusters = build_both("constraint")
        port_errors, port_reg = run_tick("port", clusters["port"], "feed")
        ref_errors, ref_reg = run_tick("ref", clusters["ref"], "feed")
        assert_same_reconcile(clusters["port"], clusters["ref"],
                              port_errors, ref_errors, port_reg, ref_reg)
        skew = port_reg.gauge("constraints", "spread_skew")
        assert skew.get("web-spread", "-") is not None

    def test_only_due_producers_get_status(self):
        """Status lands on the due producers only; gauges cover every
        producer."""
        clusters = build_both("e2e")
        due = {side: clusters[side].producers[:3] for side in PKGS}
        regs = {}
        for side in PKGS:
            api = api_of(side)
            solver = port_cpu_solver() if side == "port" else ref_solver()
            regs[side] = api.GaugeRegistry()
            api.solve_pending(clusters[side].store, due[side], regs[side],
                              solver=solver, feed=clusters[side].feed)
        assert statuses(clusters["port"]) == statuses(clusters["ref"])
        assert regs["port"].expose_text() == regs["ref"].expose_text()
        sts = statuses(clusters["port"])
        assert sum(v is not None for v in sts.values()) == 3

    def test_single_producer_reconcile(self):
        from karpenter_tpu.metrics.producers.pendingcapacity import (
            PendingCapacityProducer as RefProducer,
        )
        from karpenter_tpu_torch.metrics.producers.pendingcapacity import (
            PendingCapacityProducer as PortProducer,
        )

        clusters = build_both("taints")
        port = PortProducer(clusters["port"].producers[0],
                            clusters["port"].store,
                            registry=api_of("port").GaugeRegistry(),
                            solver=port_cpu_solver())
        ref = RefProducer(clusters["ref"].producers[0], clusters["ref"].store,
                          registry=api_of("ref").GaugeRegistry(),
                          solver=ref_solver())
        port.reconcile()
        ref.reconcile()
        assert statuses(clusters["port"]) == statuses(clusters["ref"])
        assert port.registry.expose_text() == ref.registry.expose_text()


class TestSolveSeam:
    def test_default_solver_needs_the_card(self, monkeypatch):
        """solver=None resolves to the port's solve on the CUDA card; with
        no card the tick raises instead of solving on the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cluster = SCENARIOS["taints"](api_of("port"))
        api = api_of("port")
        with pytest.raises(RuntimeError, match="CUDA"):
            api.solve_pending(cluster.store, cluster.producers,
                              api.GaugeRegistry(), feed=cluster.feed)
        assert all(mp.status.pending_capacity is None
                   for mp in cluster.producers)

    def test_pack_outputs_is_one_vector(self):
        from karpenter_tpu_torch.metrics.producers.pendingcapacity import (
            _pack_outputs,
        )

        a = torch.tensor([3, 0, 1], dtype=torch.int32)
        n = torch.tensor([1, 0, 2], dtype=torch.int32)
        lp = torch.tensor([1, 0, 1], dtype=torch.int32)
        u = torch.tensor(7, dtype=torch.int32)
        packed = _pack_outputs(a, n, lp, u)
        assert packed.dtype == torch.int32
        assert packed.tolist() == [3, 0, 1, 1, 0, 2, 1, 0, 1, 7]

    def test_numpy_outputs_pass_through(self):
        """A solver returning numpy outputs (the non-tensor branch) gives
        the same statuses as the port's CPU solve."""
        from karpenter_tpu_torch.ops.binpack import BinPackOutputs, solve

        def numpy_solver(inputs, **kwargs):
            out = solve(inputs, device="cpu", **kwargs)
            return BinPackOutputs(
                **{k: np.asarray(getattr(out, k)) for k in
                   ("assigned", "assigned_count", "nodes_needed", "lp_bound",
                    "unschedulable")}
            )

        api = api_of("port")
        first = SCENARIOS["gpu"](api)
        run_tick("port", first, "feed")
        reset_state()
        second = SCENARIOS["gpu"](api)
        run_tick("port", second, "feed", solver=numpy_solver)
        assert statuses(first) == statuses(second)

    def test_identity_memo_skips_the_solve(self):
        """An unchanged tick reuses the previous outputs without calling
        the solver (the feed's encode memo)."""
        calls = []
        inner = port_cpu_solver()

        def counting(inputs, **kwargs):
            calls.append(inputs)
            return inner(inputs, **kwargs)

        cluster = SCENARIOS["e2e"](api_of("port"))
        for _ in range(3):
            run_tick("port", cluster, "feed", solver=counting)
        assert len(calls) == 1
        W.churn_reconcile(cluster.draw, 10)()
        run_tick("port", cluster, "feed", solver=counting)
        assert len(calls) == 2 and calls[1] is not calls[0]


def test_reference_draw_constants_small():
    """The cluster draw gives the reference's totals when both packages
    solve it (a small cut of the 100k x 300 draw whose totals chip_smoke.py
    checks)."""
    clusters = build_both("e2e")
    run_tick("port", clusters["port"], "feed")
    run_tick("ref", clusters["ref"], "feed")
    port = statuses(clusters["port"])
    assert port == statuses(clusters["ref"])
    # every pod fits the first group (it takes all pods)
    first = port[("default", "mp0")]
    assert first[0] == 2000 and first[3] == 0

