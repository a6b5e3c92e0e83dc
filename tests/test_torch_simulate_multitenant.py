"""The port's multi-tenant lockstep replay (karpenter_tpu_torch/simulate.py
simulate_multitenant, `--simulate --multitenant`) against the
reference's, on the CPU.

The replay steps N seeded tenant clusters through one
MultiTenantScheduler: each tick every tenant's decide matrix and then
its cost matrix ride shared dispatches, and the refined desired feeds
the next tick. The port's report equals the reference's (the shared
service's own request/dispatch counters aside, which follow the rung),
on its default CPU rung (the numpy mirrors) and its `torch` rung; so do
the aggregate-replica digests, the provenance "why" records of the
pinned tick and the trace/decision exports. The seeded fleet and cost
matrices themselves are byte for byte the reference's.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

import karpenter_tpu.simulate as RS
import karpenter_tpu_torch.simulate as PS
from karpenter_tpu_torch.solver import SolverService

from test_torch_mirrors import assert_same_bytes

# the reference's report at BASELINE.json's multitenant width
# (1,000 tenants x 4 rows x 2 metrics, 12 ticks, seed 0), computed with
# the reference on the CPU; chip_smoke.py phase 17 pins the same numbers
WIDE_DIGESTS = {"tick_0": 44106, "tick_6": 44058, "tick_11": 44109}


def without_solver(report: dict) -> dict:
    report = dict(report)
    report.pop("solver")
    return report


class TestInputs:
    @pytest.mark.parametrize("tenant,tick", [(0, 0), (3, 5), (11, 2)])
    def test_fleet_and_cost_inputs_equal_the_reference(self, tenant, tick):
        spec = np.arange(4, dtype=np.int32) + 2
        got = PS.multitenant_fleet_inputs(tenant, 4, 3, 7, tick, spec, 1e6)
        want = RS.multitenant_fleet_inputs(tenant, 4, 3, 7, tick, spec, 1e6)
        assert_same_bytes(got, want, "fleet")
        desired = np.array([1, 5, 9, 2], np.int32)
        assert_same_bytes(
            PS.multitenant_cost_inputs(got, desired),
            RS.multitenant_cost_inputs(want, desired), "cost",
        )


class TestReport:
    @pytest.mark.parametrize("backend", ["auto", "torch"])
    @pytest.mark.parametrize("tenants,ticks,rows,metrics,seed", [
        (6, 6, 3, 2, 0), (17, 5, 2, 3, 4),
    ])
    def test_report_equals_the_reference(self, tenants, ticks, rows, metrics,
                                         seed, backend):
        kw = dict(tenants=tenants, ticks=ticks, rows=rows, metrics=metrics,
                  seed=seed)
        got = PS.simulate_multitenant(**kw, backend=backend, device="cpu")
        want = RS.simulate_multitenant(**kw)
        assert without_solver(got) == without_solver(want)
        assert got["mirror_served"] == got["fallback_served"] == 0
        assert got["dispatch_amortization"] >= 3.0

    def test_tenant_config_drives_the_replay(self, tmp_path):
        path = tmp_path / "tenants.json"
        path.write_text(json.dumps([
            {"id": "alpha", "weight": 2.0}, {"id": "beta"},
            {"id": "gamma", "weight": 3.0},
        ]))
        got = PS.simulate_multitenant(ticks=4, rows=2,
                                      tenant_config=str(path), device="cpu")
        want = RS.simulate_multitenant(ticks=4, rows=2,
                                       tenant_config=str(path))
        assert got["tenants"] == 3
        assert without_solver(got) == without_solver(want)

    def test_card_policy_replay_has_the_same_digests(self, monkeypatch):
        """The card rule changes who answers a degraded tenant, never a
        healthy replay: a service held to the card's policy replays the
        same digests, serving nothing from numpy."""
        real = SolverService.__init__

        def card(self, *args, **kwargs):
            real(self, *args, **kwargs)
            self._numpy_ladder = False
            self.on_timeout = "raise"

        monkeypatch.setattr(SolverService, "__init__", card)
        got = PS.simulate_multitenant(tenants=8, ticks=4, backend="torch",
                                      device="cpu")
        want = RS.simulate_multitenant(tenants=8, ticks=4)
        assert without_solver(got) == without_solver(want)
        assert got["mirror_served"] == 0

    def test_default_rung_is_the_services(self):
        """`auto`: the numpy mirrors on the CPU (no device dispatch of
        the cost family), the tensor programs on the card."""
        got = PS.simulate_multitenant(tenants=4, ticks=2, device="cpu")
        torch_rung = PS.simulate_multitenant(tenants=4, ticks=2,
                                             device="cpu", backend="torch")
        assert got["solver"]["dispatches"] == 0
        assert torch_rung["solver"]["dispatches"] == 2


class TestProvenanceAndTraces:
    def _strip(self, report):
        """The report less the service's counters and the trace ids (a
        process-wide sequence, which earlier replays advance)."""

        def untraced(value):
            if isinstance(value, dict):
                return {k: untraced(v) for k, v in value.items()
                        if k != "trace"}
            if isinstance(value, list):
                return [untraced(v) for v in value]
            return value

        return untraced(without_solver(report))

    def test_why_records_equal_the_reference(self):
        kw = dict(tenants=5, ticks=6, rows=2, provenance=True)
        got = PS.simulate_multitenant(**kw, device="cpu")
        want = RS.simulate_multitenant(**kw)
        assert self._strip(got) == self._strip(want)
        pinned = got["provenance"]["pinned"]
        assert len(pinned) == 5 * 2
        assert {row["rung"] for row in pinned} <= {None, "device"}

    def test_trace_and_decision_exports(self, tmp_path):
        kw = dict(tenants=4, ticks=3, rows=2, provenance=True)
        got = PS.simulate_multitenant(
            **kw, trace_export=str(tmp_path / "p.jsonl"), device="cpu")
        want = RS.simulate_multitenant(
            **kw, trace_export=str(tmp_path / "r.jsonl"))
        assert got["decision_records"] == want["decision_records"]
        assert got["trace_events"] > 0
        assert (tmp_path / "p.jsonl").exists()
        with open(got["decisions_export"]) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        assert len(rows) == got["decision_records"]
        assert all(row.get("trace") for row in rows)
        assert self._strip({k: v for k, v in got.items()
                            if k not in ("trace_export", "decisions_export",
                                         "trace_events")}) == self._strip(
            {k: v for k, v in want.items()
             if k not in ("trace_export", "decisions_export",
                          "trace_events")})

    def test_replay_restores_the_default_ledger(self):
        from karpenter_tpu_torch.observability import default_ledger

        before = default_ledger()
        PS.simulate_multitenant(tenants=2, ticks=2, provenance=True,
                                device="cpu")
        assert default_ledger() is before


class TestWideWidth:
    def test_bench_width_digests_equal_the_pins(self):
        """BASELINE.json's "1000 tenants x 4 autoscalers multitenant"
        width (bench.py --multitenant's defaults) for 12 ticks: the
        port's digests equal the reference's, pinned."""
        got = PS.simulate_multitenant(tenants=1000, ticks=12, rows=4,
                                      metrics=2, seed=0, device="cpu")
        assert got["aggregate_replicas"] == WIDE_DIGESTS
        assert got["decide_dispatches"] == got["cost_dispatches"] == 12
        assert got["dispatch_amortization"] == 1000.0
        assert dataclasses.is_dataclass(PS.multitenant_fleet_inputs(
            0, 4, 2, 0, 0, np.full(4, 2, np.int32), 0.0))
