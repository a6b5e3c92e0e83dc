"""Seeded draws of an HorizontalAutoscaler fleet's fused tick, frozen.

Copied from karpenter_tpu_torch/workloads.py at commit 958e1ec
(`_decision_fields`, `_poolgroup_fields`, `build_fused_tick_inputs`,
themselves the draw of bench.py's `_fusedtick_inputs` in the reference
package, with distinct series cells), so that a later change to the
program's workloads cannot move the benchmark's inputs. Edits: the
pool-group ratio slots are the constant 4 (`RATIO_SLOTS`, ops/poolgroup.py
of both packages) instead of an import of the program, and the seed may
be anything np.random.RandomState takes, a BitGenerator included (the
generator passes an MT19937 over a SeedSequence).

The fleet: n autoscalers x m metrics, s forecast series of t samples on
distinct (autoscaler, metric) cells, the cost group, and `groups` pool
groups of `pools` pools on distinct fleet rows.
"""

from __future__ import annotations

import numpy as np

RATIO_SLOTS = 4


def _decision_fields(r: np.random.RandomState, n: int, m: int, now: float):
    """A DecisionInputs fleet in bench.py::_fusedtick_inputs's draw order
    (also tests/test_fusedtick.py::mk_decision's): K = 2 policy slots."""
    k = 2
    return {
        "metric_value": r.uniform(0, 100, (n, m)).astype(np.float32),
        "target_value": r.uniform(1, 80, (n, m)).astype(np.float32),
        "target_type": r.randint(0, 3, (n, m)).astype(np.int32),
        "metric_valid": r.rand(n, m) > 0.2,
        "spec_replicas": r.randint(1, 20, n).astype(np.int32),
        "status_replicas": r.randint(1, 20, n).astype(np.int32),
        "min_replicas": r.randint(0, 3, n).astype(np.int32),
        "max_replicas": r.randint(20, 40, n).astype(np.int32),
        "up_window": r.randint(0, 60, n).astype(np.int32),
        "down_window": r.randint(0, 120, n).astype(np.int32),
        "up_policy": r.randint(0, 2, n).astype(np.int32),
        "down_policy": r.randint(0, 2, n).astype(np.int32),
        "last_scale_time": (now - r.uniform(0, 300, n)).astype(np.float32),
        "has_last_scale": r.rand(n) > 0.3,
        "now": np.float32(now),
        "up_ptype": r.randint(0, 3, (n, k)).astype(np.int32),
        "up_pvalue": r.randint(1, 10, (n, k)).astype(np.int32),
        "up_pperiod": r.randint(15, 120, (n, k)).astype(np.int32),
        "up_pvalid": r.rand(n, k) > 0.4,
        "down_ptype": r.randint(0, 3, (n, k)).astype(np.int32),
        "down_pvalue": r.randint(1, 10, (n, k)).astype(np.int32),
        "down_pperiod": r.randint(15, 120, (n, k)).astype(np.int32),
        "down_pvalid": r.rand(n, k) > 0.4,
    }


def _poolgroup_fields(r: np.random.RandomState, n, m, groups, pools):
    """PoolGroupOperands fields: per-pool fields drawn like
    bench.py::build_poolgroup_inputs, members on distinct fleet rows, and
    (unlike the bench, which keeps every coupling slack) a live ratio band
    on about half the groups and a shared budget on about a third, so the
    repair selection runs."""
    g, p = groups, pools
    shape, shape_m = (g, p), (g, p, m)
    ratio_a = np.zeros((g, RATIO_SLOTS), np.int32)
    ratio_b = np.zeros((g, RATIO_SLOTS), np.int32)
    ratio_valid = np.zeros((g, RATIO_SLOTS), bool)
    # slot 0: pool 1 : pool 0 within [2:1, 4:1]; slot 1 (P >= 3): pool 2 :
    # pool 0 at least 1:1
    ratio_a[:, 0], ratio_b[:, 0] = 1, 0
    ratio_valid[:, 0] = r.rand(g) < 0.5
    if p >= 3:
        ratio_a[:, 1], ratio_b[:, 1] = 2, 0
        ratio_valid[:, 1] = r.rand(g) < 0.3
    min_num = np.zeros((g, RATIO_SLOTS), np.int32)
    max_num = np.zeros((g, RATIO_SLOTS), np.int32)
    max_den = np.zeros((g, RATIO_SLOTS), np.int32)
    min_num[:, 0], max_num[:, 0], max_den[:, 0] = 2, 4, 1
    min_num[:, 1] = 1
    return {
        "member_row": r.choice(n, g * p, replace=False)
        .reshape(shape).astype(np.int32),
        "pg_min": r.randint(0, 3, shape).astype(np.int32),
        "pg_max": r.randint(20, 40, shape).astype(np.int32),
        "unit_cost": r.choice([0.07, 0.19, 1.0, 4.8], shape).astype(np.float32),
        "slo_weight": r.choice([0.0, 5.0, 50.0, 500.0], shape).astype(np.float32),
        "max_hourly_cost": r.choice([0.0, 25.0, 250.0], shape).astype(np.float32),
        "tier_penalty": r.choice([0.0, 0.1, 2.0], shape).astype(np.float32),
        "pool_valid": r.rand(*shape) > 0.05,
        "slo_target": r.uniform(0.5, 10, shape_m).astype(np.float32),
        "observed": r.uniform(0, 1000, shape_m).astype(np.float32),
        "demand_base_valid": r.rand(*shape_m) > 0.1,
        "prior_point": r.uniform(0, 1000, shape_m).astype(np.float32),
        "prior_sigma2": r.choice([0.0, 25.0, 2500.0], shape_m).astype(np.float32),
        "prior_valid": r.rand(*shape_m) > 0.5,
        "ratio_a": ratio_a,
        "ratio_b": ratio_b,
        "ratio_min_num": min_num,
        "ratio_min_den": np.ones((g, RATIO_SLOTS), np.int32),
        "ratio_max_num": max_num,
        "ratio_max_den": max_den,
        "ratio_valid": ratio_valid,
        "group_budget": np.where(
            r.rand(g) < 0.35, r.uniform(50, 400, g), 0.0
        ).astype(np.float32),
        "group_valid": r.rand(g) > 0.05,
    }


def build_fused_tick_inputs(
    seed, n: int, m: int, s: int, t: int, groups: int = 0, pools: int = 4
) -> dict:
    """FusedTickInputs fields with every stage present: a fleet of n
    autoscalers x m metrics, s forecast series of t samples, the cost
    group, and `groups` pool groups of `pools` pools (none when 0).

    Drawn like bench.py::_fusedtick_inputs (np.random.RandomState(seed),
    the same calls in the same order), except that the live series take
    DISTINCT (row, col) cells, drawn without replacement, as production's
    forecast engine emits one series per (autoscaler, metric): the bench
    draws rows and columns independently, so two series may share a cell
    (s <= n * m is required here)."""
    r = np.random.RandomState(seed)
    now = 1000.0
    decision = _decision_fields(r, n, m, now)
    forecast = {
        "values": r.uniform(0, 100, (s, t)).astype(np.float32),
        "valid": r.rand(s, t) > 0.2,
        "times": np.cumsum(r.uniform(10, 20, (s, t)), 1).astype(np.float32),
        "weights": np.ones((s, t), np.float32),
        "horizon": np.full(s, 60.0, np.float32),
        "step_s": np.full(s, 15.0, np.float32),
        "model": r.randint(0, 2, s).astype(np.int32),
        "season": np.full(s, 4, np.int32),
        "alpha": np.full(s, 0.5, np.float32),
        "beta": np.full(s, 0.1, np.float32),
        "gamma": np.full(s, 0.1, np.float32),
    }
    cells = r.choice(n * m, s, replace=False)
    fields = {
        "decision": decision,
        "forecast": forecast,
        "series_row": (cells // m).astype(np.int32),
        "series_col": (cells % m).astype(np.int32),
        "series_need": np.full(s, 2, np.int32),
        "series_blend": r.rand(s) > 0.3,
        "ha_min": r.randint(0, 3, n).astype(np.int32),
        "ha_max": r.randint(20, 40, n).astype(np.int32),
        "unit_cost": r.uniform(0.1, 3.0, n).astype(np.float32),
        "slo_weight": r.uniform(0, 2, n).astype(np.float32),
        "max_hourly_cost": r.uniform(5, 50, n).astype(np.float32),
        "slo_valid": r.rand(n) > 0.4,
        "slo_target": r.uniform(1, 80, (n, m)).astype(np.float32),
        "observed": r.uniform(0, 100, (n, m)).astype(np.float32),
        "demand_base_valid": r.rand(n, m) > 0.3,
        "prior_point": r.uniform(0, 100, (n, m)).astype(np.float32),
        "prior_sigma2": r.uniform(0, 10, (n, m)).astype(np.float32),
        "prior_valid": r.rand(n, m) > 0.5,
        "poolgroup": None,
    }
    if groups:
        fields["poolgroup"] = _poolgroup_fields(r, n, m, groups, pools)
    return fields
