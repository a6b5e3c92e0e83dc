"""The port's cost ladder (karpenter_tpu_torch/ops/cost.py) == the
reference's `cost_jit` and `cost_numpy`, bitwise, on the reference
tests' seeded fleets (tests/test_cost.py::random_inputs) and on the
wire-compat cases: rows without an SLO pass through, weight 0 keeps
candidate 0, the budget caps the ladder but not below minReplicas.
"""

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu.ops import cost as RC
from karpenter_tpu_torch.ops import cost as C

from test_cost import make_inputs, random_inputs
from test_torch_decision import assert_bitwise


def check(ref_inputs, context=""):
    """The port's outputs on `ref_inputs`, held against both reference
    programs."""
    port = C.cost_decide(C.CostInputs.from_numpy(ref_inputs, "cpu"))
    assert_bitwise(port, RC.cost_jit(ref_inputs), f"jit {context}")
    assert_bitwise(port, RC.cost_numpy(ref_inputs), f"numpy {context}")
    return port.to_numpy()


class TestCostParity:
    @pytest.mark.parametrize("seed", range(6))
    def test_random_fleets(self, seed):
        check(random_inputs(seed, n=64, m=3), f"seed={seed}")

    def test_invalid_rows_pass_through(self):
        inputs = random_inputs(3, n=64, m=3)
        inputs = dataclasses.replace(
            inputs, slo_valid=np.zeros_like(inputs.slo_valid)
        )
        out = check(inputs, "slo_valid False")
        np.testing.assert_array_equal(out["desired"], inputs.base_desired)
        assert not out["slo_raised"].any() and not out["cost_limited"].any()
        assert (out["violation_risk"] == 0).all() and (out["headroom"] == 0).all()

    def test_zero_weight_keeps_candidate_zero(self):
        """weight 0 scores flat-or-rising, and argmin keeps the first
        index on ties: the base decision (candidate 0) wins."""
        inputs = random_inputs(4, n=64, m=3)
        inputs = dataclasses.replace(
            inputs,
            slo_weight=np.zeros_like(inputs.slo_weight),
            max_hourly_cost=np.zeros_like(inputs.max_hourly_cost),
            min_replicas=np.zeros_like(inputs.min_replicas),
        )
        out = check(inputs, "weight 0")
        np.testing.assert_array_equal(out["desired"], inputs.base_desired)

    def test_flat_scores_tie_to_the_first_index(self):
        """Unit cost 0 and weight 0: every candidate scores 0."""
        out = check(make_inputs(unit_cost=np.asarray([0.0], np.float32)))
        assert out["desired"][0] == 10

    def test_budget_cap_trims_but_keeps_min(self):
        out = check(make_inputs(
            base_desired=np.asarray([20], np.int32),
            max_hourly_cost=np.asarray([8.0], np.float32),  # caps at 8
        ), "capped")
        assert out["desired"][0] == 8 and out["cost_limited"][0]
        out = check(make_inputs(
            base_desired=np.asarray([20], np.int32),
            min_replicas=np.asarray([12], np.int32),
            max_hourly_cost=np.asarray([8.0], np.float32),
        ), "below min")
        assert out["desired"][0] == 12

    def test_risk_buys_replicas(self):
        out = check(make_inputs(
            slo_weight=np.asarray([100.0], np.float32),
            demand_mu=np.asarray([[56.0]], np.float32),  # needs 14
        ), "risk")
        assert out["desired"][0] == 14 and out["slo_raised"][0]
        assert out["violation_risk"][0] == 0.0

    def test_headroom_reports_one_sigma_surplus(self):
        out = check(make_inputs(
            demand_mu=np.asarray([[48.0]], np.float32),
            demand_sigma=np.asarray([[16.0]], np.float32),
        ), "headroom")
        assert out["headroom"][0] == 6  # ceil(64 / 4) - 10

    def test_argmin_keeps_the_first_index(self):
        score = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.0, 0.0, 0.0, 0.0]])
        assert torch.argmin(score, dim=1).tolist() == [1, 0]
