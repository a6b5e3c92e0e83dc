"""The port's joint pool-group allocation (karpenter_tpu_torch/ops/
poolgroup.py) == the reference's `poolgroup_jit` /
`poolgroup_independent_jit` and `poolgroup_numpy`, bitwise on every
output leaf, at P = 2, 3 and 4 pools, with slack couplings (the joint
point is the independent one, pool by pool the cost ladder's) and with
live ratio bands and budgets (the repair selection runs).
"""

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu.ops import poolgroup as RPG
from karpenter_tpu_torch.ops import cost as C
from karpenter_tpu_torch.ops import poolgroup as PG

from test_poolgroup import random_group_inputs
from test_torch_decision import assert_bitwise

REFERENCE = {True: RPG.poolgroup_jit, False: RPG.poolgroup_independent_jit}


def check(ref_inputs, enforce=True, context=""):
    port = PG.poolgroup_decide(
        PG.PoolGroupInputs.from_numpy(ref_inputs, "cpu"), enforce=enforce
    )
    ctx = f"{context} enforce={enforce}"
    assert_bitwise(port, REFERENCE[enforce](ref_inputs), f"jit {ctx}")
    assert_bitwise(
        port, RPG.poolgroup_numpy(ref_inputs, enforce=enforce), f"numpy {ctx}"
    )
    return port.to_numpy()


def slack(inputs):
    return dataclasses.replace(
        inputs,
        tier_penalty=np.zeros_like(inputs.tier_penalty),
        ratio_valid=np.zeros_like(inputs.ratio_valid),
        group_valid=np.zeros_like(inputs.group_valid),
    )


class TestPoolGroupParity:
    @pytest.mark.parametrize("enforce", [True, False])
    @pytest.mark.parametrize("g, p, m", [(8, 4, 2), (8, 2, 3), (4, 3, 1)])
    @pytest.mark.parametrize("seed", range(3))
    def test_live_bands(self, seed, g, p, m, enforce):
        check(random_group_inputs(seed, g, p, m), enforce, f"seed={seed} p={p}")

    def test_live_bands_repair_somewhere(self):
        repaired = 0
        for seed in range(4):
            out = check(random_group_inputs(seed, 8, 4, 2), True, f"seed={seed}")
            repaired += int(out["joint_repair"].sum())
        assert repaired > 0

    @pytest.mark.parametrize("p", [2, 4])
    def test_slack_is_the_per_pool_cost_ladder(self, p):
        """With every coupling slack the joint choice is each pool's
        independent one, and that is the port's own cost_decide on the
        flattened pools."""
        inputs = slack(random_group_inputs(5, 8, p, 3))
        out = check(inputs, True, "slack")
        assert not out["joint_repair"].any()
        indep = check(inputs, False, "slack")
        np.testing.assert_array_equal(out["desired"], indep["desired"])
        flat = C.cost_decide(C.CostInputs.from_numpy(
            {
                "base_desired": inputs.base_desired.reshape(-1),
                "min_replicas": inputs.min_replicas.reshape(-1),
                "max_replicas": inputs.max_replicas.reshape(-1),
                "unit_cost": inputs.unit_cost.reshape(-1),
                "slo_weight": inputs.slo_weight.reshape(-1),
                "max_hourly_cost": inputs.max_hourly_cost.reshape(-1),
                "slo_valid": inputs.pool_valid.reshape(-1),
                "slo_target": inputs.slo_target.reshape(-1, 3),
                "demand_mu": inputs.demand_mu.reshape(-1, 3),
                "demand_sigma": inputs.demand_sigma.reshape(-1, 3),
                "demand_valid": inputs.demand_valid.reshape(-1, 3),
            },
            "cpu",
        ))
        np.testing.assert_array_equal(
            out["desired"].reshape(-1), flat.desired.numpy()
        )

    def test_invalid_pools_pass_through(self):
        inputs = random_group_inputs(2)
        inputs = dataclasses.replace(
            inputs, pool_valid=np.zeros_like(inputs.pool_valid)
        )
        out = check(inputs)
        np.testing.assert_array_equal(out["desired"], inputs.base_desired)

    def test_repair_raises_a_pool_into_the_band(self):
        """decode:prefill >= 4:1 from (11, 40): the repair raises decode
        to 44; the independent rung keeps 40 and reports the violation."""
        g, p, m = 1, 2, 1
        inputs = RPG.PoolGroupInputs(
            base_desired=np.asarray([[11, 40]], np.int32),
            min_replicas=np.zeros((g, p), np.int32),
            max_replicas=np.full((g, p), 1000, np.int32),
            unit_cost=np.ones((g, p), np.float32),
            slo_weight=np.zeros((g, p), np.float32),
            max_hourly_cost=np.zeros((g, p), np.float32),
            tier_penalty=np.zeros((g, p), np.float32),
            pool_valid=np.ones((g, p), bool),
            slo_target=np.ones((g, p, m), np.float32),
            demand_mu=np.zeros((g, p, m), np.float32),
            demand_sigma=np.zeros((g, p, m), np.float32),
            demand_valid=np.zeros((g, p, m), bool),
            ratio_a=np.asarray([[1, 0, 0, 0]], np.int32),
            ratio_b=np.asarray([[0, 1, 1, 1]], np.int32),
            ratio_min_num=np.asarray([[4, 0, 0, 0]], np.int32),
            ratio_min_den=np.ones((g, PG.RATIO_SLOTS), np.int32),
            ratio_max_num=np.zeros((g, PG.RATIO_SLOTS), np.int32),
            ratio_max_den=np.zeros((g, PG.RATIO_SLOTS), np.int32),
            ratio_valid=np.asarray([[True, False, False, False]]),
            group_budget=np.zeros(g, np.float32),
            group_valid=np.asarray([True]),
        )
        out = check(inputs, True, "repair")
        assert out["desired"].tolist() == [[11, 44]]
        assert out["ratio_ok"][0] and out["joint_repair"][0]
        deg = check(inputs, False, "repair")
        assert deg["desired"].tolist() == [[11, 40]] and not deg["ratio_ok"][0]


class TestJointSpace:
    @pytest.mark.parametrize("p", [1, 2, 3, 4])
    def test_joint_digits(self, p):
        np.testing.assert_array_equal(
            PG.joint_digits(p).numpy(), RPG.joint_digits(p)
        )

    @pytest.mark.parametrize("pools", [0, 1, 2, 3, 4])
    def test_pad_pool_count(self, pools):
        assert PG.pad_pool_count(pools) == RPG.pad_pool_count(pools)

    def test_pad_pool_count_refuses_five(self):
        with pytest.raises(ValueError):
            PG.pad_pool_count(5)

    def test_constants(self):
        assert (PG.MAX_POOLS, PG.POOL_BUCKETS, PG.RATIO_SLOTS, PG.RATIO_BOUND) == (
            RPG.MAX_POOLS, RPG.POOL_BUCKETS, RPG.RATIO_SLOTS, RPG.RATIO_BOUND
        )
        assert C.CANDIDATES == 8 and torch.int32 == PG.I32
