"""The port's SimLab (karpenter_tpu_torch/simlab) against the reference's,
on the CPU: the trail generators, the gym envs, the policy search, the
scenario registry and its catalog, the doc-drift check against
docs/simulator.md, and the provenance label stream.

The port's envs step through a CPU SolverService (the tensor programs of
ops/simstep.py on the `torch` rung, or the numpy mirror); the reference's
through its own service (JAX on the CPU), as its tests run it.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import os
import re
from argparse import Namespace

import numpy as np
import pytest

from karpenter_tpu import simlab as RSL
from karpenter_tpu.metrics.registry import GaugeRegistry as RefRegistry
from karpenter_tpu.simlab import policy as RPOL
from karpenter_tpu.solver.service import SolverService as RefService
from karpenter_tpu_torch import simlab as SL
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.simlab import builtin as B
from karpenter_tpu_torch.simlab import policy as POL
from karpenter_tpu_torch.solver.service import SolverService

F32 = np.float32
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = tuple(RSL.scenarios())


@pytest.fixture(scope="module")
def svc():
    service = SolverService(registry=GaugeRegistry(), device="cpu")
    try:
        yield service
    finally:
        service.close()


@pytest.fixture(scope="module")
def ref_svc():
    service = RefService(registry=RefRegistry())
    try:
        yield service
    finally:
        service.close()


def trails_equal(a, b) -> bool:
    return all(
        np.asarray(getattr(a, f)).tobytes() == np.asarray(getattr(b, f)).tobytes()
        and np.asarray(getattr(a, f)).shape == np.asarray(getattr(b, f)).shape
        for f in ("demand", "forecast", "price", "fault", "replicas0")
    )


# -- trails ------------------------------------------------------------------


class TestTrails:
    @pytest.mark.parametrize("name", NAMES)
    def test_scenario_trails_equal_the_reference(self, name):
        port, ref = SL.get_scenario(name), RSL.get_scenario(name)
        assert port.params == SL.SimParams(**dataclasses.asdict(ref.params))
        for seed in (0, 7):
            assert trails_equal(port.trails(seed), ref.trails(seed)), seed

    @pytest.mark.parametrize("kwargs", [
        dict(ticks=16, rows=3),
        dict(ticks=40, rows=5, spike=30.0, price_spike=2.0,
             fault_probability=0.5),
        dict(ticks=24, rows=2, diurnal=True, amplitude=80.0, base=2.0),
    ], ids=["plain", "spiky", "diurnal"])
    def test_make_trails_equals_the_reference(self, kwargs):
        ref = importlib.import_module("karpenter_tpu.simlab.builtin")
        for seed in (1, 2):
            assert trails_equal(B.make_trails(seed, **kwargs),
                                ref.make_trails(seed, **kwargs))


# -- gym envs ------------------------------------------------------------------


class TestSimEnv:
    def test_replay_twice_is_identical(self, svc):
        env = SL.SimEnv(SL.get_scenario("forecast").trails, seed=3,
                        service=svc)
        first, second = env.run(), env.run()
        for key in ("reward", "violation_ticks", "hourly_cost"):
            assert first[key] == second[key]
        np.testing.assert_array_equal(first["final_replicas"],
                                      second["final_replicas"])

    def test_distinct_seeds_draw_distinct_episodes(self, svc):
        env = SL.SimEnv(SL.get_scenario("forecast").trails, seed=3,
                        service=svc)
        a = env.run()
        env.reset(seed=4)
        assert a["reward"] != env.run(reset=False)["reward"]

    def test_unusable_actions_fall_back_to_reactive(self, svc):
        env = SL.SimEnv(SL.get_scenario("cost").trails, seed=1, service=svc)
        assert env.step(np.zeros(3, F32))[3]["reactive_fallback"]
        assert env.step(np.full(env.trails.rows, np.nan, F32))[3][
            "reactive_fallback"]
        assert not env.step(None)[3]["reactive_fallback"]

    def test_step_after_done_raises(self, svc):
        env = SL.SimEnv(lambda seed: B.make_trails(seed, ticks=2, rows=2),
                        seed=0, service=svc)
        env.run()
        with pytest.raises(RuntimeError, match="done"):
            env.step(None)

    @pytest.mark.parametrize("name,policy", [
        ("forecast", "tuned"), ("cost", "reactive"), ("preempt", "tuned"),
    ])
    def test_episode_equals_the_reference(self, svc, ref_svc, name, policy):
        def make(module, pol):
            return (pol.SearchTunedPolicy(pol.FROZEN_KNOBS)
                    if policy == "tuned" else pol.ReactivePolicy())

        port = SL.SimEnv(SL.get_scenario(name).trails, seed=5, service=svc,
                         backend="torch").run(make(SL, POL))
        ref = RSL.SimEnv(RSL.get_scenario(name).trails, seed=5,
                         service=ref_svc, backend="xla").run(make(RSL, RPOL))
        for key in ("reward", "violation_ticks", "hourly_cost", "backlog",
                    "policy_faults", "reactive_fallbacks"):
            assert port[key] == ref[key], key
        assert port["final_replicas"].tobytes() == ref["final_replicas"].tobytes()


class TestBatchedEnv:
    def test_rollout_equals_sequential_gym_loops(self, svc):
        trails_fn = SL.get_scenario("forecast").trails
        out = SL.BatchedSimEnv(trails_fn, clusters=3, seed=3, service=svc,
                               backend="torch").rollout(POL.FROZEN_KNOBS)
        for i in range(3):
            run = SL.SimEnv(trails_fn, seed=3 + i, service=svc).run(
                POL.SearchTunedPolicy(POL.FROZEN_KNOBS))
            np.testing.assert_array_equal(out["final_replicas"][i],
                                          run["final_replicas"])
            assert run["reward"] == pytest.approx(float(out["rewards"][i]),
                                                  rel=1e-9)

    @pytest.mark.parametrize("name", ["cost", "restart-storm"])
    def test_rollout_equals_the_reference(self, svc, ref_svc, name):
        knobs = np.asarray([[0, 0, 0], [1, 0.5, 2], [1.25, 1, 4],
                            [0.5, 0.25, 0]], F32)
        port = SL.BatchedSimEnv(SL.get_scenario(name).trails, clusters=4,
                                seed=2, service=svc, backend="torch"
                                ).rollout(knobs)
        ref = RSL.BatchedSimEnv(RSL.get_scenario(name).trails, clusters=4,
                                seed=2, service=ref_svc, backend="xla"
                                ).rollout(knobs)
        for key in ("rewards", "violation_ticks", "hourly_cost", "backlog",
                    "final_replicas"):
            assert np.asarray(port[key]).tobytes() == np.asarray(ref[key]).tobytes(), key

    def test_step_loop_equals_the_reference(self, svc, ref_svc):
        name, clusters = "poolgroups", 5
        port = SL.BatchedSimEnv(SL.get_scenario(name).trails,
                                clusters=clusters, seed=9, service=svc,
                                backend="torch")
        ref = RSL.BatchedSimEnv(RSL.get_scenario(name).trails,
                                clusters=clusters, seed=9, service=ref_svc,
                                backend="xla")
        t = 0
        while not port.done:
            obs = port._obs()
            action = None if t % 3 else (
                np.ceil(obs["demand"] / F32(4.0)) + F32(t % 2))
            got, want = port.step(action), ref.step(action)
            assert got[1].tobytes() == want[1].tobytes(), t
            assert got[0]["replicas"].tobytes() == want[0]["replicas"].tobytes()
            for key in ("violation_rows", "hourly_cost", "backlog"):
                assert got[3][key].tobytes() == want[3][key].tobytes(), key
            t += 1
        assert ref.done and t == port.ticks

    def test_reactive_knobs_are_the_reactive_baseline(self, svc):
        trails_fn = SL.get_scenario("cost").trails
        kernel = SL.SimEnv(trails_fn, seed=2, service=svc).run(
            POL.SearchTunedPolicy(POL.REACTIVE_KNOBS))
        reactive = SL.SimEnv(trails_fn, seed=2, service=svc).run(
            POL.ReactivePolicy())
        assert kernel["reward"] == reactive["reward"]
        np.testing.assert_array_equal(kernel["final_replicas"],
                                      reactive["final_replicas"])


class _FlakyPolicy:
    def __init__(self):
        self._t = 0

    def reset(self):
        self._t = 0

    def act(self, obs):
        self._t += 1
        if self._t % 5 == 1:
            raise RuntimeError("injected policy fault")
        if self._t % 5 == 3:
            return np.full_like(obs["replicas"], np.nan)
        return None


class TestNeverBlockFuzz:
    def test_every_scenario_survives_random_faults_and_recovers(self, svc):
        for fuzz_seed, (name, sc) in enumerate(SL.scenarios().items()):
            def fuzzed(seed, sc=sc, fuzz_seed=fuzz_seed):
                trails = sc.trails(seed)
                rng = np.random.default_rng(1000 + fuzz_seed)
                tail = max(1, trails.ticks // 4)
                fault = (rng.random(trails.ticks) < 0.3).astype(F32)
                fault[trails.ticks - tail:] = 0.0
                return dataclasses.replace(trails, fault=fault)

            env = SL.SimEnv(fuzzed, params=sc.params, seed=11, service=svc,
                            backend="torch")
            run = env.run(_FlakyPolicy())
            assert run["policy_faults"] > 0 and run["reactive_fallbacks"] > 0
            p = sc.params
            expected = np.clip(np.ceil(env.trails.demand[-1] / F32(p.cap)),
                               F32(p.min_replicas), F32(p.max_replicas))
            np.testing.assert_array_equal(run["final_replicas"],
                                          expected.astype(F32), err_msg=name)


# -- policy search -------------------------------------------------------------


@pytest.fixture(scope="module")
def searches(svc, ref_svc):
    """{(scenario, seed): (port result, reference result)}."""
    out = {}
    for name, seed in (("forecast", 3), ("cost", 0)):
        out[(name, seed)] = (
            POL.search_tuned_policy(SL.get_scenario(name).trails, seed=seed,
                                    service=svc, backend="torch"),
            RPOL.search_tuned_policy(RSL.get_scenario(name).trails,
                                     seed=seed, service=ref_svc,
                                     backend="xla"),
        )
    return out


class TestPolicySearch:
    @pytest.mark.parametrize("key", [("forecast", 3), ("cost", 0)])
    def test_winner_and_every_reward_equal_the_reference(self, searches, key):
        port, ref = searches[key]
        assert port.knobs.tobytes() == ref.knobs.tobytes()
        assert port.rewards == ref.rewards
        assert (port.reward, port.baseline_reward, port.candidates,
                port.dispatches) == (ref.reward, ref.baseline_reward,
                                     ref.candidates, ref.dispatches)

    def test_search_beats_reactive_pinned(self, searches):
        result = searches[("forecast", 3)][0]
        assert tuple(float(k) for k in result.knobs) == (1.0, 0.0, 4.0)
        assert result.margin > 0 and result.dispatches == 2
        assert tuple(float(k) for k in POL.REACTIVE_KNOBS) in result.rewards

    def test_baseline_reward_is_the_reactive_gym_reward(self, svc):
        trails_fn = SL.get_scenario("forecast").trails
        result = POL.search_tuned_policy(trails_fn, seed=3, service=svc,
                                         refine=False)
        reactive = SL.SimEnv(trails_fn, seed=3, service=svc).run(
            POL.ReactivePolicy())
        assert result.baseline_reward == pytest.approx(reactive["reward"],
                                                       rel=1e-9)

    def test_winner_replays_its_searched_score(self, svc, searches):
        result = searches[("forecast", 3)][0]
        run = SL.SimEnv(SL.get_scenario("forecast").trails, seed=3,
                        service=svc).run(result.policy())
        assert run["reward"] == pytest.approx(result.reward, rel=1e-9)

    def test_broken_policy_degrades_to_the_reactive_episode(self, svc):
        class Boom:
            def reset(self):
                pass

            def act(self, obs):
                raise RuntimeError("always broken")

        env = SL.SimEnv(SL.get_scenario("cost").trails, seed=1, service=svc)
        broken, reactive = env.run(Boom()), env.run(None)
        assert broken["policy_faults"] == env.trails.ticks
        assert broken["reward"] == reactive["reward"]

    def test_grid_and_constants_equal_the_reference(self):
        assert POL._grid_candidates().tobytes() == \
            RPOL._grid_candidates().tobytes()
        assert POL._refine_candidates(POL.FROZEN_KNOBS).tobytes() == \
            RPOL._refine_candidates(RPOL.FROZEN_KNOBS).tobytes()
        assert POL.FROZEN_KNOBS.tobytes() == RPOL.FROZEN_KNOBS.tobytes()
        assert POL.KNOB_NAMES == RPOL.KNOB_NAMES

    def test_the_live_algorithm_reads_the_policy_planes_knobs(self):
        from karpenter_tpu_torch.autoscaler.algorithms import simlab_policy

        algo = simlab_policy.SimlabPolicy()
        assert (algo.blend_floor, algo.cost_weight, algo.stab_window) == \
            tuple(float(k) for k in POL.FROZEN_KNOBS)


# -- registry ------------------------------------------------------------------


def cli_args(**over):
    base = dict(
        trace_export=None, constraints=False, eventloop=False,
        multitenant=False, poolgroups=False, cost=False, forecast=False,
        restart_storm=False, failover=False, preempt=False,
        consolidate=False, what_if=None, sim_seed=None,
    )
    base.update(over)
    return Namespace(**base)


SELECTIONS = [
    {}, {"constraints": True}, {"constraints": True, "cost": True},
    {"trace_export": "t.jsonl", "cost": True}, {"trace_export": "t.jsonl"},
    {"eventloop": True}, {"multitenant": True}, {"poolgroups": True},
    {"forecast": True, "preempt": True}, {"restart_storm": True},
    {"failover": True}, {"preempt": True}, {"consolidate": True},
    {"what_if": "w.json"}, {"consolidate": True, "what_if": "w.json"},
    {"trace_export": "t.jsonl", "consolidate": True},
]


class TestScenarioRegistry:
    def test_catalog_names_and_order_equal_the_reference(self):
        assert tuple(SL.scenarios()) == NAMES
        assert SL.catalog() == RSL.catalog()

    def test_catalog_text_equals_the_reference_byte_for_byte(self):
        assert SL.catalog_text() == RSL.catalog_text()

    @pytest.mark.parametrize("over", SELECTIONS,
                             ids=[",".join(sorted(o)) or "none"
                                  for o in SELECTIONS])
    def test_selection_precedence_equals_the_reference(self, over):
        assert SL.select_for(cli_args(**over)).name == \
            RSL.select_for(cli_args(**over)).name

    def test_scenario_records_equal_the_reference(self):
        for name in NAMES:
            port, ref = SL.get_scenario(name), RSL.get_scenario(name)
            assert (port.description, port.flags, port.order, port.seeded,
                    port.default_seed) == (ref.description, ref.flags,
                                           ref.order, ref.seeded,
                                           ref.default_seed), name

    def test_duplicate_registration_rejected(self):
        with pytest.raises(ValueError, match="already registered"):
            SL.register_scenario(SL.Scenario(
                name="cost", description="dup", flags="--cost", order=999,
                select=lambda a: False, run=lambda a, s: 0,
            ))

    def test_unknown_scenario_lists_the_known(self):
        with pytest.raises(KeyError, match="registered:"):
            SL.get_scenario("nope")

    def test_resolved_seed(self):
        assert B._resolved_seed(cli_args(), 7) == 7
        assert B._resolved_seed(cli_args(sim_seed=8), 7) == 8


class TestDocDrift:
    """docs/simulator.md's catalog table <-> the port's registry, both
    directions (the reference's TestDocDrift, on the port)."""

    @staticmethod
    def _doc_rows():
        text = open(os.path.join(REPO_ROOT, "docs", "simulator.md")).read()
        body = text.split("## Scenario registry", 1)[1].split("\n## ", 1)[0]
        rows = {}
        for match in re.finditer(
            r"^\| `([a-z-]+)` \| ([^|]+) \| ([^|]+) \| ([^|]+) \|",
            body, re.MULTILINE,
        ):
            rows[match.group(1)] = (match.group(2).strip().strip("`"),
                                    match.group(3).strip().strip("`"))
        assert rows
        return rows

    def test_every_registered_scenario_is_documented(self):
        assert not set(SL.scenarios()) - set(self._doc_rows())

    def test_every_documented_scenario_is_registered(self):
        assert not set(self._doc_rows()) - set(SL.scenarios())

    def test_flags_and_seededness_agree(self):
        rows = self._doc_rows()
        for name, _desc, flags, seeded in SL.catalog():
            assert rows[name] == (flags, "--sim-seed" if seeded else "fixed")


# -- labels ----------------------------------------------------------------------


class _FakeLedger:
    def __init__(self, records):
        self._records = records

    def query(self, kind=None, tenant=None, limit=None):
        return list(self._records)


RECORDS = [
    {"prev_replicas": 3, "base_desired": 5, "forecast_value": None,
     "forecast_skill": 0.9, "cost_hourly": 1.5, "cost_risk": None,
     "observed": [7.0], "final_desired": 4, "winning_stage": "reactive",
     "kind": "ha", "tenant": "blue", "name": "web", "group": "tpu"},
    {"prev_replicas": None, "base_desired": 2, "forecast_value": 6.5,
     "forecast_skill": None, "cost_hourly": None, "cost_risk": 0.25,
     "observed": [1.0, 2.0, 3.0, 4.0, 5.0], "final_desired": 9,
     "winning_stage": "nope", "kind": "ha", "tenant": "", "name": "api",
     "group": ""},
]


class TestLabels:
    def test_stage_index_equals_the_reference(self):
        from karpenter_tpu_torch.observability.provenance import STAGES

        for i, stage in enumerate(STAGES):
            assert SL.stage_index(stage) == i == RSL.stage_index(stage)
        assert SL.stage_index("unknown") == SL.stage_index(None) == -1

    def test_label_stream_equals_the_reference(self):
        ledger = _FakeLedger(RECORDS)
        port, ref = SL.label_stream(ledger), RSL.label_stream(ledger)
        assert len(port) == len(ref) == 2
        for got, want in zip(port, ref):
            assert len(got["features"]) == len(want["features"])
            for a, b in zip(got["features"], want["features"]):
                assert a == b or (math.isnan(a) and math.isnan(b))
            for key in ("label_desired", "label_stage", "stage", "kind",
                        "tenant", "name", "group"):
                assert got[key] == want[key], key
        from karpenter_tpu.simlab.labels import FEATURE_NAMES as REF_NAMES
        from karpenter_tpu_torch.simlab.labels import FEATURE_NAMES

        assert FEATURE_NAMES == REF_NAMES
        assert port[0]["features"][6] == 7.0 and math.isnan(
            port[0]["features"][7])

    def test_label_stream_over_the_process_ledger(self):
        from karpenter_tpu_torch.observability import (
            default_ledger,
            reset_default_ledger,
            set_default_ledger,
        )

        saved = default_ledger()
        try:
            ledger = reset_default_ledger(enabled=True)
            assert SL.label_stream() == [] == SL.label_stream(ledger)
        finally:
            set_default_ledger(saved)
