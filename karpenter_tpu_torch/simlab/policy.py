"""The SimLab policy plane (docs/simulator.md "Policy search").

A `Policy` maps the gym observation (columnar fleet state) to per-HA
replica targets. Three implementations:

  ReactivePolicy     chase last observed demand — the same f32 math as
                     the in-kernel policy at knobs (0, 0, 0), so it is
                     the shared baseline for every comparison.
  SearchTunedPolicy  the in-kernel 3-knob decision surface
                     (ops/simstep.py `_policy_math`) evaluated on host
                     tick by tick — bit-identical to what the batched
                     rollout scored, so a searched knob vector behaves
                     in `SimEnv.step` exactly as it did in search.
  search_tuned_policy  the search itself: a deterministic knob grid
                     plus one perturbation-refinement round, every
                     candidate population evaluated against ONE shared
                     seeded episode as a single batched rollout
                     dispatch (`BatchedSimEnv(share_trails=True)`), the
                     reactive knobs always in the population so the
                     winner's margin over the baseline is part of the
                     result.

The frozen winner slots into the live runtime as the `simlab`
algorithm (autoscaler/algorithms/simlab_policy.py) behind the
never-block contract; `FROZEN_KNOBS` is the shipped default vector.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Protocol

import numpy as np

from karpenter_tpu_torch.ops.simstep import (
    KNOB_BLEND_FLOOR,
    KNOB_COST_WEIGHT,
    KNOB_STAB_WINDOW,
    KNOBS,
    _policy_math,
)
from karpenter_tpu_torch.simlab.env import BatchedSimEnv, SimParams

_F32 = np.float32

KNOB_NAMES = ("blend_floor", "cost_weight", "stab_window")

# knobs (0,0,0) IS the reactive baseline (ops/simstep.py docstring)
REACTIVE_KNOBS = np.zeros(KNOBS, _F32)
# the shipped default for the live `simlab` algorithm: provision to the
# full forecast preview, shed half the spike-priced surplus, hold
# scale-downs for two ticks — the grid winner on the forecast scenario
FROZEN_KNOBS = np.asarray([1.0, 0.5, 2.0], _F32)

# the deterministic search grid (4 x 4 x 3 = 48 candidates + reactive)
GRID_BLEND_FLOOR = (0.0, 0.5, 1.0, 1.25)
GRID_COST_WEIGHT = (0.0, 0.25, 0.5, 1.0)
GRID_STAB_WINDOW = (0.0, 2.0, 4.0)
# perturbation deltas for the refinement round, per knob
_REFINE_DELTAS = ((-0.25, 0.0, 0.25), (-0.125, 0.0, 0.125), (-1.0, 0.0, 1.0))


class Policy(Protocol):
    """observe -> per-HA replica targets (f32[R]); `reset()` clears any
    episode-local state before a fresh rollout."""

    def act(self, obs: dict) -> np.ndarray: ...

    def reset(self) -> None: ...


class ReactivePolicy:
    """The baseline: ceil(last observed demand / cap), clipped."""

    def __init__(self, params: Optional[SimParams] = None):
        self.params = params if params is not None else SimParams()

    def reset(self) -> None:
        pass

    def act(self, obs: dict) -> np.ndarray:
        p = self.params
        raw = np.ceil(np.asarray(obs["demand"], _F32) / _F32(p.cap))
        return np.clip(
            raw, _F32(p.min_replicas), _F32(p.max_replicas)
        ).astype(_F32)


class SearchTunedPolicy:
    """The 3-knob tuned policy on host: each `act` runs the SAME f32
    `_policy_math` the batched search rollout ran in-kernel, carrying
    the scale-down streak as episode state — so the frozen winner's
    gym-loop behavior is bit-identical to its searched score."""

    def __init__(
        self, knobs=FROZEN_KNOBS, params: Optional[SimParams] = None
    ):
        self.knobs = np.asarray(knobs, _F32)
        if self.knobs.shape != (KNOBS,):
            raise ValueError(
                f"knobs must be f32[{KNOBS}], got {self.knobs.shape}"
            )
        self.params = params if params is not None else SimParams()
        self._streak: Optional[np.ndarray] = None

    def reset(self) -> None:
        self._streak = None

    def act(self, obs: dict) -> np.ndarray:
        p = self.params
        replicas = np.asarray(obs["replicas"], _F32)
        if self._streak is None or self._streak.shape != replicas.shape:
            self._streak = np.zeros_like(replicas)
        scalars = SimpleNamespace(
            cap=_F32(p.cap),
            min_replicas=_F32(p.min_replicas),
            max_replicas=_F32(p.max_replicas),
        )
        target, self._streak = _policy_math(
            np,
            self.knobs,
            np.asarray(obs["demand"], _F32),
            np.asarray(obs["forecast"], _F32),
            np.asarray(_F32(obs["price"])),
            replicas,
            self._streak,
            scalars,
        )
        return np.asarray(target, _F32)

    @property
    def blend_floor(self) -> float:
        return float(self.knobs[KNOB_BLEND_FLOOR])

    @property
    def cost_weight(self) -> float:
        return float(self.knobs[KNOB_COST_WEIGHT])

    @property
    def stab_window(self) -> float:
        return float(self.knobs[KNOB_STAB_WINDOW])


@dataclass
class SearchResult:
    """One search's outcome: the winning knob vector, its composite
    reward on the search episode, the reactive baseline's reward on the
    SAME episode, and how much work the search did."""

    knobs: np.ndarray  # f32[3] winner
    reward: float  # winner's composite reward (higher is better)
    baseline_reward: float  # reactive knobs on the same episode
    candidates: int  # total knob vectors evaluated
    dispatches: int  # batched rollout dispatches (one per round)
    rewards: dict  # {knob-tuple: reward} for every candidate

    @property
    def margin(self) -> float:
        return self.reward - self.baseline_reward

    def policy(self, params: Optional[SimParams] = None) -> SearchTunedPolicy:
        return SearchTunedPolicy(self.knobs, params=params)


def _grid_candidates() -> np.ndarray:
    rows = [
        (bf, cw, sw)
        for bf in GRID_BLEND_FLOOR
        for cw in GRID_COST_WEIGHT
        for sw in GRID_STAB_WINDOW
    ]
    return np.asarray(rows, _F32)


def _refine_candidates(winner: np.ndarray) -> np.ndarray:
    """Deterministic perturbation neighborhood around the grid winner
    (all knobs floored at 0 — negative floors/weights/windows have no
    meaning in the kernel)."""
    rows = [
        (
            winner[KNOB_BLEND_FLOOR] + d0,
            winner[KNOB_COST_WEIGHT] + d1,
            winner[KNOB_STAB_WINDOW] + d2,
        )
        for d0 in _REFINE_DELTAS[0]
        for d1 in _REFINE_DELTAS[1]
        for d2 in _REFINE_DELTAS[2]
    ]
    return np.clip(np.asarray(rows, _F32), 0.0, None)


def _evaluate(env: BatchedSimEnv, candidates: np.ndarray) -> np.ndarray:
    """Per-candidate composite rewards: the whole population rides ONE
    batched rollout dispatch (every cluster shares the episode, only
    the knob rows differ)."""
    return np.asarray(env.rollout(candidates)["rewards"], np.float64)


def search_tuned_policy(
    trails_fn,
    seed: int = 0,
    params: Optional[SimParams] = None,
    service=None,
    backend: Optional[str] = None,
    refine: bool = True,
) -> SearchResult:
    """Grid search + one perturbation-refinement round over the 3-knob
    surface against one shared seeded episode (module docstring).
    Deterministic end to end: the grid, the episode, and the refinement
    neighborhood are all pure functions of `seed`."""
    params = params if params is not None else SimParams()
    grid = np.concatenate([REACTIVE_KNOBS[None, :], _grid_candidates()])
    rewards: dict = {}
    dispatches = 0

    def run_round(candidates: np.ndarray) -> None:
        nonlocal dispatches
        env = BatchedSimEnv(
            trails_fn,
            clusters=len(candidates),
            params=params,
            seed=seed,
            service=service,
            backend=backend,
            share_trails=True,
        )
        scores = _evaluate(env, candidates)
        dispatches += 1
        for knobs, score in zip(candidates, scores):
            rewards[tuple(float(k) for k in knobs)] = float(score)

    run_round(grid)
    if refine:
        best = max(rewards, key=lambda k: rewards[k])
        run_round(_refine_candidates(np.asarray(best, _F32)))

    best = max(rewards, key=lambda k: rewards[k])
    baseline = rewards[tuple(float(k) for k in REACTIVE_KNOBS)]
    return SearchResult(
        knobs=np.asarray(best, _F32),
        reward=rewards[best],
        baseline_reward=baseline,
        candidates=len(rewards),
        dispatches=dispatches,
        rewards=rewards,
    )
