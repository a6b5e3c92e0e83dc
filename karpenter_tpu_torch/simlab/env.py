"""SimEnv / BatchedSimEnv: the gym-style core of SimLab.

A simulated cluster is columnar state — per-HA-row replica counts —
driven by precomputed SEEDED TRAILS (demand, a forecast preview, a
price-multiplier schedule, and a fault schedule drawn from the chaos
registry). Precomputing the trails at reset() is what keeps the step a
PURE array program (ops/simstep.py): deterministic under the seed,
bit-identical between the device path and the numpy mirror, and
trivially batchable — `BatchedSimEnv` stacks N independently-seeded
clusters and advances them as ONE dispatch through the SolverService
seam (coalescing + health FSM + tracing for free, the standing
constraint every device-touching subsystem honors).

The gym contract (docs/simulator.md):

  obs                  = reset(seed)        # columnar fleet state
  obs, r, done, info   = step(action)       # action: f32[R] targets

The reward composes the three objectives the control plane itself is
judged on: SLO-violation ticks (demand outran capacity), hourly cost
(priced replica-ticks), and reconcile lead time (|target - actual|
backlog, the BLITZSCALE metric) — summed on host in float64 so every
path reduces in one order (the ops/simstep.py parity contract).

Never-block: `step(action)` sanitizes the action (None / wrong shape /
non-finite → the reactive target) and `run(policy)` catches policy
exceptions the same way — a broken policy degrades to reactive ticks,
mirroring the live `simlab` algorithm's contract, and the fallback is
counted in info, never raised.

The port's copy of karpenter_tpu/simlab/env.py, changed only in its
imports: a standalone env's private SolverService runs on the CUDA card
(raising without one); pass `service=SolverService(device="cpu")` to
step on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

DEFAULT_TICKS = 64
DEFAULT_ROWS = 8

_F32 = np.float32


@dataclass(frozen=True)
class SimParams:
    """The simulated control-plane physics + reward weights shared by a
    scenario's clusters (docs/simulator.md)."""

    cap: float = 4.0  # demand served per replica
    hourly: float = 1.0  # on-demand price per replica-tick
    step_limit: float = 2.0  # max replica movement per tick (lead time)
    min_replicas: float = 0.0
    max_replicas: float = 64.0
    w_slo: float = 10.0  # reward weight: SLO-violation ticks
    w_cost: float = 0.05  # reward weight: priced replica-ticks
    w_lead: float = 0.2  # reward weight: reconcile backlog


@dataclass
class SimTrails:
    """One cluster's precomputed seeded episode (module docstring)."""

    demand: np.ndarray  # f32[T, R]
    forecast: np.ndarray  # f32[T, R] preview of the NEXT tick's demand
    price: np.ndarray  # f32[T] price multiplier (spot spike > 1)
    fault: np.ndarray  # f32[T] 1.0 = actuation blocked (chaos registry)
    replicas0: np.ndarray  # f32[R] initial replicas

    @property
    def ticks(self) -> int:
        return int(self.demand.shape[0])

    @property
    def rows(self) -> int:
        return int(self.demand.shape[1])


def composite_reward(params: SimParams, violation, cost, backlog):
    """The composite reward over per-tick per-row components, reduced
    on HOST in float64 (never in-kernel — the parity contract). Arrays
    with a leading cluster axis come back as per-cluster f64 rewards."""
    violation = np.asarray(violation, np.float64)
    cost = np.asarray(cost, np.float64)
    backlog = np.asarray(backlog, np.float64)
    # reduce the trailing [T, R] (or the whole [R] of a single tick);
    # leading cluster axes survive as per-cluster rewards
    axes = tuple(range(max(violation.ndim - 2, 0), violation.ndim))
    total = (
        params.w_slo * violation.sum(axis=axes)
        + params.w_cost * cost.sum(axis=axes)
        + params.w_lead * backlog.sum(axis=axes)
    )
    return -total


def _default_service():
    """A private SolverService for standalone envs (the simulate.py
    replay idiom): own gauge registry so a notebook env never pollutes
    the process /metrics surface."""
    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.solver.service import SolverService

    return SolverService(registry=GaugeRegistry())


class SimEnv:
    """One simulated cluster with the gym contract (module docstring).

    `trails_fn(seed) -> SimTrails` regenerates the episode on every
    reset, so `reset(seed)` replays deterministically and distinct
    seeds draw distinct episodes from the same scenario."""

    def __init__(
        self,
        trails_fn: Callable[[int], SimTrails],
        params: Optional[SimParams] = None,
        seed: int = 0,
        service=None,
        backend: Optional[str] = None,
    ):
        self.params = params if params is not None else SimParams()
        self._trails_fn = trails_fn
        self._seed = int(seed)
        self._service = service if service is not None else _default_service()
        self._backend = backend
        self.trails: Optional[SimTrails] = None
        self.reset()

    # -- gym surface -------------------------------------------------------

    def reset(self, seed: Optional[int] = None) -> dict:
        if seed is not None:
            self._seed = int(seed)
        self.trails = self._trails_fn(self._seed)
        self._t = 0
        self._replicas = np.asarray(
            self.trails.replicas0, _F32
        ).copy()
        self._d_prev = np.zeros(self.trails.rows, _F32)
        self._f_prev = np.zeros(self.trails.rows, _F32)
        self._p_prev = _F32(1.0)
        return self._obs()

    def step(self, action=None):
        """Advance one tick; `action` is f32[R] replica targets (None or
        an unusable action falls back to the reactive target)."""
        from karpenter_tpu_torch.ops import simstep as SK

        if self.done:
            raise RuntimeError("episode is done; call reset()")
        t = self._t
        trails = self.trails
        target, fell_back = self._sanitize(action)
        out = self._service.sim_step(
            SK.SimStepInputs(
                replicas=self._replicas,
                target=target,
                demand=trails.demand[t],
                price=np.asarray(trails.price[t]),
                fault=np.asarray(trails.fault[t]),
                **self._scalars(),
            ),
            backend=self._backend,
        )
        reward = float(
            composite_reward(
                self.params, out.violation, out.cost, out.backlog
            )
        )
        self._replicas = np.asarray(out.replicas, _F32)
        self._d_prev = np.asarray(trails.demand[t], _F32)
        self._f_prev = np.asarray(trails.forecast[t], _F32)
        self._p_prev = _F32(trails.price[t])
        self._t = t + 1
        info = {
            "violation_rows": float(np.asarray(out.violation).sum()),
            "hourly_cost": float(np.asarray(out.cost).sum()),
            "backlog": float(np.asarray(out.backlog).sum()),
            "fault": float(trails.fault[t]),
            "reactive_fallback": fell_back,
        }
        return self._obs(), reward, self.done, info

    @property
    def done(self) -> bool:
        return self._t >= self.trails.ticks

    def _obs(self) -> dict:
        """Columnar fleet state as the policy sees it: the LAST OBSERVED
        demand/forecast/price (zeros / 1.0 before the first tick — the
        same warm-up the in-kernel rollout policy sees)."""
        return {
            "tick": self._t,
            "rows": self.trails.rows,
            "replicas": self._replicas.copy(),
            "demand": self._d_prev.copy(),
            "forecast": self._f_prev.copy(),
            "price": float(self._p_prev),
        }

    # -- never-block helpers ----------------------------------------------

    def reactive_target(self) -> np.ndarray:
        """The reactive fallback action: chase last observed demand —
        the same f32 math as the in-kernel policy at knobs (0,0,0)."""
        raw = np.ceil(self._d_prev / _F32(self.params.cap))
        return np.clip(
            raw, _F32(self.params.min_replicas),
            _F32(self.params.max_replicas),
        ).astype(_F32)

    def _sanitize(self, action):
        if action is None:
            return self.reactive_target(), False
        arr = np.asarray(action, _F32)
        if arr.shape != self._replicas.shape or not np.all(
            np.isfinite(arr)
        ):
            return self.reactive_target(), True
        return arr, False

    def run(self, policy=None, reset: bool = True) -> dict:
        """Roll the episode out under `policy` (None = reactive) with
        the never-block contract: a raising policy degrades THAT TICK
        to the reactive target and the episode keeps stepping."""
        if reset:
            self.reset()
        if policy is not None and hasattr(policy, "reset"):
            policy.reset()
        total = 0.0
        violations = cost = backlog = 0.0
        policy_faults = fallbacks = 0
        obs = self._obs()
        while not self.done:
            action = None
            if policy is not None:
                try:
                    action = policy.act(obs)
                except Exception:  # noqa: BLE001 — never-block contract
                    policy_faults += 1
            obs, reward, _done, info = self.step(action)
            total += reward
            violations += info["violation_rows"]
            cost += info["hourly_cost"]
            backlog += info["backlog"]
            fallbacks += int(info["reactive_fallback"])
        return {
            "reward": total,
            "violation_ticks": violations,
            "hourly_cost": cost,
            "backlog": backlog,
            "policy_faults": policy_faults,
            "reactive_fallbacks": fallbacks,
            "final_replicas": self._replicas.copy(),
        }

    def _scalars(self) -> dict:
        p = self.params
        return {
            "cap": _F32(p.cap),
            "hourly": _F32(p.hourly),
            "step_limit": _F32(p.step_limit),
            "min_replicas": _F32(p.min_replicas),
            "max_replicas": _F32(p.max_replicas),
        }


class BatchedSimEnv:
    """N independently-seeded clusters stepped as ONE device program.

    Cluster i draws its episode from `trails_fn(seed + i)` (pass
    `share_trails=True` to evaluate N policies against ONE shared
    episode — the policy-search configuration). `step` advances all
    clusters per tick through SolverService.sim_step; `rollout(knobs)`
    runs whole episodes under the in-kernel tuned policy as a single
    batched dispatch (ops/simstep.py sim_rollout over [B, T, R])."""

    def __init__(
        self,
        trails_fn: Callable[[int], SimTrails],
        clusters: int,
        params: Optional[SimParams] = None,
        seed: int = 0,
        service=None,
        backend: Optional[str] = None,
        share_trails: bool = False,
    ):
        if clusters < 1:
            raise ValueError(f"clusters must be >= 1, got {clusters}")
        self.params = params if params is not None else SimParams()
        self.clusters = int(clusters)
        self._trails_fn = trails_fn
        self._seed = int(seed)
        self._share = share_trails
        self._service = service if service is not None else _default_service()
        self._backend = backend
        self.reset()

    def reset(self, seed: Optional[int] = None) -> dict:
        if seed is not None:
            self._seed = int(seed)
        if self._share:
            one = self._trails_fn(self._seed)
            per_cluster = [one] * self.clusters
        else:
            per_cluster = [
                self._trails_fn(self._seed + i)
                for i in range(self.clusters)
            ]
        self.trails = SimTrails(
            demand=np.stack([t.demand for t in per_cluster]),
            forecast=np.stack([t.forecast for t in per_cluster]),
            price=np.stack([t.price for t in per_cluster]),
            fault=np.stack([t.fault for t in per_cluster]),
            replicas0=np.stack([t.replicas0 for t in per_cluster]),
        )
        self._t = 0
        self._replicas = np.asarray(self.trails.replicas0, _F32).copy()
        self._d_prev = np.zeros_like(self._replicas)
        return self._obs()

    @property
    def ticks(self) -> int:
        return int(self.trails.demand.shape[1])

    @property
    def done(self) -> bool:
        return self._t >= self.ticks

    def _obs(self) -> dict:
        return {
            "tick": self._t,
            "replicas": self._replicas.copy(),
            "demand": self._d_prev.copy(),
        }

    def step(self, action=None):
        """One tick for ALL clusters: action f32[B, R] targets (None =
        reactive per cluster), one sim_step dispatch."""
        from karpenter_tpu_torch.ops import simstep as SK

        if self.done:
            raise RuntimeError("episode is done; call reset()")
        t = self._t
        if action is None:
            raw = np.ceil(self._d_prev / _F32(self.params.cap))
            action = np.clip(
                raw, _F32(self.params.min_replicas),
                _F32(self.params.max_replicas),
            ).astype(_F32)
        out = self._service.sim_step(
            SK.SimStepInputs(
                replicas=self._replicas,
                target=np.asarray(action, _F32),
                demand=self.trails.demand[:, t],
                price=self.trails.price[:, t],
                fault=self.trails.fault[:, t],
                **_scalars(self.params),
            ),
            backend=self._backend,
        )
        rewards = composite_reward(
            self.params,
            np.asarray(out.violation)[:, None, :],
            np.asarray(out.cost)[:, None, :],
            np.asarray(out.backlog)[:, None, :],
        )
        self._replicas = np.asarray(out.replicas, _F32)
        self._d_prev = np.asarray(self.trails.demand[:, t], _F32)
        self._t = t + 1
        info = {
            "violation_rows": np.asarray(out.violation).sum(axis=-1),
            "hourly_cost": np.asarray(out.cost).sum(axis=-1),
            "backlog": np.asarray(out.backlog).sum(axis=-1),
        }
        return self._obs(), rewards, self.done, info

    def rollout(self, knobs) -> dict:
        """Whole episodes for all clusters under the in-kernel tuned
        policy, ONE batched dispatch. `knobs` is f32[3] (broadcast) or
        f32[B, 3] (per-cluster candidates — the search plane). Returns
        per-cluster composite rewards + component totals."""
        from karpenter_tpu_torch.ops import simstep as SK

        knobs = np.asarray(knobs, _F32)
        if knobs.ndim == 1:
            knobs = np.broadcast_to(
                knobs, (self.clusters, knobs.shape[0])
            ).copy()
        out = self._service.sim_rollout(
            SK.SimRolloutInputs(
                replicas0=np.asarray(self.trails.replicas0, _F32),
                streak0=np.zeros_like(
                    np.asarray(self.trails.replicas0, _F32)
                ),
                demand=self.trails.demand,
                forecast=self.trails.forecast,
                price=self.trails.price,
                fault=self.trails.fault,
                knobs=knobs,
                **_scalars(self.params),
            ),
            backend=self._backend,
        )
        rewards = composite_reward(
            self.params, out.violation, out.cost, out.backlog
        )
        return {
            "rewards": rewards,
            "violation_ticks": np.asarray(
                out.violation, np.float64
            ).sum(axis=(1, 2)),
            "hourly_cost": np.asarray(out.cost, np.float64).sum(
                axis=(1, 2)
            ),
            "backlog": np.asarray(out.backlog, np.float64).sum(
                axis=(1, 2)
            ),
            "final_replicas": np.asarray(out.replicas, _F32),
            "outputs": out,
        }


def _scalars(p: SimParams) -> dict:
    return {
        "cap": _F32(p.cap),
        "hourly": _F32(p.hourly),
        "step_limit": _F32(p.step_limit),
        "min_replicas": _F32(p.min_replicas),
        "max_replicas": _F32(p.max_replicas),
    }
