"""`simlab` algorithm: a frozen search-tuned SimLab policy, live.

The third registered algorithm the algorithm.go:37-39 seam exists for
(select with `autoscaling.karpenter.sh/algorithm: simlab`). The SimLab
policy plane (karpenter_tpu/simlab/policy.py, docs/simulator.md)
grid-searches a 3-knob decision surface — forecast blend floor, cost
shed weight, scale-down stabilization window — against batched
simulated rollouts; the winning vector freezes into this algorithm, so
what search scored is what the fleet runs.

Live translation of the knobs (the kernel's price/fault trails don't
exist on the metric path):

  blend floor   the observed value blends with a one-step linear
                projection (value + the last observed delta), floored
                by the knob: blend = max(value, floor * projection) —
                never BELOW the data, exactly the Trend discipline;
  stab window   a per-(autoscaler, metric) scale-down streak must age
                past the window before a smaller desired count is
                released (holds return the current replicas);
  cost weight   carried on the instance for introspection — live cost
                shedding already belongs to the cost ladder
                (docs/cost.md), which applies AFTER every algorithm's
                recommendation, so applying it here would double-shed.

NEVER-BLOCK (the acceptance contract): any failure inside the tuned
path — bad history, arithmetic on poisoned values, anything — degrades
THAT decision to the plain reactive tick (Proportional on the raw
metric). The tuned path is advisory; the reactive baseline is the
floor.

State: per-(autoscaler, metric) (last value, last at, streak), pruned
lazily past a census threshold like Trend's windows, so deleted
autoscalers age out instead of leaking.

The port's copy of karpenter_tpu/autoscaler/algorithms/simlab_policy.py,
changed only in its imports.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from karpenter_tpu_torch.autoscaler.algorithms.proportional import Proportional

# lazy key pruning, the Trend discipline: when the census exceeds this,
# drop keys whose newest sample is older than the staleness horizon
_PRUNE_THRESHOLD = 1024
_STALE_SECONDS = 300.0


class SimlabPolicy:
    def __init__(self, knobs=None):
        if knobs is None:
            # the shipped frozen winner (simlab/policy.py FROZEN_KNOBS);
            # register_algorithm("my-simlab", lambda:
            # SimlabPolicy(knobs=...)) pins a re-searched vector
            from karpenter_tpu_torch.simlab.policy import FROZEN_KNOBS

            knobs = FROZEN_KNOBS
        self.blend_floor = float(knobs[0])
        self.cost_weight = float(knobs[1])  # introspection only (docstring)
        self.stab_window = float(knobs[2])
        self._proportional = Proportional()
        # key -> (last value, last at, scale-down streak)
        self._state: Dict[tuple, Tuple[float, float, float]] = {}

    def _key(self, metric) -> tuple:
        return (
            getattr(metric, "owner", ()),
            metric.name,
            tuple(sorted(metric.labels.items())),
        )

    def _blend(self, metric, prev: Optional[Tuple]) -> float:
        """max(value, floor * one-step projection): scale-ups see the
        projected ramp, scale-downs never drop below the data."""
        value = float(metric.value)
        if prev is None or self.blend_floor <= 0.0:
            return value
        projection = value + (value - prev[0])
        return max(value, self.blend_floor * projection)

    def _tuned(self, metric, replicas: int) -> int:
        key = self._key(metric)
        prev = self._state.get(key)
        at = float(getattr(metric, "at", 0.0))
        if prev is not None and at < prev[1]:
            prev = None  # clock went backwards: don't project from it
        blended = self._blend(metric, prev)
        if blended == metric.value:
            desired = self._proportional.get_desired_replicas(
                metric, replicas
            )
        else:
            desired = self._proportional.get_desired_replicas(
                dataclasses.replace(metric, value=blended), replicas
            )
        streak = (prev[2] + 1.0) if prev is not None else 1.0
        if desired >= replicas:
            streak = 0.0
        self._state[key] = (float(metric.value), at, streak)
        self._prune(at)
        if desired < replicas and streak <= self.stab_window:
            return replicas  # held: the streak is younger than the window
        return desired

    def _prune(self, at: float) -> None:
        if len(self._state) <= _PRUNE_THRESHOLD:
            return
        stale = [
            key
            for key, (_v, last_at, _s) in self._state.items()
            if last_at < at - _STALE_SECONDS
        ]
        for key in stale:
            del self._state[key]

    def get_desired_replicas(self, metric, replicas: int) -> int:
        try:
            return self._tuned(metric, replicas)
        except Exception:  # noqa: BLE001 — never-block: reactive floor
            try:
                return self._proportional.get_desired_replicas(
                    metric, replicas
                )
            except Exception:  # noqa: BLE001 — poisoned metric (NaN):
                return int(replicas)  # hold the fleet, never block
