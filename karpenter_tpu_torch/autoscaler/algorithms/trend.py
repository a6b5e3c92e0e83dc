"""Trend algorithm: scale ahead of ramping load.

reference anchor: pkg/autoscaler/algorithms/algorithm.go:37-39 leaves
algorithm selection as a TODO with Proportional hardcoded; this is the
second registered algorithm that seam exists for (select with the
`autoscaling.karpenter.sh/algorithm: trend` annotation). The reference
has no predictive capability at all — its loop reacts to the current
instant vector only, so a steadily ramping queue is always chased from
behind by (poll interval + stabilization) of lag.

Method: keep a per-(autoscaler, metric) sliding window of observed
values, fit a least-squares line, and run Proportional's HPA math on
the value PROJECTED `horizon` seconds ahead. Two safety properties:

- never scales down ahead of the data: the projected value is
  max(current, projection), so a falling trend behaves exactly like
  plain Proportional (down-scaling stays governed by the stabilization
  window and rate policies, which apply on device after this
  recommendation like every custom algorithm's);
- degrades to plain Proportional whenever the window holds fewer than
  two samples or spans less than a second (a fresh autoscaler, a
  paused metric, clock skew) — never extrapolates from noise.

State: one shared instance holds every window (keyed by the OWNING
autoscaler + metric identity, so two autoscalers watching the same
query never share a trend); windows prune by age on every observation
and the key set prunes lazily, so a deleted autoscaler's history ages
out instead of leaking.

The port's copy of karpenter_tpu/autoscaler/algorithms/trend.py, changed
only in its imports.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Tuple

from karpenter_tpu_torch.autoscaler.algorithms.proportional import Proportional

# class-level defaults; register_algorithm("my-trend", lambda:
# Trend(window=..., horizon=...)) for other operating points
DEFAULT_WINDOW_SECONDS = 300.0
DEFAULT_HORIZON_SECONDS = 60.0
# lazy key pruning: when the key census exceeds this, drop windows whose
# newest sample is older than a window (deleted/renamed autoscalers)
_PRUNE_THRESHOLD = 1024


class Trend:
    def __init__(
        self,
        window: float = DEFAULT_WINDOW_SECONDS,
        horizon: float = DEFAULT_HORIZON_SECONDS,
    ):
        self.window = float(window)
        self.horizon = float(horizon)
        self._proportional = Proportional()
        self._series: Dict[tuple, Deque[Tuple[float, float]]] = {}

    def _key(self, metric) -> tuple:
        return (
            getattr(metric, "owner", ()),
            metric.name,
            tuple(sorted(metric.labels.items())),
        )

    def _observe(self, metric) -> Deque[Tuple[float, float]]:
        at = float(getattr(metric, "at", 0.0))
        series = self._series.setdefault(self._key(metric), deque())
        if series and at < series[-1][0]:
            # clock went backwards (restart with an older fake clock,
            # NTP step): a poisoned window must not extrapolate
            series.clear()
        series.append((at, float(metric.value)))
        while series and series[0][0] < at - self.window:
            series.popleft()
        if len(self._series) > _PRUNE_THRESHOLD:
            stale = [
                key
                for key, s in self._series.items()
                if not s or s[-1][0] < at - self.window
            ]
            for key in stale:
                del self._series[key]
        return series

    def _projected(self, series) -> float:
        """Least-squares slope over the window, projected `horizon`
        ahead of the NEWEST sample; the caller floors the result at the
        current value."""
        n = len(series)
        t0 = series[0][0]
        ts = [t - t0 for t, _ in series]
        vs = [v for _, v in series]
        mean_t = sum(ts) / n
        mean_v = sum(vs) / n
        var_t = sum((t - mean_t) ** 2 for t in ts)
        if var_t < 1.0:  # window too narrow to carry a slope
            return vs[-1]
        slope = (
            sum((t - mean_t) * (v - mean_v) for t, v in zip(ts, vs))
            / var_t
        )
        return vs[-1] + slope * self.horizon

    def get_desired_replicas(self, metric, replicas: int) -> int:
        series = self._observe(metric)
        value = float(metric.value)
        if len(series) >= 2:
            # never project BELOW the data: a falling trend scales like
            # plain Proportional; only a rising one scales ahead
            value = max(value, self._projected(series))
        if value == metric.value:
            return self._proportional.get_desired_replicas(
                metric, replicas
            )
        projected = dataclasses.replace(metric, value=value)
        return self._proportional.get_desired_replicas(
            projected, replicas
        )
