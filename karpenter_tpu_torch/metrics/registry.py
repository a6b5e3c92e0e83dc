"""Metric registry with Prometheus naming and text exposition.

reference: pkg/metrics/gauge.go:22-50 — gauges named
karpenter_<subsystem>_<name>, labeled {name, namespace}, registered into the
controller-runtime /metrics endpoint and scraped by Prometheus. Here the
registry doubles as the metrics STORE: the in-process metrics client reads
gauge values directly (no scrape hop), while the /metrics text exposition
keeps drop-in Prometheus compatibility for external scrapers. (The port's
copy of karpenter_tpu/metrics/registry.py.)

Beyond the reference's gauges the registry carries counters and NATIVE
HISTOGRAMS (`kind="histogram"`, per-vec bucket ladders): cumulative
`_bucket{le=...}` series, `_sum`/`_count`, and `+Inf` always present —
the shape promtool expects, pinned by the exposition-conformance tests.
The solver stage latencies, coalesce batch sizes, and the end-to-end
`karpenter_reconcile_e2e_seconds` lead time (docs/observability.md)
export through it as real histograms, so Prometheus
`histogram_quantile()` works instead of the pre-histogram p50/p99 gauge
snapshots.
"""

from __future__ import annotations

import bisect
import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

METRIC_NAMESPACE = "karpenter"
LABEL_NAME = "name"
LABEL_NAMESPACE = "namespace"

# default histogram ladder (seconds): sub-ms device dispatches through
# multi-second cloud actuations
DEFAULT_HISTOGRAM_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


def escape_label_value(value: str) -> str:
    """Prometheus text-format label escaping: backslash, double quote,
    and newline must be escaped inside label values — an unescaped
    quote in an object name would corrupt every series after it."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _format_value(value: float) -> str:
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    return repr(value)


def _format_le(bound: float) -> str:
    """Bucket bounds render promtool-style: '+Inf', integers bare,
    floats shortest ('0.005', not '0.005000000000000001')."""
    if math.isinf(bound):
        return "+Inf"
    return f"{bound:g}"


def _render_labels(labels: Dict[str, str]) -> str:
    return ",".join(
        f'{k}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items())
    )


@dataclass
class GaugeSample:
    labels: Dict[str, str]
    value: float


class GaugeVec:
    """A named gauge (or counter: kind="counter") parameterized by
    {name, namespace} labels."""

    def __init__(self, full_name: str, help_text: str, kind: str = "gauge"):
        self.full_name = full_name
        self.help = help_text
        self.kind = kind  # Prometheus TYPE line: "gauge" or "counter"
        self._samples: Dict[Tuple[str, str], float] = {}
        self._lock = threading.Lock()

    def set(self, name: str, namespace: str, value: float) -> None:
        with self._lock:
            self._samples[(name, namespace)] = float(value)

    def inc(self, name: str, namespace: str, delta: float = 1.0) -> None:
        """Atomic increment under the vec lock (counters must never lose
        increments to concurrent read-modify-write)."""
        with self._lock:
            key = (name, namespace)
            self._samples[key] = self._samples.get(key, 0.0) + delta

    def get(self, name: str, namespace: str) -> Optional[float]:
        with self._lock:
            return self._samples.get((name, namespace))

    def remove(self, name: str, namespace: str) -> None:
        with self._lock:
            self._samples.pop((name, namespace), None)

    def samples(self):
        with self._lock:
            return [
                GaugeSample({LABEL_NAME: n, LABEL_NAMESPACE: ns}, v)
                for (n, ns), v in sorted(self._samples.items())
            ]

    def expose_lines(self) -> List[str]:
        lines = [
            f"# HELP {self.full_name} {self.help}",
            f"# TYPE {self.full_name} {self.kind}",
        ]
        for sample in self.samples():
            lines.append(
                f"{self.full_name}{{{_render_labels(sample.labels)}}} "
                f"{_format_value(sample.value)}"
            )
        return lines


class HistogramVec:
    """A native Prometheus histogram parameterized by {name, namespace}
    labels: per-series bucket counts + sum, exposed as cumulative
    `_bucket{le=...}` / `_sum` / `_count` with `+Inf` always present.

    Buckets are upper bounds, strictly increasing; `+Inf` is implicit
    (and stripped if passed). observe() is O(log buckets) under the vec
    lock — cumulation happens at exposition, not on the hot path."""

    def __init__(self, full_name: str, help_text: str, buckets=None):
        self.full_name = full_name
        self.help = help_text
        self.kind = "histogram"
        bounds = sorted(
            float(b) for b in (buckets or DEFAULT_HISTOGRAM_BUCKETS)
            if not math.isinf(float(b))
        )
        if not bounds:
            raise ValueError(f"{full_name}: histogram needs finite buckets")
        if len(set(bounds)) != len(bounds):
            raise ValueError(f"{full_name}: duplicate histogram buckets")
        self.buckets: Tuple[float, ...] = tuple(bounds)
        # per series: [per-bucket counts..., +Inf overflow count], sum
        self._counts: Dict[Tuple[str, str], List[int]] = {}
        self._sums: Dict[Tuple[str, str], float] = {}
        self._lock = threading.Lock()

    def observe(self, name: str, namespace: str, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            key = (name, namespace)
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
            counts[idx] += 1
            self._sums[key] += value

    def get(self, name: str, namespace: str) -> Optional[float]:
        """Vec-protocol read (the in-process metrics client resolves
        metric names through the registry): a histogram reads as its
        observation COUNT — the only scalar that is well-defined."""
        with self._lock:
            counts = self._counts.get((name, namespace))
            return None if counts is None else float(sum(counts))

    def count(self, name: str, namespace: str) -> int:
        with self._lock:
            counts = self._counts.get((name, namespace))
            return 0 if counts is None else sum(counts)

    def sum(self, name: str, namespace: str) -> float:
        with self._lock:
            return self._sums.get((name, namespace), 0.0)

    def percentile(self, name: str, namespace: str, q: float):
        """Estimate the q-th percentile (q in [0, 100]) for one series
        from the bucket counts — the same linear-within-bucket
        interpolation Prometheus's histogram_quantile() applies, so the
        simulator reports and bench output quote the number an operator
        would read off a dashboard. None for an empty series; samples
        beyond the last finite bucket clamp to that bound (+Inf has no
        upper edge to interpolate toward)."""
        with self._lock:
            counts = self._counts.get((name, namespace))
            if counts is None:
                return None
            counts = list(counts)
        total = sum(counts)
        if total == 0:
            return None
        rank = (q / 100.0) * total
        cumulative = 0.0
        lower = 0.0
        for idx, count in enumerate(counts):
            upper = (
                self.buckets[idx]
                if idx < len(self.buckets)
                else self.buckets[-1]  # +Inf bucket clamps to last bound
            )
            if cumulative + count >= rank:
                if idx >= len(self.buckets) or count == 0:
                    return float(upper)
                fraction = (rank - cumulative) / count
                return float(lower + (upper - lower) * fraction)
            cumulative += count
            lower = upper
        return float(self.buckets[-1])

    def le_totals(self, bound: float) -> Tuple[int, int]:
        """(samples <= bound, total samples) summed across ALL series —
        the self-SLO monitor's good/total pair (observability/selfslo).
        `bound` should sit on a bucket boundary for exactness; an
        off-ladder bound conservatively counts only the buckets wholly
        at or below it (samples between the ladder rung and the bound
        count as BAD, never silently as good)."""
        idx = bisect.bisect_right(self.buckets, float(bound))
        good = total = 0
        with self._lock:
            for counts in self._counts.values():
                good += sum(counts[:idx])
                total += sum(counts)
        return good, total

    def remove(self, name: str, namespace: str) -> None:
        with self._lock:
            self._counts.pop((name, namespace), None)
            self._sums.pop((name, namespace), None)

    def series(self) -> List[Tuple[str, str]]:
        with self._lock:
            return sorted(self._counts)

    def samples(self):
        """Vec-protocol view (the in-process metrics client iterates
        samples()): one sample per series, valued at its observation
        count — same scalar get() reports."""
        with self._lock:
            return [
                GaugeSample(
                    {LABEL_NAME: n, LABEL_NAMESPACE: ns},
                    float(sum(counts)),
                )
                for (n, ns), counts in sorted(self._counts.items())
            ]

    def expose_lines(self) -> List[str]:
        lines = [
            f"# HELP {self.full_name} {self.help}",
            f"# TYPE {self.full_name} histogram",
        ]
        with self._lock:
            snapshot = [
                (key, list(counts), self._sums[key])
                for key, counts in sorted(self._counts.items())
            ]
        bounds = [*self.buckets, math.inf]
        for (name, namespace), counts, total in snapshot:
            base = {LABEL_NAME: name, LABEL_NAMESPACE: namespace}
            cumulative = 0
            for bound, count in zip(bounds, counts):
                cumulative += count
                labels = _render_labels({**base, "le": _format_le(bound)})
                lines.append(
                    f"{self.full_name}_bucket{{{labels}}} {cumulative}"
                )
            labels = _render_labels(base)
            lines.append(
                f"{self.full_name}_sum{{{labels}}} "
                f"{_format_value(total)}"
            )
            lines.append(f"{self.full_name}_count{{{labels}}} {cumulative}")
        return lines


class GaugeRegistry:
    def __init__(self):
        self._gauges: Dict[str, Dict[str, object]] = {}
        self._lock = threading.Lock()

    def register(
        self, subsystem: str, name: str, kind: str = "gauge", buckets=None
    ):
        """reference: gauge.go:35-50 (RegisterNewGauge); kind="histogram"
        (optionally with a `buckets` ladder) registers a HistogramVec."""
        full = f"{METRIC_NAMESPACE}_{subsystem}_{name}"
        with self._lock:
            sub = self._gauges.setdefault(subsystem, {})
            vec = sub.get(name)
            if vec is None:
                if kind == "histogram":
                    vec = sub[name] = HistogramVec(
                        full,
                        "Metric computed by a karpenter metrics producer "
                        "corresponding to name and namespace labels",
                        buckets=buckets,
                    )
                else:
                    vec = sub[name] = GaugeVec(
                        full,
                        "Metric computed by a karpenter metrics producer "
                        "corresponding to name and namespace labels",
                        kind=kind,
                    )
            elif kind == "histogram" and vec.kind == "histogram":
                # the bucket ladder is decided at first registration
                # like the TYPE line: a second caller silently landing
                # observations in a ladder it never chose would skew
                # histogram_quantile() with no error anywhere
                if buckets is not None and tuple(
                    sorted(float(b) for b in buckets
                           if not math.isinf(float(b)))
                ) != vec.buckets:
                    raise ValueError(
                        f"{full} already registered with buckets "
                        f"{vec.buckets}; conflicting ladder "
                        f"{tuple(buckets)}"
                    )
            elif vec.kind != kind:
                # the TYPE line is decided at first registration; a silent
                # mismatch would expose a counter as a gauge (or vice
                # versa) and corrupt rate()/increase() semantics
                raise ValueError(
                    f"{full} already registered as {vec.kind}, not {kind}"
                )
            return vec

    def gauge(self, subsystem: str, name: str):
        with self._lock:
            return self._gauges[subsystem][name]

    def remove_series(self, subsystem: str, name: str, namespace: str) -> None:
        """Drop one {name, namespace} series from EVERY vec registered
        under `subsystem` — the per-object retirement hook deletion
        paths call so a deleted object's series cannot freeze on
        /metrics. Covers vecs added to the subsystem later without the
        caller having to enumerate metric names (the reserved_capacity
        family alone is resources x metric-types wide)."""
        with self._lock:
            vecs = list(self._gauges.get(subsystem, {}).values())
        for vec in vecs:
            vec.remove(name, namespace)

    def lookup_by_full_name(self, full_name: str):
        with self._lock:
            for sub in self._gauges.values():
                for vec in sub.values():
                    if vec.full_name == full_name:
                        return vec
        return None

    def expose_text(self) -> str:
        """Prometheus text exposition format of all samples."""
        with self._lock:
            vecs = [v for sub in self._gauges.values() for v in sub.values()]
        lines: List[str] = []
        for vec in sorted(vecs, key=lambda v: v.full_name):
            lines.extend(vec.expose_lines())
        return "\n".join(lines) + "\n"


_default = GaugeRegistry()


def default_registry() -> GaugeRegistry:
    return _default


def reset_default_registry() -> GaugeRegistry:
    """Swap in a fresh default registry (test isolation)."""
    global _default
    _default = GaugeRegistry()
    return _default
