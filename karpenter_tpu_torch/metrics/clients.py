"""Metrics clients: how the autoscaler reads metric values.

reference: pkg/metrics/clients/client.go:26-53 and prometheus.go:35-55 — a
factory dispatching on the metric's source type, and a Prometheus client that
issues an instant query and requires an instant vector of length 1.

The TPU build ships two client backends:
- RegistryMetricsClient: reads the in-process gauge registry directly,
  evaluating the same `metric_name{label="value",...}` instant-selector
  queries the reference writes against Prometheus (docs/examples/*.yaml).
  This removes the produce→scrape→query latency hops (≈10s) for in-cluster
  signals while keeping query strings source-compatible.
- PrometheusMetricsClient: a real HTTP instant query against a Prometheus
  server for drop-in parity when signals live outside the process.

The port's copy of karpenter_tpu/metrics/clients.py, changed in its
imports and in one lookup: a selector naming exactly a series' `name` and
`namespace` reads that series by its key instead of scanning the vec (the
same answer, in constant time per query).
"""

from __future__ import annotations

import json
import re
import urllib.parse
import urllib.request
from typing import Dict, Optional, Tuple

from karpenter_tpu_torch.controllers.errors import RetryableError
from karpenter_tpu_torch.faults import inject
from karpenter_tpu_torch.metrics.registry import (
    LABEL_NAME,
    LABEL_NAMESPACE,
    GaugeRegistry,
    GaugeSample,
    default_registry,
)
from karpenter_tpu_torch.metrics.types import Metric
from karpenter_tpu_torch.observability import default_tracer
from karpenter_tpu_torch.utils.log import invariant_violated

_SELECTOR_RE = re.compile(
    r"^\s*(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)\s*"
    r"(?:\{(?P<labels>[^}]*)\})?\s*$"
)
_LABEL_RE = re.compile(
    r'\s*(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"(?P<value>[^"]*)"\s*'
)


class MetricQueryError(RetryableError):
    """A metric read that failed NOW but may succeed later: network
    blips against Prometheus, and metrics that simply don't exist YET
    (a producer that hasn't ticked, an HA created before its signal).
    RETRYABLE in the controller taxonomy — the engine must keep
    requeueing (with backoff) rather than deactivate the autoscaler,
    because the metric can appear without any watch event on the HA
    object to revive it."""

    def __init__(self, message: str):
        super().__init__(message, code="MetricQuery", retryable=True)


def parse_instant_selector(query: str) -> Tuple[str, Dict[str, str]]:
    """Parse `metric_name{k="v",...}` into (name, labels)."""
    m = _SELECTOR_RE.match(query)
    if m is None:
        raise MetricQueryError(f"unsupported query syntax: {query!r}")
    labels: Dict[str, str] = {}
    raw = m.group("labels")
    if raw and raw.strip():
        # consume `k="v"` segments sequentially; anything unconsumed (gaps,
        # bad separators) is a syntax error, never silently dropped
        pos = 0
        while True:
            lm = _LABEL_RE.match(raw, pos)
            if lm is None or lm.start() != pos:
                raise MetricQueryError(
                    f"unsupported label syntax in query: {query!r}"
                )
            labels[lm.group("key")] = lm.group("value")
            pos = lm.end()
            if pos >= len(raw):
                break
            if raw[pos] != ",":
                raise MetricQueryError(
                    f"unsupported label syntax in query: {query!r}"
                )
            pos += 1
    return m.group("name"), labels


class RegistryMetricsClient:
    """Instant-selector evaluation against the in-process gauge registry.

    `observer` (any (Metric) -> None callable) sees every successful
    read — the forecast subsystem's metric-history hook
    (forecast/history.py): client-path observations feed the query-keyed
    warm pool that seeds a fresh HorizontalAutoscaler's history."""

    def __init__(
        self,
        registry: Optional[GaugeRegistry] = None,
        observer=None,
    ):
        self.registry = registry if registry is not None else default_registry()
        self.observer = observer

    def get_current_value(self, metric_spec) -> Metric:
        query = metric_spec.prometheus.query
        # inject sits INSIDE the span so a latency/hang chaos plan at
        # metrics.query shows up as metrics.query time in the trace,
        # not as an unexplained gap in the parent reconcile span
        with default_tracer().span("metrics.query", query=query):
            inject("metrics.query")
            return self._evaluate(query)

    def _evaluate(self, query: str) -> Metric:
        name, labels = parse_instant_selector(query)
        vec = self.registry.lookup_by_full_name(name)
        if vec is None:
            raise MetricQueryError(f"no metric named {name!r} for query {query!r}")
        if labels.keys() == {LABEL_NAME, LABEL_NAMESPACE}:
            # every series of a vec is keyed by exactly these two labels:
            # read the one series by its key instead of scanning the vec
            # (thousands of HAs' series in one vec make the scan the
            # tick's cost); the same match as the scan below
            value = vec.get(labels[LABEL_NAME], labels[LABEL_NAMESPACE])
            matches = [] if value is None else [GaugeSample(
                {LABEL_NAME: labels[LABEL_NAME],
                 LABEL_NAMESPACE: labels[LABEL_NAMESPACE]}, value,
            )]
        else:
            matches = [
                s
                for s in vec.samples()
                if all(s.labels.get(k) == v for k, v in labels.items())
            ]
        # instant vector of exactly 1, matching the reference's response
        # validation (prometheus.go:46-55)
        if len(matches) != 1:
            raise MetricQueryError(
                f"expected instant vector of length 1 for query {query!r}, "
                f"got {len(matches)} series"
            )
        metric = Metric(
            name=name, labels=matches[0].labels, value=matches[0].value
        )
        if self.observer is not None:
            self.observer(metric)
        return metric


class PrometheusMetricsClient:
    """HTTP instant query (reference: prometheus.go:35-55). `observer`
    as on RegistryMetricsClient."""

    def __init__(
        self, uri: str, timeout_seconds: float = 5.0, observer=None
    ):
        self.uri = uri.rstrip("/")
        self.timeout = timeout_seconds
        self.observer = observer

    def get_current_value(self, metric_spec) -> Metric:
        query = metric_spec.prometheus.query
        # the HTTP query is the metrics path with REAL network latency —
        # exactly what the trace must attribute
        with default_tracer().span(
            "metrics.query", query=query, backend="prometheus"
        ):
            inject("metrics.query")
            return self._query(query)

    def _query(self, query: str) -> Metric:
        data = urllib.parse.urlencode({"query": query}).encode()
        request = urllib.request.Request(
            f"{self.uri}/api/v1/query",
            data=data,
            headers={"Content-Type": "application/x-www-form-urlencoded"},
        )
        try:
            with urllib.request.urlopen(request, timeout=self.timeout) as resp:
                payload = json.loads(resp.read())
        except OSError as e:
            raise MetricQueryError(f"request failed for query {query!r}, {e}")
        if payload.get("status") != "success":
            raise MetricQueryError(f"query {query!r} failed: {payload}")
        result = payload.get("data", {})
        if result.get("resultType") != "vector":
            raise MetricQueryError(
                f"expected vector and got {result.get('resultType')!r}"
            )
        vector = result.get("result", [])
        if len(vector) != 1:
            raise MetricQueryError(
                f"expected instant vector of length 1 for {query!r}, "
                f"got {len(vector)}"
            )
        metric = Metric(
            name=query, labels=vector[0].get("metric", {}),
            value=float(vector[0]["value"][1]),
        )
        if self.observer is not None:
            self.observer(metric)
        return metric


class MetricsClientFactory:
    """Dispatch on the metric's one-of source type (reference: client.go:40-53)."""

    def __init__(
        self,
        registry: Optional[GaugeRegistry] = None,
        prometheus_uri: Optional[str] = None,
        observer=None,
    ):
        self._registry_client = RegistryMetricsClient(
            registry, observer=observer
        )
        self._prometheus_client = (
            PrometheusMetricsClient(prometheus_uri, observer=observer)
            if prometheus_uri
            else None
        )

    def for_metric(self, metric_spec):
        if metric_spec.prometheus is not None:
            # external Prometheus takes precedence when configured; default
            # is the in-process registry (same query strings)
            if self._prometheus_client is not None:
                return self._prometheus_client
            return self._registry_client
        invariant_violated(
            "Failed to instantiate metrics client, no metric type specified"
        )
