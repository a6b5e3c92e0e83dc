"""WarmPoolEngine: forecast-risk-sized pre-provisioned headroom.

The BLITZSCALE observation (PAPERS.md) is that end-to-end provisioning
lead time — not solve latency — dominates how fast capacity actually
arrives, and the way to attack it is capacity that already exists when
demand lands. A ScalableNodeGroup opting in via spec.warmPool keeps

    warm = clip(risk_headroom, minWarm, maxWarm)

spare nodes on top of its desired replicas, where risk_headroom is the
cost subsystem's one-sigma demand surplus for the HAs targeting the
group (CostEngine.headroom — the forecast distribution expressed in
replicas; 0 with no signal, so minWarm is the standalone floor).

The warm target rides the ScalableNodeGroup controller's ORDINARY
actuation door: the controller asks `warm_for(resource)` during its
reconcile and actuates spec.replicas + warm through the same fenced,
journaled, breaker-guarded provider write everything else uses — warm
capacity is never a side-channel resize. Sizing failures degrade to
minWarm (never-block: a broken risk signal must not stall actuation).

Metrics: karpenter_warmpool_{replicas,risk_replicas} gauges per group.

The port's copy of karpenter_tpu/cost/warmpool.py, changed only in its
imports.
"""

from __future__ import annotations

from typing import Callable, Optional

from karpenter_tpu_torch.utils.log import logger

SUBSYSTEM = "warmpool"


class WarmPoolEngine:
    """`headroom_source` is (namespace, group_name) -> int replicas of
    forecast-risk headroom (CostEngine.headroom in production)."""

    def __init__(
        self,
        headroom_source: Optional[Callable[[str, str], int]] = None,
        registry=None,
    ):
        self.headroom_source = headroom_source
        self._g_warm = self._g_risk = None
        if registry is not None:
            self._g_warm = registry.register(SUBSYSTEM, "replicas")
            self._g_risk = registry.register(SUBSYSTEM, "risk_replicas")

    def warm_for(self, resource) -> int:
        """Warm replicas to hold for this group right now: 0 without
        spec.warmPool (byte-identical controller behavior), else the
        risk-sized clip. Never raises."""
        spec = getattr(resource.spec, "warm_pool", None)
        if spec is None or spec.max_warm <= 0:
            return 0
        ns = resource.metadata.namespace
        name = resource.metadata.name
        risk = 0
        if self.headroom_source is not None:
            try:
                risk = max(0, int(self.headroom_source(ns, name)))
            except Exception as error:  # noqa: BLE001 — never-block sizing
                logger().warning(
                    "warm-pool risk signal failed for %s/%s (%s: %s); "
                    "holding minWarm", ns, name,
                    type(error).__name__, error,
                )
                risk = 0
        warm = min(max(risk, spec.min_warm), spec.max_warm)
        if self._g_warm is not None:
            self._g_warm.set(name, ns, float(warm))
            self._g_risk.set(name, ns, float(risk))
        return warm

    def on_deleted(self, resource) -> None:
        """Drop a deleted group's gauge series."""
        if self._g_warm is not None:
            self._g_warm.remove(
                resource.metadata.name, resource.metadata.namespace
            )
            self._g_risk.remove(
                resource.metadata.name, resource.metadata.namespace
            )
