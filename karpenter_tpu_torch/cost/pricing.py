"""Pluggable pricing feeds for the cost model.

The cost subsystem ships an ILLUSTRATIVE built-in catalog
(cost/model.py DEFAULT_CATALOG) and named "real pricing feeds" as the
follow-up. This module is that seam: a `PricingSource` answers
"on-demand $/hour for this instance type" (and optionally overrides the
spot multiplier), and the CostModel consults its source before falling
back to the built-in catalog and the default price.

Two sources ship:

  * StaticPricingSource — a plain dict (the built-in catalog wrapped;
    also the test seam).
  * FilePricingSource — a JSON/YAML file, RELOADED ON MTIME CHANGE:
    operators point --pricing-file at a file a cron/sidecar refreshes
    from their billing export, and price changes land on the next tick
    with no restart. A broken or vanished file NEVER takes pricing
    down: the last good catalog keeps serving (never-block, the same
    posture every cost-path failure takes — docs/cost.md).

File format — either a bare {instance-type: $/hour} mapping or:

    {
      "catalog": {"m5.large": 0.096, "ct5lp-hightpu-4t": 4.8},
      "spotMultiplier": 0.31          # optional tier override
    }

Per-tenant feeds come through the tenant registry
(tenancy/registry.py): each TenantSpec.pricing_file builds its own
FilePricingSource, so a thousand tenants can price against a thousand
different negotiated rate cards while sharing one process.

The port's copy of karpenter_tpu/cost/pricing.py, changed only in its
imports.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from karpenter_tpu_torch.utils.log import logger


class PricingSource:
    """The feed interface: price() returns on-demand $/hour for an
    instance type, or None when this source doesn't know it (the model
    then falls back to its built-in catalog and default price);
    spot_multiplier() returns the tier override or None."""

    def price(self, instance_type: str) -> Optional[float]:
        raise NotImplementedError

    def spot_multiplier(self) -> Optional[float]:
        return None


class StaticPricingSource(PricingSource):
    def __init__(
        self,
        catalog: Dict[str, float],
        spot_multiplier: Optional[float] = None,
    ):
        self._catalog = dict(catalog)
        self._spot = spot_multiplier

    def price(self, instance_type: str) -> Optional[float]:
        value = self._catalog.get(instance_type)
        return None if value is None else float(value)

    def spot_multiplier(self) -> Optional[float]:
        return self._spot


_RECHECK_INTERVAL_S = 1.0  # mtime-poll throttle (see FilePricingSource)


class FilePricingSource(PricingSource):
    """Mtime-reloading file feed (module docstring). The mtime check is
    THROTTLED to once per _RECHECK_INTERVAL_S: pricing a whole fleet
    calls price()/spot_multiplier() per node, and a stat syscall per
    node would put filesystem latency on the reconcile hot path for a
    file that changes at cron cadence. Staleness stays bounded by one
    second — well under a tick."""

    def __init__(self, path: str):
        import time as _time

        self.path = path
        self._clock = _time.monotonic
        self._next_check = 0.0
        self._lock = threading.Lock()
        self._mtime: Optional[float] = None
        self._catalog: Dict[str, float] = {}
        self._spot: Optional[float] = None
        self._refresh()

    def _refresh(self) -> None:
        now = self._clock()
        if now < self._next_check:
            return
        self._next_check = now + _RECHECK_INTERVAL_S
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError as error:
            if self._mtime is not None:
                return  # keep serving the last good catalog
            raise ValueError(
                f"--pricing-file {self.path}: {error}"
            ) from error
        with self._lock:
            if self._mtime is not None and mtime == self._mtime:
                return
            try:
                catalog, spot = _load_pricing_file(self.path)
            except Exception as error:  # noqa: BLE001 — never-block feed
                if self._mtime is None:
                    raise  # a first load must fail loudly, not price $0
                logger().warning(
                    "pricing file %s reload failed (%s: %s); keeping the "
                    "last good catalog",
                    self.path, type(error).__name__, error,
                )
                self._mtime = mtime  # don't re-parse a bad file per tick
                return
            self._catalog = catalog
            self._spot = spot
            self._mtime = mtime

    def price(self, instance_type: str) -> Optional[float]:
        self._refresh()
        with self._lock:
            value = self._catalog.get(instance_type)
        return None if value is None else float(value)

    def spot_multiplier(self) -> Optional[float]:
        self._refresh()
        with self._lock:
            return self._spot


def _load_pricing_file(path: str):
    """(catalog, spot_multiplier | None) from a JSON/YAML pricing file."""
    from karpenter_tpu_torch.utils.configfile import load_json_or_yaml

    doc = load_json_or_yaml(path)
    if not isinstance(doc, dict):
        raise ValueError(
            f"pricing file {path}: expected a mapping, got "
            f"{type(doc).__name__}"
        )
    spot = doc.get("spotMultiplier")
    raw = doc.get("catalog", doc)
    if not isinstance(raw, dict):
        raise ValueError(f"pricing file {path}: 'catalog' must be a mapping")
    catalog: Dict[str, float] = {}
    for key, value in raw.items():
        if key == "spotMultiplier":
            continue
        price = float(value)
        if price < 0:
            raise ValueError(
                f"pricing file {path}: negative price for {key!r}"
            )
        catalog[str(key)] = price
    if spot is not None:
        spot = float(spot)
        if not 0 < spot <= 1:
            raise ValueError(
                f"pricing file {path}: spotMultiplier must be in (0, 1], "
                f"got {spot}"
            )
    return catalog, spot


def pricing_source_for(path: Optional[str]) -> Optional[PricingSource]:
    """The Options/--pricing-file seam: a FilePricingSource when a path
    is configured, else None (the model's built-in catalog serves)."""
    return FilePricingSource(path) if path else None
