"""Provenance ledger -> labeled training/eval stream (docs/simulator.md).

The decision-provenance ledger (observability/provenance.py) already
records, for every committed HA decision, exactly the supervision a
policy learner wants: the observed metric values and replica counts as
FEATURES, and the `winning_stage` — which pipeline stage best explains
the final desired count — plus the final count itself as LABELS.
`label_stream` reads that ring through the public `query()` surface
and reshapes it into flat numeric rows, so policy search / offline
eval consumes the SAME records operators debug with, with no second
bookkeeping path to drift.

Row shape (all floats; None-able ledger columns become NaN so numpy
consumers can mask):

  features  prev_replicas, base_desired, forecast_value,
            forecast_skill, cost_hourly, cost_risk, observed metric
            values (first OBSERVED_WIDTH, NaN-padded)
  labels    final_desired, stage (index into provenance.STAGES via
            `stage_index`)
"""

from __future__ import annotations

import math
from typing import List, Optional

from karpenter_tpu_torch.observability.provenance import (
    OBSERVED_WIDTH,
    STAGES,
    default_ledger,
)

FEATURE_NAMES = (
    "prev_replicas",
    "base_desired",
    "forecast_value",
    "forecast_skill",
    "cost_hourly",
    "cost_risk",
) + tuple(f"observed_{i}" for i in range(OBSERVED_WIDTH))


def stage_index(stage: Optional[str]) -> int:
    """The stable label index of a winning stage (precedence order of
    provenance.STAGES); unknown/empty stages map to -1 so a consumer
    can drop or bucket them explicitly."""
    try:
        return STAGES.index(stage)
    except ValueError:
        return -1


def _float(value) -> float:
    if value is None:
        return math.nan
    return float(value)


def label_stream(
    ledger=None,
    kind: Optional[str] = None,
    tenant: Optional[str] = None,
    limit: Optional[int] = None,
) -> List[dict]:
    """Labeled rows from the ledger (the process default when `ledger`
    is None), oldest-first. Each row carries `features` (ordered by
    FEATURE_NAMES), `label_desired`, `label_stage` (index), plus the
    identity columns (`kind`/`tenant`/`name`/`group`/`stage`) for
    slicing an eval set."""
    ledger = ledger if ledger is not None else default_ledger()
    rows = []
    for record in ledger.query(kind=kind, tenant=tenant, limit=limit):
        observed = list(record.get("observed") or [])
        observed += [math.nan] * (OBSERVED_WIDTH - len(observed))
        features = [
            _float(record.get("prev_replicas")),
            _float(record.get("base_desired")),
            _float(record.get("forecast_value")),
            _float(record.get("forecast_skill")),
            _float(record.get("cost_hourly")),
            _float(record.get("cost_risk")),
        ] + observed[:OBSERVED_WIDTH]
        rows.append({
            "features": features,
            "label_desired": _float(record.get("final_desired")),
            "label_stage": stage_index(record.get("winning_stage")),
            "stage": record.get("winning_stage") or "",
            "kind": record.get("kind") or "",
            "tenant": record.get("tenant") or "",
            "name": record.get("name") or "",
            "group": record.get("group") or "",
        })
    return rows
