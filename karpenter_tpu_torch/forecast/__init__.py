"""Predictive scaling subsystem of the port (counterpart of
karpenter_tpu/forecast).

history.py  bounded columnar ring buffers of observed metric samples
models.py   the batched Holt-Winters / robust-linear tensor program, its
            bit-identical numpy mirror and the host seam that runs the
            program on the card
engine.py   FleetForecaster: per-tick orchestration (ingest, skill
            tracking, one batched dispatch for the whole fleet)
"""

from karpenter_tpu_torch.forecast.engine import (
    FleetForecaster,
    REASON_SKILL_DEGRADED,
    REASON_UNAVAILABLE,
    REASON_WARMING_UP,
    query_key,
)
from karpenter_tpu_torch.forecast.history import MetricHistoryStore
from karpenter_tpu_torch.forecast.models import (
    ForecastInputs,
    ForecastOutputs,
    MODEL_CODES,
    MODEL_HOLT_WINTERS,
    MODEL_LINEAR,
    forecast,
    forecast_host,
    forecast_numpy,
)

__all__ = [
    "FleetForecaster",
    "ForecastInputs",
    "ForecastOutputs",
    "MetricHistoryStore",
    "MODEL_CODES",
    "MODEL_HOLT_WINTERS",
    "MODEL_LINEAR",
    "REASON_SKILL_DEGRADED",
    "REASON_UNAVAILABLE",
    "REASON_WARMING_UP",
    "forecast",
    "forecast_host",
    "forecast_numpy",
    "query_key",
]
