"""Forecasting models of the port (counterpart of karpenter_tpu/forecast)."""
