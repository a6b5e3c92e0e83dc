"""The reference's tests/test_forecast.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("forecast", globals())
