"""The reference's tests/test_encoder_delta.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("encoder_delta", globals())
