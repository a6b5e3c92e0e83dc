"""The reference's tests/test_e2e.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("e2e", globals())
