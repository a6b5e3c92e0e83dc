"""The reference's tests/test_real_apiserver.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("real_apiserver", globals())
