"""The reference's tests/test_numpy_binpack.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("numpy_binpack", globals())
