"""The reference's tests/test_faults.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("faults", globals())
