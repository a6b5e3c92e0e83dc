"""The reference's tests/test_decision_kernel.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("decision_kernel", globals())
