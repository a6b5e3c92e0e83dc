"""The reference's tests/test_failover.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("failover", globals())
