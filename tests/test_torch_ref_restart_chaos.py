"""The reference's tests/test_restart_chaos.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("restart_chaos", globals())
