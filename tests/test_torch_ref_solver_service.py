"""The reference's tests/test_solver_service.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("solver_service", globals())
