"""The reference's tests/test_apiserver_conformance.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("apiserver_conformance", globals())
