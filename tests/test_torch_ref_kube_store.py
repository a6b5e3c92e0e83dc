"""The reference's tests/test_kube_store.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("kube_store", globals())
