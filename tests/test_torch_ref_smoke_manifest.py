"""The reference's tests/test_smoke_manifest.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("smoke_manifest", globals())
