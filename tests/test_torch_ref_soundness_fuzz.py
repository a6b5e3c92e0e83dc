"""The reference's tests/test_soundness_fuzz.py, run against the port."""

from test_torch_reference_suites import load_suite

load_suite("soundness_fuzz", globals())
