"""The port's native quantity parser (karpenter_tpu_torch/native/quantity.c,
built into karpenter_tpu_torch/_build/) against the Python oracle and the
reference's parser (karpenter_tpu/native/quantity.c), on the CPU.

tests/test_native_quantity.py's cases run on the port: exact value and
format parity with the regex+Fraction oracle, the fuzz, the invalid
strings, the overflow that declines instead of truncating, the
background build that Quantity.parse converges to, and the canonical
rendering through the public API. Parity with the reference: the two
parsers return the same (num, den, fmt) for every string, and
Quantity.parse of both packages gives equal values, formats and strings.
"""

from __future__ import annotations

import random
import time
from fractions import Fraction

import pytest

from karpenter_tpu import native as ref_native_pkg
from karpenter_tpu.utils import quantity as RQ
from karpenter_tpu_torch import native as native_pkg
from karpenter_tpu_torch.utils import quantity as Q

native = native_pkg.load_kquantity()
ref_native = ref_native_pkg.load_kquantity()

pytestmark = pytest.mark.skipif(
    native is None or ref_native is None, reason="no C toolchain available"
)

CASES = [
    "0", "1", "100m", "1500m", "1100m", "25Gi", "99", "128500Mi", "1.5",
    "0.5", ".5", "5.", "1Ki", "2Mi", "3Ti", "4Pi", "1Ei", "1n", "2u",
    "3k", "4M", "5G", "6T", "7P", "1E", "-1", "-100m", "+2Gi", "1e3",
    "1E3", "2e-3", "1.25e2", "  25Gi  ", "0.000001", "123.456789",
    "110", "7600m", "48900m", "77Gi", "385500Mi", "150",
]
INVALID = ["", "abc", "1.2.3", "1X", "Ki", "--1", "1e", "1ee3", ".", "1 2",
           "0x10", "1\x00", "2.5\x00", "\x00", "1Gi\x00"]


def regex_parse(s):
    """The pure-Python oracle, bypassing the native fast path."""
    m = Q._QUANTITY_RE.match(s.strip())
    num = Fraction(m.group("num"))
    if m.group("sign") == "-":
        num = -num
    suffix, exp = m.group("suffix"), m.group("exp")
    if suffix in Q._BINARY_SUFFIXES:
        return num * Q._BINARY_SUFFIXES[suffix], Q.BINARY_SI
    if suffix is not None:
        return num * Q._DECIMAL_SUFFIXES[suffix], Q.DECIMAL_SI
    if exp is not None:
        return num * Fraction(10) ** int(exp[1:]), Q.DECIMAL_EXPONENT
    return num, Q.DECIMAL_SI


def fuzz_strings(seed, n):
    rng = random.Random(seed)
    suffixes = ["", "m", "k", "M", "G", "Ki", "Mi", "Gi", "Ti", "n", "u",
                "T", "P", "E", "Pi", "Ei", "e2", "e-4", "E+6"]
    for _ in range(n):
        mantissa = rng.choice([
            str(rng.randint(0, 10**rng.randint(1, 12))),
            f"{rng.randint(0, 10**6)}.{rng.randint(0, 10**6)}",
            f".{rng.randint(1, 10**6)}",
        ])
        yield rng.choice(["", "-", "+"]) + mantissa + rng.choice(suffixes)


def parse_or_error(parser, s):
    try:
        return parser.parse(s)
    except ValueError:
        return "ValueError"


def test_built_into_the_ports_build_dir():
    assert native.__file__.startswith(native_pkg._BUILD_DIR)
    assert native.__file__ != ref_native.__file__
    assert native_pkg.peek_kquantity() is native


class TestParity:
    @pytest.mark.parametrize("s", CASES)
    def test_exact_value_and_format(self, s):
        num, den, fmt = native.parse(s)
        value, expect_format = regex_parse(s)
        assert Fraction(num, den) == value, s
        assert Q._NATIVE_FORMATS[fmt] == expect_format, s
        assert (num, den, fmt) == ref_native.parse(s)

    @pytest.mark.parametrize("seed", [11, 12, 13])
    def test_fuzz_against_oracle_and_reference(self, seed):
        declined = 0
        for s in fuzz_strings(seed, 3000):
            got = parse_or_error(native, s)
            assert got == parse_or_error(ref_native, s), s
            if got == "ValueError":
                declined += 1
                continue
            num, den, fmt = got
            value, expect_format = regex_parse(s)
            assert Fraction(num, den) == value, s
            assert Q._NATIVE_FORMATS[fmt] == expect_format, s
        assert declined < 300

    @pytest.mark.parametrize("s", INVALID)
    def test_rejects_invalid(self, s):
        with pytest.raises(ValueError):
            native.parse(s)
        assert Q._QUANTITY_RE.match(s.strip()) is None

    def test_overflow_declines_instead_of_truncating(self):
        with pytest.raises(ValueError):
            native.parse("9" * 60)
        assert Q.Quantity.parse("9" * 60).value == Fraction("9" * 60)

    def test_formats_are_the_references(self):
        assert Q._NATIVE_FORMATS == RQ._NATIVE_FORMATS


class TestAsyncLoad:
    def test_background_build_becomes_visible(self):
        Q._native_parser()
        deadline = time.time() + 30
        while native_pkg.peek_kquantity() is None and time.time() < deadline:
            time.sleep(0.05)
        assert native_pkg.peek_kquantity() is not None
        assert Q._native_parser() is native_pkg.peek_kquantity()


class TestIntegration:
    def test_public_parse_uses_same_semantics(self):
        assert str(Q.Quantity.parse("25Gi")) == "25Gi"
        assert str(Q.Quantity.parse("1100m")) == "1100m"
        assert str(Q.Quantity.parse("128500Mi")) == "128500Mi"
        assert Q.Quantity.parse("1500m").to_float() == pytest.approx(1.5)
        total = Q.Quantity()
        for _ in range(77):
            total = total.add(Q.Quantity.parse("1Gi"))
        assert str(total) == "77Gi"

    @pytest.mark.parametrize("seed", [21, 22])
    def test_quantity_parse_equals_the_reference(self, seed):
        """Quantity.parse of both packages, each through its C parser:
        equal values, formats, floats and canonical strings."""
        Q._native_parser()
        RQ._native_parser()
        strings = CASES + list(fuzz_strings(seed, 2000)) + ["9" * 60]
        for s in strings:
            got, want = Q.Quantity.parse(s), RQ.Quantity.parse(s)
            assert (got.value, got.format) == (want.value, want.format), s
            assert got.to_float() == want.to_float(), s
            assert str(got) == str(want), s

    def test_speedup_sanity(self):
        strings = CASES * 200
        t0 = time.perf_counter()
        for s in strings:
            parse_or_error(native, s)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        for s in strings:
            regex_parse(s)
        assert t_native < time.perf_counter() - t0
