"""Kubernetes resource.Quantity semantics (the port's copy of
karpenter_tpu/utils/quantity.py: the C parser of native/quantity.c once
its background build has loaded, the regex parser, its oracle, until
then; and a memo of the canonical rendering).

The reference accumulates pod resource requests and node allocatable as
k8s.io/apimachinery resource.Quantity values and renders them into status
strings (reference: pkg/metrics/producers/reservedcapacity/producer.go:63-86,
reservations.go:45-56). Matching its output exactly ("7600m", "77Gi",
"385500Mi", "150") requires the same parse + canonical-format rules, so this
module models the three behaviors we depend on:

- parse of decimal/binary suffixed quantities ("1100m", "25Gi", "99", "128500Mi")
- Add() adopting the other operand's format when the receiver is zero
- String() canonicalization: binary quantities pick the largest power-of-1024
  suffix with an integer mantissa; decimal quantities pick the largest
  power-of-1000 (engineering) exponent with an integer mantissa.

Values are exact (fractions.Fraction); device math uses float arrays converted
via .to_float() / unit helpers, never this class.
"""

from __future__ import annotations

import functools
import re
from fractions import Fraction

DECIMAL_SI = "DecimalSI"
BINARY_SI = "BinarySI"
DECIMAL_EXPONENT = "DecimalExponent"

_BINARY_SUFFIXES = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)"
    r"(?:(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|[numkMGTPE])|(?P<exp>[eE][+-]?\d+))?$"
)

# format codes returned by the native parser (karpenter_tpu_torch/native)
_NATIVE_FORMATS = (DECIMAL_SI, BINARY_SI, DECIMAL_EXPONENT)
_native_kicked = False


def _native_parser():
    """The C parser once its background build/load completes, else None
    (pure-Python oracle runs). The first call only KICKS OFF the build in a
    daemon thread — a cold compile never blocks a parse, so e.g. the first
    AdmissionReview a webhook validates is served at Python speed instead
    of waiting on cc."""
    global _native_kicked
    try:
        from karpenter_tpu_torch import native
    except Exception:
        return None
    if not _native_kicked:
        _native_kicked = True
        try:
            native.ensure_kquantity_async()
        except Exception:
            pass
    return native.peek_kquantity()


class Quantity:
    """Exact-arithmetic quantity with a preferred display format."""

    __slots__ = ("value", "format", "_float")

    def __init__(self, value: Fraction | int = 0, format: str = DECIMAL_SI):
        self.value = Fraction(value)
        self.format = format
        self._float: float | None = None  # to_float memo (hot watch path)

    @classmethod
    def parse(cls, s: str) -> "Quantity":
        if isinstance(s, Quantity):
            return Quantity(s.value, s.format)
        if isinstance(s, (int, float)):
            return Quantity(Fraction(s), DECIMAL_SI)
        native = _native_parser()
        if native is not None:
            try:
                num, den, fmt = native.parse(s)
            except ValueError:
                pass  # overflow or unrecognized: the regex path decides
            else:
                q = cls.__new__(cls)
                q.value = Fraction(num, den)
                q.format = _NATIVE_FORMATS[fmt]
                q._float = None
                return q
        m = _QUANTITY_RE.match(s.strip())
        if m is None:
            raise ValueError(f"unable to parse quantity {s!r}")
        num = Fraction(m.group("num"))
        if m.group("sign") == "-":
            num = -num
        suffix = m.group("suffix")
        exp = m.group("exp")
        if suffix in _BINARY_SUFFIXES:
            return cls(num * _BINARY_SUFFIXES[suffix], BINARY_SI)
        if suffix is not None:
            return cls(num * _DECIMAL_SUFFIXES[suffix], DECIMAL_SI)
        if exp is not None:
            return cls(num * Fraction(10) ** int(exp[1:]), DECIMAL_EXPONENT)
        return cls(num, DECIMAL_SI)

    def add(self, other: "Quantity") -> "Quantity":
        # Zero receivers adopt the operand's format, mirroring apimachinery's
        # Quantity.Add — this is what makes an all-Gi accumulation print "77Gi"
        # even though the accumulator started as DecimalSI zero.
        fmt = other.format if self.value == 0 else self.format
        return Quantity(self.value + other.value, fmt)

    def sub(self, other: "Quantity") -> "Quantity":
        fmt = other.format if self.value == 0 else self.format
        return Quantity(self.value - other.value, fmt)

    def to_float(self) -> float:
        # memoized: Quantity is immutable by contract, and the columnar
        # feed calls this for every request of every watch-delivered pod
        # (Fraction->float division is the costly part)
        # getattr default: __new__/deepcopy paths can leave the slot unset
        f = getattr(self, "_float", None)
        if f is None:
            f = self._float = float(self.value)
        return f

    def milli(self) -> int:
        """Value in thousandths, rounded up (k8s MilliValue semantics)."""
        v = self.value * 1000
        return int(v) if v.denominator == 1 else int(v) + (1 if v > 0 else 0)

    def __eq__(self, other) -> bool:
        return isinstance(other, Quantity) and self.value == other.value

    def __lt__(self, other: "Quantity") -> bool:
        return self.value < other.value

    def __le__(self, other: "Quantity") -> bool:
        return self.value <= other.value

    def __hash__(self):
        return hash(self.value)

    def __repr__(self) -> str:
        return f"Quantity({str(self)!r})"

    def __str__(self) -> str:
        return _render(self.value, self.format)


@functools.lru_cache(maxsize=4096)
def _render(v: Fraction, fmt: str) -> str:
    """String() of a value in a format (Quantity.__str__), memoized:
    clusters repeat a handful of request and allocatable values, and the
    store's codec renders each one per object."""
    if v == 0:
        return "0"
    sign = "-" if v < 0 else ""
    if v < 0:
        v = -v
    if fmt == BINARY_SI:
        text = _binary_str(v, sign)
        if text is not None:
            return text
        # fractional binary quantities fall back to milli, like k8s
        # does when forced below base units
    # decimal canonicalization: largest engineering exponent with an
    # integer mantissa
    for suffix in ("E", "P", "T", "G", "M", "k", "", "m", "u", "n"):
        unit = _DECIMAL_SUFFIXES[suffix]
        scaled = v / unit
        if scaled.denominator == 1:
            return f"{sign}{scaled}{suffix}"
    # sub-nano: round up to nano (k8s rounds up when precision is lost)
    scaled = v / _DECIMAL_SUFFIXES["n"]
    return f"{sign}{int(scaled) + 1}n"


def _binary_str(v, sign: str):
    """Canonical binary-SI rendering: the largest Ki..Ei suffix with an
    integer mantissa, else the bare integer; None when v is fractional
    below base units (caller falls back to decimal)."""
    for suffix in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
        unit = _BINARY_SUFFIXES[suffix]
        if v >= unit and (v / unit).denominator == 1:
            return f"{sign}{v // unit}{suffix}"
    if v.denominator == 1:
        return f"{sign}{v}"
    return None


def parse_quantity(s) -> Quantity:
    return Quantity.parse(s)


def zero() -> Quantity:
    return Quantity(0, DECIMAL_SI)
