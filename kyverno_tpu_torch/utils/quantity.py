"""Kubernetes resource.Quantity parsing and comparison.

Re-implements the subset of k8s.io/apimachinery/pkg/api/resource used by the
reference's leaf pattern comparisons (reference: pkg/engine/pattern/pattern.go:239
compareQuantity) and JMESPath arithmetic (pkg/engine/jmespath/arithmetic.go).

Quantities are exact decimal numbers with an optional suffix:
  binary SI:  Ki Mi Gi Ti Pi Ei      (2**10 ..)
  decimal SI: n u m "" k M G T P E   (1e-9 ..)
  scientific: 12e6, 1.5E3

Internally represented as an exact ``fractions.Fraction`` so comparisons are
bit-exact like the reference's infinite-precision math.
"""

from __future__ import annotations

import re
from fractions import Fraction

_BINARY = {
    'Ki': 2 ** 10, 'Mi': 2 ** 20, 'Gi': 2 ** 30,
    'Ti': 2 ** 40, 'Pi': 2 ** 50, 'Ei': 2 ** 60,
}
_DECIMAL = {
    'n': Fraction(1, 10 ** 9), 'u': Fraction(1, 10 ** 6), 'm': Fraction(1, 1000),
    '': Fraction(1), 'k': Fraction(10 ** 3), 'M': Fraction(10 ** 6),
    'G': Fraction(10 ** 9), 'T': Fraction(10 ** 12), 'P': Fraction(10 ** 15),
    'E': Fraction(10 ** 18),
}

_DEC_EXP = {'n': -9, 'u': -6, 'm': -3, '': 0, 'k': 3, 'M': 6,
            'G': 9, 'T': 12, 'P': 15, 'E': 18}

_QTY_RE = re.compile(
    r'^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)'
    r'(?P<suffix>(?:[eE][+-]?\d+)|(?:Ki|Mi|Gi|Ti|Pi|Ei)|[numkMGTPE]?)$'
)


def _fraction_scale(v: Fraction) -> int:
    """Decimal digits after the point of the exact value (denominators
    here are always 2^a·5^b products)."""
    d = v.denominator
    twos = 0
    while d % 2 == 0:
        d //= 2
        twos += 1
    fives = 0
    while d % 5 == 0:
        d //= 5
        fives += 1
    return max(twos, fives)


class Quantity:
    """An exact Kubernetes quantity."""

    __slots__ = ('value', 'suffix')

    def __init__(self, value: Fraction, suffix: str = ''):
        self.value = value
        self.suffix = suffix

    @classmethod
    def parse(cls, s: str) -> 'Quantity':
        if not isinstance(s, str):
            raise ValueError(f"cannot parse quantity from {type(s)}")
        s = s.strip()
        m = _QTY_RE.match(s)
        if not m:
            raise ValueError(f"unable to parse quantity's suffix: {s!r}")
        sign = -1 if m.group('sign') == '-' else 1
        num = Fraction(m.group('num'))
        suffix = m.group('suffix')
        if suffix and suffix[0] in 'eE':
            mult = Fraction(10) ** int(suffix[1:])
        elif suffix in _BINARY:
            mult = Fraction(_BINARY[suffix])
        elif suffix in _DECIMAL:
            mult = _DECIMAL[suffix]
        else:  # pragma: no cover - regex prevents this
            raise ValueError(f"unknown suffix {suffix!r}")
        return cls(sign * num * mult, suffix)

    def inf_scale(self) -> int:
        """``resource.Quantity.AsDec().Scale()`` of the Go reference:
        the int64Amount keeps (mantissa-digits, base-10 exponent), and
        AsDec is ``inf.NewDec(value, -scale)`` — so decimal suffixes
        yield NEGATIVE inf scales ('3G' → -9) and sub-unit forms
        positive ones ('100m' → 3).  Binary-suffix quantities parse to
        plain integers (scale from any fractional remainder only).
        Drives the QuoRound truncation scale of quantity division
        (reference: pkg/engine/jmespath/arithmetic.go:197)."""
        sfx = self.suffix
        if sfx in _BINARY:
            return _fraction_scale(self.value)
        if sfx and sfx[0] in 'eE':
            e = int(sfx[1:])
        else:
            e = _DEC_EXP[sfx]
        mantissa = self.value / Fraction(10) ** e
        return _fraction_scale(mantissa) - e

    def cmp(self, other: 'Quantity') -> int:
        if self.value < other.value:
            return -1
        if self.value > other.value:
            return 1
        return 0

    def __repr__(self):
        return f"Quantity({self.value}{self.suffix and ' ' + self.suffix})"

    def to_float(self) -> float:
        return float(self.value)


def parse_quantity(s: str) -> Quantity:
    return Quantity.parse(s)


def is_quantity(s: str) -> bool:
    try:
        Quantity.parse(s)
        return True
    except (ValueError, TypeError):
        return False
