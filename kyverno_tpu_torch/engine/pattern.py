"""Leaf pattern validation: scalar value vs pattern.

Re-implements the reference's leaf comparison semantics
(reference: pkg/engine/pattern/pattern.go, pkg/engine/operator/operator.go):

* pattern types: bool / int / float / nil / map (existence only) / string
* string pattern grammar: ``|``-separated OR of ``&``-separated AND terms;
  each term optionally prefixed by an operator ``>= <= > < !`` or a range
  ``x-y`` (in range) / ``x!-y`` (not in range)
* string terms compare as Go duration, then k8s quantity, then wildcard string
* cross-type coercions (string-int, float-int, nil-zero) follow the reference.
"""

from __future__ import annotations

import math
import re
from typing import Any

from ..utils import wildcard
from ..utils.duration import parse_duration
from ..utils.quantity import Quantity

# Operators, ordered so longer prefixes are tried first.
OP_EQUAL = ''
OP_MORE_EQUAL = '>='
OP_LESS_EQUAL = '<='
OP_NOT_EQUAL = '!'
OP_MORE = '>'
OP_LESS = '<'
OP_IN_RANGE = '-'
OP_NOT_IN_RANGE = '!-'

IN_RANGE_RE = re.compile(r'^([-|+]?\d+(?:\.\d+)?[A-Za-z]*)-([-|+]?\d+(?:\.\d+)?[A-Za-z]*)$')
NOT_IN_RANGE_RE = re.compile(r'^([-|+]?\d+(?:\.\d+)?[A-Za-z]*)!-([-|+]?\d+(?:\.\d+)?[A-Za-z]*)$')


def get_operator_from_string_pattern(pattern: str) -> str:
    """Parse the leading operator from a string pattern
    (reference: pkg/engine/operator/operator.go:36)."""
    if len(pattern) < 2:
        return OP_EQUAL
    if pattern.startswith(OP_MORE_EQUAL):
        return OP_MORE_EQUAL
    if pattern.startswith(OP_LESS_EQUAL):
        return OP_LESS_EQUAL
    if pattern.startswith(OP_MORE):
        return OP_MORE
    if pattern.startswith(OP_LESS):
        return OP_LESS
    if pattern.startswith(OP_NOT_EQUAL):
        return OP_NOT_EQUAL
    if NOT_IN_RANGE_RE.match(pattern):
        return OP_NOT_IN_RANGE
    if IN_RANGE_RE.match(pattern):
        return OP_IN_RANGE
    return OP_EQUAL


def validate(value: Any, pattern: Any) -> bool:
    """Validate a scalar resource value against a pattern leaf
    (reference: pkg/engine/pattern/pattern.go:26)."""
    if isinstance(pattern, bool):  # bool before int: Python bool is int
        return _validate_bool(value, pattern)
    if isinstance(pattern, int):
        return _validate_int(value, pattern)
    if isinstance(pattern, float):
        return _validate_float(value, pattern)
    if pattern is None:
        return _validate_nil(value)
    if isinstance(pattern, dict):
        return isinstance(value, dict)
    if isinstance(pattern, str):
        return _validate_string_patterns(value, pattern)
    if isinstance(pattern, list):
        return False  # arrays are not supported as patterns
    return False


def _validate_bool(value: Any, pattern: bool) -> bool:
    return isinstance(value, bool) and value == pattern


def _validate_int(value: Any, pattern: int) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, int):
        return value == pattern
    if isinstance(value, float):
        if value != math.trunc(value):
            return False
        return int(value) == pattern
    if isinstance(value, str):
        try:
            return int(value, 10) == pattern
        except ValueError:
            return False
    return False


def _validate_float(value: Any, pattern: float) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, int):
        if pattern != math.trunc(pattern):
            return False
        return int(pattern) == value
    if isinstance(value, float):
        return value == pattern
    if isinstance(value, str):
        try:
            return float(value) == pattern
        except ValueError:
            return False
    return False


def _validate_nil(value: Any) -> bool:
    if value is None:
        return True
    if isinstance(value, bool):
        return not value
    if isinstance(value, float):
        return value == 0.0
    if isinstance(value, int):
        return value == 0
    if isinstance(value, str):
        return value == ''
    return False


def _validate_string_patterns(value: Any, pattern: str) -> bool:
    if value == pattern:
        return True
    for condition in pattern.split('|'):
        if _check_and_conditions(value, condition.strip(' ')):
            return True
    return False


def _check_and_conditions(value: Any, pattern: str) -> bool:
    return all(
        _validate_string_pattern(value, c.strip(' '))
        for c in pattern.split('&')
    )


def _validate_string_pattern(value: Any, pattern: str) -> bool:
    op = get_operator_from_string_pattern(pattern)
    if op == OP_IN_RANGE:
        m = IN_RANGE_RE.match(pattern)
        if not m:
            return False
        return (_validate_string_pattern(value, f'>= {m.group(1)}')
                and _validate_string_pattern(value, f'<= {m.group(2)}'))
    if op == OP_NOT_IN_RANGE:
        m = NOT_IN_RANGE_RE.match(pattern)
        if not m:
            return False
        return (_validate_string_pattern(value, f'< {m.group(1)}')
                or _validate_string_pattern(value, f'> {m.group(2)}'))
    term = pattern[len(op):].strip(' ')
    return _validate_string(value, term, op)


def _validate_string(value: Any, pattern: str, op: str) -> bool:
    return (_compare_duration(value, pattern, op)
            or _compare_quantity(value, pattern, op)
            or _compare_string(value, pattern, op))


def _number_to_string(value: Any):
    if value is None:
        return '0'
    if isinstance(value, bool):
        return None
    if isinstance(value, str):
        return value
    if isinstance(value, float):
        return f'{value:f}'
    if isinstance(value, int):
        return str(value)
    return None


_CMP = {
    OP_EQUAL: lambda c: c == 0,
    OP_NOT_EQUAL: lambda c: c != 0,
    OP_MORE: lambda c: c > 0,
    OP_LESS: lambda c: c < 0,
    OP_MORE_EQUAL: lambda c: c >= 0,
    OP_LESS_EQUAL: lambda c: c <= 0,
}


def _compare_duration(value: Any, pattern: str, op: str) -> bool:
    try:
        p = parse_duration(pattern)
    except ValueError:
        return False
    v = _number_to_string(value)
    if v is None:
        return False
    try:
        v = parse_duration(v)
    except ValueError:
        return False
    f = _CMP.get(op)
    return bool(f and f((v > p) - (v < p)))


def _compare_quantity(value: Any, pattern: str, op: str) -> bool:
    try:
        p = Quantity.parse(pattern)
    except ValueError:
        return False
    v = _number_to_string(value)
    if v is None:
        return False
    try:
        v = Quantity.parse(v)
    except ValueError:
        return False
    f = _CMP.get(op)
    return bool(f and f(v.cmp(p)))


def _compare_string(value: Any, pattern: str, op: str) -> bool:
    if op not in (OP_EQUAL, OP_NOT_EQUAL):
        return False  # ordering operators don't apply to plain strings
    if isinstance(value, bool):
        s = 'true' if value else 'false'
    elif isinstance(value, float):
        # Go strconv.FormatFloat(v, 'E', -1, 64)
        s = _go_format_float_e(value)
    elif isinstance(value, int):
        s = str(value)
    elif isinstance(value, str):
        s = value
    else:
        return False
    result = wildcard.match(pattern, s)
    return (not result) if op == OP_NOT_EQUAL else result


def _go_format_float_e(v: float) -> str:
    """Go strconv.FormatFloat(v,'E',-1,64): shortest repr in E-notation."""
    s = repr(v)  # shortest round-trip decimal
    mant, _, exp = s.partition('e')
    if exp:
        e = int(exp)
    else:
        e = 0
    # normalize mantissa to d.ddd
    neg = mant.startswith('-')
    if neg:
        mant = mant[1:]
    int_part, _, frac = mant.partition('.')
    digits = (int_part + frac).lstrip('0') or '0'
    point = len(int_part.lstrip('0')) if int_part.lstrip('0') else -(len(frac) - len(frac.lstrip('0')))
    if digits == '0':
        norm, e2 = '0', 0
    else:
        norm = digits[0] + ('.' + digits[1:].rstrip('0') if digits[1:].rstrip('0') else '')
        e2 = e + point - 1
    sign = '-' if e2 < 0 else '+'
    return f"{'-' if neg else ''}{norm}E{sign}{abs(e2):02d}"
