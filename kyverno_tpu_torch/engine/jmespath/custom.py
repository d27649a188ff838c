"""Kyverno custom JMESPath functions.

Re-implements the 41 custom functions the reference registers on top of
go-jmespath (reference: pkg/engine/jmespath/functions.go:53-81 and time.go).
Function-by-function semantics follow the Go handlers; arithmetic operand
typing (scalar/quantity/duration) follows pkg/engine/jmespath/arithmetic.go.
"""

from __future__ import annotations

import base64
import binascii
import datetime
import json
import math
import posixpath
import random as _random
import re
from fractions import Fraction
from typing import Any, List, Optional, Tuple

import yaml

from ...utils import wildcard
from ...utils.duration import DurationError, format_duration, parse_duration
from ...utils.quantity import Quantity
from .errors import FunctionError
from .interpreter import FunctionRegistry, jp_type


def _err(fname: str, msg: str) -> FunctionError:
    return FunctionError(f"JMESPath function '{fname}': {msg}")


def _arg_str(fname: str, args, i) -> str:
    v = args[i]
    if not isinstance(v, str):
        raise _err(fname, f'{i + 1} argument is expected of string type')
    return v


def _arg_num(fname: str, args, i) -> float:
    v = args[i]
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise _err(fname, f'{i + 1} argument is expected of number type')
    return v


def _iface_to_string(v: Any) -> str:
    """reference: pkg/engine/jmespath/functions.go:1060 ifaceToString"""
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        # Go strconv.FormatFloat(i, 'f', -1, 32)
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    if isinstance(v, str):
        return v
    raise FunctionError('error, undefined type cast')


# -- string functions --------------------------------------------------------

def _fn_compare(ip, args):
    a = _arg_str('compare', args, 0)
    b = _arg_str('compare', args, 1)
    return (a > b) - (a < b)


def _fn_equal_fold(ip, args):
    a = _arg_str('equal_fold', args, 0)
    b = _arg_str('equal_fold', args, 1)
    return a.casefold() == b.casefold()


def _fn_replace(ip, args):
    s = _arg_str('replace', args, 0)
    old = _arg_str('replace', args, 1)
    new = _arg_str('replace', args, 2)
    n = int(_arg_num('replace', args, 3))
    if n < 0:
        return s.replace(old, new)
    return s.replace(old, new, n)


def _fn_replace_all(ip, args):
    s = _arg_str('replace_all', args, 0)
    return s.replace(_arg_str('replace_all', args, 1),
                     _arg_str('replace_all', args, 2))


def _fn_to_upper(ip, args):
    return _arg_str('to_upper', args, 0).upper()


def _fn_to_lower(ip, args):
    return _arg_str('to_lower', args, 0).lower()


def _fn_trim(ip, args):
    return _arg_str('trim', args, 0).strip(_arg_str('trim', args, 1))


def _fn_split(ip, args):
    s = _arg_str('split', args, 0)
    sep = _arg_str('split', args, 1)
    if sep == '':
        return list(s)  # Go strings.Split splits into characters
    return s.split(sep)


def _fn_path_canonicalize(ip, args):
    # Go filepath.Join(p) == filepath.Clean(p) on a single element (Linux)
    p = _arg_str('path_canonicalize', args, 0)
    if p == '':
        return '.'
    out = posixpath.normpath(p)
    return out


def _fn_truncate(ip, args):
    s = _arg_str('truncate', args, 0)
    length = int(max(0.0, _arg_num('truncate', args, 1)))
    return s[:length]


# -- regex -------------------------------------------------------------------

def _go_template_to_python(repl: str) -> str:
    """Convert a Go regexp replacement template ($1, ${name}) to Python re
    syntax (\\1, \\g<name>)."""
    out = []
    i = 0
    while i < len(repl):
        c = repl[i]
        if c == '\\':
            out.append('\\\\')
            i += 1
        elif c == '$':
            if i + 1 < len(repl) and repl[i + 1] == '$':
                out.append('$')
                i += 2
            elif i + 1 < len(repl) and repl[i + 1] == '{':
                j = repl.find('}', i + 2)
                if j == -1:
                    out.append('$')
                    i += 1
                else:
                    out.append(f'\\g<{repl[i + 2:j]}>')
                    i = j + 1
            else:
                j = i + 1
                while j < len(repl) and (repl[j].isalnum() or repl[j] == '_'):
                    j += 1
                if j == i + 1:
                    out.append('$')
                    i += 1
                else:
                    out.append(f'\\g<{repl[i + 1:j]}>')
                    i = j
        else:
            out.append(c)
            i += 1
    return ''.join(out)


def _fn_regex_replace_all(ip, args):
    pattern = _arg_str('regex_replace_all', args, 0)
    src = _iface_to_string(args[1])
    repl = _iface_to_string(args[2])
    try:
        rx = re.compile(pattern)
    except re.error as e:
        raise _err('regex_replace_all', str(e))
    return rx.sub(_go_template_to_python(repl), src)


def _fn_regex_replace_all_literal(ip, args):
    pattern = _arg_str('regex_replace_all_literal', args, 0)
    src = _iface_to_string(args[1])
    repl = _iface_to_string(args[2])
    try:
        rx = re.compile(pattern)
    except re.error as e:
        raise _err('regex_replace_all_literal', str(e))
    return rx.sub(repl.replace('\\', '\\\\'), src)


def _fn_regex_match(ip, args):
    pattern = _arg_str('regex_match', args, 0)
    src = _iface_to_string(args[1])
    try:
        return re.search(pattern, src) is not None
    except re.error as e:
        raise _err('regex_match', str(e))


def _fn_pattern_match(ip, args):
    pattern = _arg_str('pattern_match', args, 0)
    src = _iface_to_string(args[1])
    return wildcard.match(pattern, src)


def _fn_label_match(ip, args):
    selector, labels = args[0], args[1]
    if not isinstance(selector, dict):
        raise _err('label_match', '1 argument is expected of object type')
    if not isinstance(labels, dict):
        raise _err('label_match', '2 argument is expected of object type')
    for k, v in selector.items():
        if k not in labels or labels[k] != v:
            return False
    return True


# -- arithmetic --------------------------------------------------------------
# Operand model (reference: pkg/engine/jmespath/arithmetic.go):
#   number           -> Scalar
#   string           -> Quantity if parseable, else Duration if parseable
#   mixing Quantity and Duration is an error

_SCALAR, _QUANTITY, _DURATION = 0, 1, 2


def _parse_operand(fname: str, v: Any) -> Tuple[int, Any]:
    if isinstance(v, bool):
        raise _err(fname, 'invalid operands')
    if isinstance(v, (int, float)):
        return _SCALAR, float(v)
    if isinstance(v, str):
        try:
            return _QUANTITY, Quantity.parse(v)
        except ValueError:
            pass
        try:
            return _DURATION, parse_duration(v)
        except DurationError:
            pass
    raise _err(fname, 'invalid operands')


def _parse_operands(fname: str, args) -> Tuple[int, Any, int, Any]:
    t1, v1 = _parse_operand(fname, args[0])
    t2, v2 = _parse_operand(fname, args[1])
    if {t1, t2} == {_QUANTITY, _DURATION}:
        raise _err(fname, 'invalid operands')
    return t1, v1, t2, v2


def _format_quantity(value: Fraction, prefer_binary: bool) -> str:
    """Canonical k8s quantity formatting: largest suffix giving an integer
    mantissa (mirrors resource.Quantity.String() canonicalization)."""
    if value == 0:
        return '0'
    sign = '-' if value < 0 else ''
    v = abs(value)
    if prefer_binary and v.denominator == 1:
        n = v.numerator
        for suffix, mult in (('Ei', 2 ** 60), ('Pi', 2 ** 50), ('Ti', 2 ** 40),
                             ('Gi', 2 ** 30), ('Mi', 2 ** 20), ('Ki', 2 ** 10)):
            if n % mult == 0:
                return f'{sign}{n // mult}{suffix}'
        return f'{sign}{n}'
    # decimal: find the largest power-of-1000 suffix with integer mantissa
    for suffix, exp in (('E', 18), ('P', 15), ('T', 12), ('G', 9), ('M', 6),
                        ('k', 3), ('', 0), ('m', -3), ('u', -6), ('n', -9)):
        scaled = v / Fraction(10) ** exp
        if scaled.denominator == 1:
            return f'{sign}{scaled.numerator}{suffix}'
    # not representable with k8s suffixes: fall back to decimal string
    return f'{sign}{float(v):g}'


def _is_binary(q: Quantity) -> bool:
    return q.suffix in ('Ki', 'Mi', 'Gi', 'Ti', 'Pi', 'Ei')


def _fn_add(ip, args):
    t1, v1, t2, v2 = _parse_operands('add', args)
    if t1 == _QUANTITY and t2 == _QUANTITY:
        return _format_quantity(v1.value + v2.value, _is_binary(v1) or _is_binary(v2))
    if t1 == _DURATION and t2 == _DURATION:
        return format_duration(v1 + v2)
    if t1 == _SCALAR and t2 == _SCALAR:
        return v1 + v2
    raise _err('add', 'types mismatch')


def _fn_subtract(ip, args):
    t1, v1, t2, v2 = _parse_operands('subtract', args)
    if t1 == _QUANTITY and t2 == _QUANTITY:
        return _format_quantity(v1.value - v2.value, _is_binary(v1) or _is_binary(v2))
    if t1 == _DURATION and t2 == _DURATION:
        return format_duration(v1 - v2)
    if t1 == _SCALAR and t2 == _SCALAR:
        return v1 - v2
    raise _err('subtract', 'types mismatch')


def _fn_multiply(ip, args):
    t1, v1, t2, v2 = _parse_operands('multiply', args)
    if t1 == _SCALAR and t2 == _SCALAR:
        return v1 * v2
    if {t1, t2} == {_QUANTITY, _SCALAR}:
        q, s = (v1, v2) if t1 == _QUANTITY else (v2, v1)
        return _format_quantity(q.value * Fraction(str(s)), _is_binary(q))
    if {t1, t2} == {_DURATION, _SCALAR}:
        d, s = (v1, v2) if t1 == _DURATION else (v2, v1)
        seconds = (d / 1e9) * s
        return format_duration(int(seconds * 1e9))
    raise _err('multiply', 'types mismatch')


def _quo_round_down(num: Fraction, den: Fraction, scale: int) -> Fraction:
    """Reference quantity division (arithmetic.go:197 Quantity.Divide):
    inf.Dec QuoRound to ``scale`` (max of the operands' AsDec scales —
    NEGATIVE for decimal-SI suffixes, see Quantity.inf_scale), RoundDown
    (truncation toward zero, the java-style DOWN rounder)."""
    step = Fraction(10) ** scale
    trunc = int(num / den * step)  # Fraction.__int__ truncates toward 0
    return Fraction(trunc) / step


def _fn_divide(ip, args):
    from ...utils.quantity import _fraction_scale
    t1, v1, t2, v2 = _parse_operands('divide', args)
    if t1 == _QUANTITY and t2 == _QUANTITY:
        if v2.value == 0:
            raise _err('divide', 'Zero divisor passed')
        scale = max(v1.inf_scale(), v2.inf_scale())
        return float(_quo_round_down(v1.value, v2.value, scale))
    if t1 == _QUANTITY and t2 == _SCALAR:
        if v2 == 0:
            raise _err('divide', 'Zero divisor passed')
        # the reference reparses the scalar as a quantity ('%v' of the
        # float), whose scale is its decimal-digit count
        f2 = Fraction(str(v2))
        scale = max(v1.inf_scale(), _fraction_scale(f2))
        return _format_quantity(
            _quo_round_down(v1.value, f2, scale), _is_binary(v1))
    if t1 == _DURATION and t2 == _DURATION:
        if v2 == 0:
            raise _err('divide', 'Undefined quotient')
        return (v1 / 1e9) / (v2 / 1e9)
    if t1 == _DURATION and t2 == _SCALAR:
        if v2 == 0:
            raise _err('divide', 'Undefined quotient')
        seconds = (v1 / 1e9) / v2
        return format_duration(int(seconds * 1e9))
    if t1 == _SCALAR and t2 == _SCALAR:
        if v2 == 0:
            raise _err('divide', 'Zero divisor passed')
        return v1 / v2
    raise _err('divide', 'types mismatch')


def _fn_modulo(ip, args):
    t1, v1, t2, v2 = _parse_operands('modulo', args)
    if t1 == _QUANTITY and t2 == _QUANTITY:
        if v1.value.denominator != 1 or v2.value.denominator != 1:
            raise _err('modulo', 'Non-integer argument(s) passed for modulo')
        if v2.value == 0:
            raise _err('modulo', 'Zero divisor passed')
        q = _trunc_mod(int(v1.value), int(v2.value))
        return _format_quantity(Fraction(q), _is_binary(v1) or _is_binary(v2))
    if t1 == _DURATION and t2 == _DURATION:
        if v2 == 0:
            raise _err('modulo', 'Zero divisor passed')
        return format_duration(int(math.fmod(v1, v2)))
    if t1 == _SCALAR and t2 == _SCALAR:
        if v1 != int(v1) or v2 != int(v2):
            raise _err('modulo', 'Non-integer argument(s) passed for modulo')
        if v2 == 0:
            raise _err('modulo', 'Zero divisor passed')
        return float(_trunc_mod(int(v1), int(v2)))
    raise _err('modulo', 'types mismatch')


def _trunc_mod(a: int, b: int) -> int:
    """Exact integer modulo with Go semantics (result takes dividend's sign)."""
    t = abs(a) // abs(b)
    if (a < 0) != (b < 0):
        t = -t
    return a - b * t


# -- encoding ----------------------------------------------------------------

def _fn_base64_decode(ip, args):
    s = _arg_str('base64_decode', args, 0)
    try:
        # surrogateescape round-trips non-UTF-8 bytes like Go's string()
        return base64.b64decode(s, validate=True).decode('utf-8', 'surrogateescape')
    except (binascii.Error, ValueError) as e:
        raise _err('base64_decode', str(e))


def _fn_base64_encode(ip, args):
    s = _arg_str('base64_encode', args, 0)
    return base64.b64encode(s.encode('utf-8')).decode('ascii')


def _fn_parse_json(ip, args):
    s = _arg_str('parse_json', args, 0)
    try:
        return json.loads(s)
    except ValueError as e:
        raise _err('parse_json', str(e))


def _fn_parse_yaml(ip, args):
    s = _arg_str('parse_yaml', args, 0)
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError as e:
        raise _err('parse_yaml', str(e))


def _fn_items(ip, args):
    obj = args[0]
    if not isinstance(obj, dict):
        raise _err('items', '1 argument is expected of object type')
    key_name = _arg_str('items', args, 1)
    val_name = _arg_str('items', args, 2)
    return [{key_name: k, val_name: obj[k]} for k in sorted(obj)]


def _fn_object_from_lists(ip, args):
    keys, values = args[0], args[1]
    if not isinstance(keys, list):
        raise _err('object_from_lists', '1 argument is expected of array type')
    if not isinstance(values, list):
        raise _err('object_from_lists', '2 argument is expected of array type')
    out = {}
    for i, k in enumerate(keys):
        key = _iface_to_string(k)
        out[key] = values[i] if i < len(values) else None
    return out


# -- semver ------------------------------------------------------------------

_SEMVER_RE = re.compile(
    r'^(?P<major>\d+)\.(?P<minor>\d+)\.(?P<patch>\d+)'
    r'(?:-(?P<pre>[0-9A-Za-z.-]+))?(?:\+(?P<build>[0-9A-Za-z.-]+))?$')


def _parse_semver(s: str):
    m = _SEMVER_RE.match(s.strip())
    if not m:
        raise _err('semver_compare', f'invalid semver {s!r}')
    pre = m.group('pre')
    pre_ids: Tuple = ()
    if pre:
        parts = []
        for p in pre.split('.'):
            if p.isdigit():
                parts.append((0, int(p)))
            else:
                parts.append((1, p))
        pre_ids = tuple(parts)
    return (int(m.group('major')), int(m.group('minor')),
            int(m.group('patch')), pre_ids)


def _semver_cmp(a, b) -> int:
    if a[:3] != b[:3]:
        return -1 if a[:3] < b[:3] else 1
    ap, bp = a[3], b[3]
    if ap == bp:
        return 0
    if not ap:
        return 1   # no prerelease > prerelease
    if not bp:
        return -1
    return -1 if ap < bp else (1 if ap > bp else 0)


def _expand_wildcard(op: str, vs: str) -> List[Tuple[str, str]]:
    """Expand x/* wildcard versions in ranges like blang/semver does."""
    parts = vs.split('.')
    wild_at = None
    for i, p in enumerate(parts):
        if p in ('x', 'X', '*'):
            wild_at = i
            break
    if wild_at is None:
        return [(op, vs)]
    base = [p if i < wild_at else '0' for i, p in enumerate(parts)]
    while len(base) < 3:
        base.append('0')
    lo = '.'.join(base[:3])
    if wild_at == 0:
        return [('>=', '0.0.0')] if op in ('', '=', '>=') else [(op, '0.0.0')]
    bump = base[:3]
    bump[wild_at - 1] = str(int(bump[wild_at - 1]) + 1)
    hi = '.'.join(bump)
    if op in ('', '='):
        return [('>=', lo), ('<', hi)]
    if op == '>':
        return [('>=', hi)]
    if op == '>=':
        return [('>=', lo)]
    if op == '<':
        return [('<', lo)]
    if op == '<=':
        return [('<', hi)]
    if op in ('!=', '!'):
        # blang/semver expands !X.x to "<lo AND >=hi", an unsatisfiable
        # range — reproduced bug-for-bug (its own test expects false for
        # any input; reference: pkg/engine/jmespath/functions_test.go:1300)
        return [('<', lo), ('>=', hi)]
    return [(op, lo)]


def _parse_range(rng: str):
    """Parse a blang/semver-style range: ||-separated OR groups of
    space-separated AND comparators."""
    or_groups = []
    for group in rng.split('||'):
        comparators = []
        tokens = group.split()
        i = 0
        while i < len(tokens):
            term = tokens[i]
            # blang/semver accepts a space between operator and version
            if re.fullmatch(r'>=|<=|!=|==|=|>|<|!', term) and i + 1 < len(tokens):
                term = term + tokens[i + 1]
                i += 2
            else:
                i += 1
            m = re.match(r'^(>=|<=|!=|==|=|>|<|!)?\s*(.+)$', term)
            op = m.group(1) or '='
            if op == '!':
                op = '!='
            vs = m.group(2)
            for op2, vs2 in _expand_wildcard(op if op != '==' else '=', vs):
                v = _parse_semver(vs2)
                comparators.append((op2 if op2 != '==' else '=', v))
        or_groups.append(comparators)

    def check(version) -> bool:
        for comps in or_groups:
            ok = True
            for op, v in comps:
                c = _semver_cmp(version, v)
                if op == '=' and c != 0:
                    ok = False
                elif op == '!=' and c == 0:
                    ok = False
                elif op == '>' and c <= 0:
                    ok = False
                elif op == '>=' and c < 0:
                    ok = False
                elif op == '<' and c >= 0:
                    ok = False
                elif op == '<=' and c > 0:
                    ok = False
                if not ok:
                    break
            if ok:
                return True
        return False

    return check


def _fn_semver_compare(ip, args):
    v = _arg_str('semver_compare', args, 0)
    r = _arg_str('semver_compare', args, 1)
    try:
        version = _parse_semver(v)
    except FunctionError:
        # reference ignores parse errors on the version (semver.Parse result
        # unchecked) -> compare with zero version
        version = (0, 0, 0, ())
    return _parse_range(r)(version)


# -- random ------------------------------------------------------------------

def _fn_random(ip, args):
    pattern = args[0]
    if not isinstance(pattern, str) or pattern == '':
        raise _err('random', 'no pattern provided')
    return _generate_from_regex(pattern)


def _generate_from_regex(pattern: str) -> str:
    """Tiny regex-driven string generator covering the subset used in
    policies: literals, [..] classes, \\d \\w, {n}/{n,m}, + * ?, (a|b)."""
    rng = _random.SystemRandom()

    def parse_class(s: str, i: int) -> Tuple[List[str], int]:
        chars: List[str] = []
        assert s[i] == '['
        i += 1
        negate = False
        if i < len(s) and s[i] == '^':
            negate = True
            i += 1
        while i < len(s) and s[i] != ']':
            if i + 2 < len(s) and s[i + 1] == '-' and s[i + 2] != ']':
                chars.extend(chr(c) for c in range(ord(s[i]), ord(s[i + 2]) + 1))
                i += 3
            elif s[i] == '\\' and i + 1 < len(s):
                chars.extend(_ESCAPES.get(s[i + 1], s[i + 1]))
                i += 2
            else:
                chars.append(s[i])
                i += 1
        if i >= len(s):
            raise FunctionError('unterminated character class')
        i += 1
        if negate:
            import string as _string
            allowed = [c for c in _string.printable[:95] if c not in chars]
            chars = allowed
        return chars, i

    def parse_count(s: str, i: int) -> Tuple[int, int]:
        if i < len(s) and s[i] == '{':
            j = s.find('}', i)
            if j == -1:
                raise FunctionError('unterminated quantifier')
            spec = s[i + 1:j]
            if ',' in spec:
                lo, hi = spec.split(',', 1)
                n = rng.randint(int(lo), int(hi or int(lo) + 10))
            else:
                n = int(spec)
            return n, j + 1
        if i < len(s) and s[i] == '+':
            return rng.randint(1, 10), i + 1
        if i < len(s) and s[i] == '*':
            return rng.randint(0, 10), i + 1
        if i < len(s) and s[i] == '?':
            return rng.randint(0, 1), i + 1
        return 1, i

    def gen(s: str) -> str:
        # handle top-level alternation in groups only
        out = []
        i = 0
        while i < len(s):
            c = s[i]
            if c == '[':
                chars, i = parse_class(s, i)
                n, i = parse_count(s, i)
                out.extend(rng.choice(chars) for _ in range(n))
            elif c == '\\' and i + 1 < len(s):
                chars = _ESCAPES.get(s[i + 1], s[i + 1])
                i += 2
                n, i = parse_count(s, i)
                out.extend(rng.choice(chars) for _ in range(n))
            elif c == '(':
                depth = 1
                j = i + 1
                while j < len(s) and depth:
                    if s[j] == '(':
                        depth += 1
                    elif s[j] == ')':
                        depth -= 1
                    j += 1
                if depth:
                    raise FunctionError('unterminated group')
                inner = s[i + 1:j - 1]
                alts = _split_alternation(inner)
                i = j
                n, i = parse_count(s, i)
                out.extend(gen(rng.choice(alts)) for _ in range(n))
            elif c in '^$':
                i += 1
            else:
                i += 1
                n, i = parse_count(s, i)
                out.extend(c for _ in range(n))
        return ''.join(out)

    return gen(pattern)


_ESCAPES = {
    'd': '0123456789',
    'w': 'abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_',
    's': ' \t',
}


def _split_alternation(s: str) -> List[str]:
    alts, depth, cur = [], 0, []
    for c in s:
        if c == '(':
            depth += 1
        elif c == ')':
            depth -= 1
        if c == '|' and depth == 0:
            alts.append(''.join(cur))
            cur = []
        else:
            cur.append(c)
    alts.append(''.join(cur))
    return alts


# -- x509 --------------------------------------------------------------------

def _fn_x509_decode(ip, args):
    s = _arg_str('x509_decode', args, 0)
    try:
        from cryptography import x509 as cx509
        from cryptography.hazmat.primitives.asymmetric import rsa
    except ImportError:  # pragma: no cover
        raise _err('x509_decode', 'x509 support unavailable')
    try:
        cert = cx509.load_pem_x509_certificate(s.encode())
    except ValueError as e:
        raise _err('x509_decode', f'invalid certificate: {e}')

    def name_to_obj(name):
        # mirrors Go pkix.Name JSON shape (subset)
        from cryptography.x509.oid import NameOID
        def get_all(oid):
            return [a.value for a in name.get_attributes_for_oid(oid)]
        cn = get_all(NameOID.COMMON_NAME)
        return {
            'CommonName': cn[0] if cn else '',
            'Country': get_all(NameOID.COUNTRY_NAME),
            'Organization': get_all(NameOID.ORGANIZATION_NAME),
            'OrganizationalUnit': get_all(NameOID.ORGANIZATIONAL_UNIT_NAME),
            'Locality': get_all(NameOID.LOCALITY_NAME),
            'Province': get_all(NameOID.STATE_OR_PROVINCE_NAME),
            'SerialNumber': '',
            'Names': None,
            'ExtraNames': None,
            'StreetAddress': None, 'PostalCode': None,
        }

    pub = cert.public_key()
    public_key = None
    if isinstance(pub, rsa.RSAPublicKey):
        nums = pub.public_numbers()
        public_key = {'N': str(nums.n), 'E': nums.e}

    def ts(t: datetime.datetime) -> str:
        return t.strftime('%Y-%m-%dT%H:%M:%SZ')

    return {
        'SerialNumber': cert.serial_number,
        'Issuer': name_to_obj(cert.issuer),
        'Subject': name_to_obj(cert.subject),
        'NotBefore': ts(cert.not_valid_before_utc),
        'NotAfter': ts(cert.not_valid_after_utc),
        'Version': cert.version.value + 1,
        'IsCA': _cert_is_ca(cert),
        'PublicKey': public_key,
        'PublicKeyAlgorithm': 'RSA' if public_key else '',
    }


def _cert_is_ca(cert) -> bool:
    from cryptography import x509 as cx509
    try:
        bc = cert.extensions.get_extension_for_class(cx509.BasicConstraints)
        return bool(bc.value.ca)
    except cx509.ExtensionNotFound:
        return False


# -- time --------------------------------------------------------------------

RFC3339 = '%Y-%m-%dT%H:%M:%S%z'


def _parse_rfc3339(fname: str, s: str) -> datetime.datetime:
    try:
        t = datetime.datetime.fromisoformat(s.replace('Z', '+00:00'))
        if t.tzinfo is None:
            raise ValueError('missing timezone')
        return t
    except ValueError as e:
        raise _err(fname, f'cannot parse time {s!r}: {e}')


def _format_rfc3339(t: datetime.datetime) -> str:
    s = t.isoformat(timespec='seconds')
    return s.replace('+00:00', 'Z')


_GO_LAYOUT_MAP = [
    ('2006', '%Y'), ('01', '%m'), ('02', '%d'), ('15', '%H'), ('04', '%M'),
    ('05', '%S'), ('January', '%B'), ('Jan', '%b'), ('Monday', '%A'),
    ('Mon', '%a'), ('PM', '%p'), ('pm', '%p'), ('03', '%I'),
    ('-07:00', '%z'), ('-0700', '%z'), ('Z07:00', '%z'), ('Z0700', '%z'),
    ('MST', '%Z'), ('.000', ''), ('.999999999', ''), ('.999', ''), ('06', '%y'),
]


def _go_layout_to_strptime(layout: str) -> str:
    out = layout
    for go, py in _GO_LAYOUT_MAP:
        out = out.replace(go, py)
    return out


def _parse_with_layout(fname: str, layout: str, s: str) -> datetime.datetime:
    if layout == '' or layout == RFC3339:
        return _parse_rfc3339(fname, s)
    fmt = _go_layout_to_strptime(layout)
    try:
        t = datetime.datetime.strptime(s, fmt)
    except ValueError as e:
        raise _err(fname, str(e))
    if t.tzinfo is None:
        t = t.replace(tzinfo=datetime.timezone.utc)
    return t


def _fn_time_since(ip, args):
    layout = _arg_str('time_since', args, 0)
    ts1 = _arg_str('time_since', args, 1)
    ts2 = _arg_str('time_since', args, 2)
    t1 = _parse_with_layout('time_since', layout, ts1)
    if ts2 != '':
        t2 = _parse_with_layout('time_since', layout, ts2)
    else:
        t2 = datetime.datetime.now(datetime.timezone.utc)
    return format_duration(int((t2 - t1).total_seconds() * 1e9))


def _fn_time_now(ip, args):
    return _format_rfc3339(datetime.datetime.now().astimezone())


def _fn_time_now_utc(ip, args):
    return _format_rfc3339(datetime.datetime.now(datetime.timezone.utc))


def _fn_time_to_cron(ip, args):
    t = _parse_rfc3339('time_to_cron', _arg_str('time_to_cron', args, 0))
    # Go Weekday: Sunday=0; Python: Monday=0
    weekday = (t.weekday() + 1) % 7
    return f'{t.minute} {t.hour} {t.day} {t.month} {weekday}'


def _fn_time_add(ip, args):
    t = _parse_rfc3339('time_add', _arg_str('time_add', args, 0))
    try:
        d = parse_duration(_arg_str('time_add', args, 1))
    except DurationError as e:
        raise _err('time_add', str(e))
    return _format_rfc3339(t + datetime.timedelta(microseconds=d / 1000))


def _fn_time_parse(ip, args):
    layout = _arg_str('time_parse', args, 0)
    ts = _arg_str('time_parse', args, 1)
    return _format_rfc3339(_parse_with_layout('time_parse', layout, ts))


def _fn_time_utc(ip, args):
    t = _parse_rfc3339('time_utc', _arg_str('time_utc', args, 0))
    return _format_rfc3339(t.astimezone(datetime.timezone.utc))


def _fn_time_diff(ip, args):
    t1 = _parse_rfc3339('time_diff', _arg_str('time_diff', args, 0))
    t2 = _parse_rfc3339('time_diff', _arg_str('time_diff', args, 1))
    return format_duration(int((t2 - t1).total_seconds() * 1e9))


def _fn_time_before(ip, args):
    t1 = _parse_rfc3339('time_before', _arg_str('time_before', args, 0))
    t2 = _parse_rfc3339('time_before', _arg_str('time_before', args, 1))
    return t1 < t2


def _fn_time_after(ip, args):
    t1 = _parse_rfc3339('time_after', _arg_str('time_after', args, 0))
    t2 = _parse_rfc3339('time_after', _arg_str('time_after', args, 1))
    return t1 > t2


def _fn_time_between(ip, args):
    t = _parse_rfc3339('time_between', _arg_str('time_between', args, 0))
    start = _parse_rfc3339('time_between', _arg_str('time_between', args, 1))
    end = _parse_rfc3339('time_between', _arg_str('time_between', args, 2))
    return start < t < end


def _fn_time_truncate(ip, args):
    t = _parse_rfc3339('time_truncate', _arg_str('time_truncate', args, 0))
    try:
        d = parse_duration(_arg_str('time_truncate', args, 1))
    except DurationError as e:
        raise _err('time_truncate', str(e))
    if d <= 0:
        return _format_rfc3339(t)
    epoch_ns = int(t.timestamp() * 1e9)
    truncated = epoch_ns - (epoch_ns % d)
    out = datetime.datetime.fromtimestamp(truncated / 1e9, t.tzinfo)
    return _format_rfc3339(out)


# ---------------------------------------------------------------------------

def register_custom_functions(r: FunctionRegistry) -> FunctionRegistry:
    """Register all Kyverno custom functions
    (reference: pkg/engine/jmespath/functions.go:118 GetFunctions)."""
    A = lambda *types: {'types': list(types)}  # noqa: E731
    r.register('compare', [A('string'), A('string')], _fn_compare)
    r.register('equal_fold', [A('string'), A('string')], _fn_equal_fold)
    r.register('replace', [A('string'), A('string'), A('string'), A('number')], _fn_replace)
    r.register('replace_all', [A('string'), A('string'), A('string')], _fn_replace_all)
    r.register('to_upper', [A('string')], _fn_to_upper)
    r.register('to_lower', [A('string')], _fn_to_lower)
    r.register('trim', [A('string'), A('string')], _fn_trim)
    r.register('split', [A('string'), A('string')], _fn_split)
    r.register('regex_replace_all', [A('string'), A('string', 'number'), A('string', 'number')], _fn_regex_replace_all)
    r.register('regex_replace_all_literal', [A('string'), A('string', 'number'), A('string', 'number')], _fn_regex_replace_all_literal)
    r.register('regex_match', [A('string'), A('string', 'number')], _fn_regex_match)
    r.register('pattern_match', [A('string'), A('string', 'number')], _fn_pattern_match)
    r.register('label_match', [A('object'), A('object')], _fn_label_match)
    r.register('add', [A('any'), A('any')], _fn_add)
    r.register('subtract', [A('any'), A('any')], _fn_subtract)
    r.register('multiply', [A('any'), A('any')], _fn_multiply)
    r.register('divide', [A('any'), A('any')], _fn_divide)
    r.register('modulo', [A('any'), A('any')], _fn_modulo)
    r.register('base64_decode', [A('string')], _fn_base64_decode)
    r.register('base64_encode', [A('string')], _fn_base64_encode)
    r.register('path_canonicalize', [A('string')], _fn_path_canonicalize)
    r.register('truncate', [A('string'), A('number')], _fn_truncate)
    r.register('semver_compare', [A('string'), A('string')], _fn_semver_compare)
    r.register('parse_json', [A('string')], _fn_parse_json)
    r.register('parse_yaml', [A('string')], _fn_parse_yaml)
    r.register('items', [A('object'), A('string'), A('string')], _fn_items)
    r.register('object_from_lists', [A('array'), A('array')], _fn_object_from_lists)
    r.register('random', [A('string')], _fn_random)
    r.register('x509_decode', [A('string')], _fn_x509_decode)
    r.register('time_since', [A('string'), A('string'), A('string')], _fn_time_since)
    r.register('time_now', [], _fn_time_now)
    r.register('time_now_utc', [], _fn_time_now_utc)
    r.register('time_add', [A('string'), A('string')], _fn_time_add)
    r.register('time_parse', [A('string'), A('string')], _fn_time_parse)
    r.register('time_to_cron', [A('string')], _fn_time_to_cron)
    r.register('time_utc', [A('string')], _fn_time_utc)
    r.register('time_diff', [A('string'), A('string')], _fn_time_diff)
    r.register('time_before', [A('string'), A('string')], _fn_time_before)
    r.register('time_after', [A('string'), A('string')], _fn_time_after)
    r.register('time_between', [A('string'), A('string'), A('string')], _fn_time_between)
    r.register('time_truncate', [A('string'), A('string')], _fn_time_truncate)
    return r
