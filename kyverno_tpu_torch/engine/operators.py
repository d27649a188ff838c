"""Condition operators for preconditions / deny conditions.

Re-implements the 18 operators of the reference
(reference: api/kyverno/v1/common_types.go:203-246 ConditionOperators,
pkg/engine/variables/operator/*.go):

Equal(s), NotEqual(s), In, AnyIn, AllIn, NotIn, AnyNotIn, AllNotIn,
GreaterThan(OrEquals), LessThan(OrEquals), Duration* (deprecated).

Type-coercion quirks preserved: wildcard matching on strings (both
directions for the In family), duration-before-quantity for Equals,
quantity/semver/float fallbacks for numeric comparison, ranges
("1-10") inside AnyIn/AllIn string values.
"""

from __future__ import annotations

import json
import math
from typing import Any, List, Optional, Tuple

from ..utils import wildcard
from ..utils.duration import parse_duration
from ..utils.quantity import Quantity
from . import pattern as leaf_pattern


def evaluate(ctx, condition: dict) -> bool:
    """Evaluate one condition {key, operator, value}
    (reference: pkg/engine/variables/evaluate.go:11)."""
    op = str(condition.get('operator', ''))
    key = condition.get('key')
    value = condition.get('value')
    handler = _HANDLERS.get(op.lower())
    if handler is None:
        return False
    return handler(key, value)


def evaluate_conditions(ctx, conditions: Any) -> bool:
    """Evaluate any/all condition blocks, supporting both the new
    AnyAllConditions form and the legacy list-of-conditions form
    (reference: pkg/engine/variables/evaluate.go:21)."""
    if conditions is None:
        # nil conditions transform to an empty AnyAllConditions block which
        # evaluates vacuously true (reference: pkg/utils/conditions.go
        # TransformConditions + evaluate.go:42) — deny: {} always denies
        return True
    if isinstance(conditions, dict):
        return _evaluate_any_all(ctx, conditions)
    if isinstance(conditions, list):
        if all(isinstance(c, dict) and ('any' in c or 'all' in c)
               for c in conditions) and conditions:
            return all(_evaluate_any_all(ctx, c) for c in conditions)
        return all(evaluate(ctx, c) for c in conditions)
    return False


def evaluate_any_all_list(ctx, conditions: List[dict]) -> bool:
    return all(_evaluate_any_all(ctx, c) for c in conditions)


def _evaluate_any_all(ctx, conditions: dict) -> bool:
    any_conditions = conditions.get('any')
    all_conditions = conditions.get('all')
    any_result, all_result = True, True
    if any_conditions is not None:
        any_result = any(evaluate(ctx, c) for c in any_conditions)
    if all_conditions:
        all_result = all(evaluate(ctx, c) for c in all_conditions)
    return any_result and all_result


# ---------------------------------------------------------------------------
# helpers

def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _sprint(v: Any) -> str:
    """Go fmt.Sprint for scalars."""
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, float):
        if v == int(v) and abs(v) < 1e21:
            return str(int(v))
        return repr(v)
    return str(v)


def _try_duration(v: Any) -> Optional[int]:
    """Parse a duration if the value is a duration string and not '0'
    (reference: pkg/engine/variables/operator/operator.go:80 parseDuration)."""
    if isinstance(v, str) and v != '0':
        try:
            return parse_duration(v)
        except ValueError:
            return None
    return None


def _duration_pair(key: Any, value: Any) -> Optional[Tuple[float, float]]:
    kd = _try_duration(key)
    vd = _try_duration(value)
    if kd is None and vd is None:
        return None
    if kd is None:
        if _is_num(key):
            kd = int(key * 1e9)
        else:
            return None
    if vd is None:
        if _is_num(value):
            vd = int(value * 1e9)
        else:
            return None
    return kd / 1e9, vd / 1e9


def _try_quantity(v: Any) -> Optional[Quantity]:
    if isinstance(v, str):
        try:
            return Quantity.parse(v)
        except ValueError:
            return None
    return None


# ---------------------------------------------------------------------------
# Equals / NotEquals

def _equal(key: Any, value: Any) -> bool:
    # reference: pkg/engine/variables/operator/equal.go
    if isinstance(key, bool):
        return isinstance(value, bool) and key == value
    if isinstance(key, int) and not isinstance(key, bool):
        return _equal_int(key, value)
    if isinstance(key, float):
        return _equal_float(key, value)
    if isinstance(key, str):
        return _equal_string(key, value)
    if isinstance(key, dict):
        return isinstance(value, dict) and key == value
    if isinstance(key, list):
        return isinstance(value, list) and key == value
    return False


def _equal_int(key: int, value: Any) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, int):
        return key == value
    if isinstance(value, float):
        return value == math.trunc(value) and int(value) == key
    if isinstance(value, str):
        try:
            return float(value) == float(key)
        except ValueError:
            return False
    return False


def _equal_float(key: float, value: Any) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, int):
        return key == math.trunc(key) and int(key) == value
    if isinstance(value, float):
        return key == value
    if isinstance(value, str):
        try:
            return float(value) == key
        except ValueError:
            return False
    return False


def _equal_string(key: str, value: Any) -> bool:
    pair = _duration_pair(key, value)
    if pair is not None:
        return pair[0] == pair[1]
    kq = _try_quantity(key)
    if kq is not None and isinstance(value, str):
        vq = _try_quantity(value)
        if vq is None:
            return False
        return kq.cmp(vq) == 0
    if isinstance(value, str):
        return wildcard.match(value, key)
    return False


def _not_equal(key: Any, value: Any) -> bool:
    return not _equal(key, value)


# ---------------------------------------------------------------------------
# In family

def _string_slice(key: list, strict: bool) -> Optional[List[str]]:
    out = []
    for v in key:
        if strict and not isinstance(v, str):
            return None
        out.append(v if isinstance(v, str) else _sprint(v))
    return out


def _value_as_string_list(value: str) -> Optional[List[str]]:
    """A string value may itself be a JSON array of strings."""
    try:
        arr = json.loads(value)
    except ValueError:
        return None
    if isinstance(arr, list) and all(isinstance(x, str) for x in arr):
        return arr
    return None


def _key_in_array(key: str, value: Any, wildcard_both: bool = True,
                  allow_range: bool = False) -> Optional[bool]:
    """Shared 'does key exist in value' logic; None means invalid type."""
    if isinstance(value, list):
        for val in value:
            vs = _sprint(val) if not isinstance(val, str) else val
            if wildcard.match(vs, key) or (wildcard_both and wildcard.match(key, vs)):
                return True
        return False
    if isinstance(value, str):
        if wildcard.match(value, key):
            return True
        if allow_range and leaf_pattern.get_operator_from_string_pattern(value) == leaf_pattern.OP_IN_RANGE:
            return leaf_pattern.validate(key, value)
        arr = _value_as_string_list(value)
        if arr is None:
            if allow_range:
                arr = [value]
            else:
                return None
        return key in arr
    return None


def _in(key: Any, value: Any) -> bool:
    # deprecated In (reference: operator/in.go)
    if isinstance(key, str):
        return bool(_key_in_array(key, value))
    if _is_num(key):
        return bool(_key_in_array(_sprint(key), value))
    if isinstance(key, list):
        keys = _string_slice(key, strict=True)
        if keys is None:
            return False
        return _set_in(keys, value, negate=False)
    return False


def _set_in(keys: List[str], value: Any, negate: bool) -> bool:
    # reference: operator/in.go:106 setExistsInArray
    if isinstance(value, list):
        vals = []
        for v in value:
            if not isinstance(v, str):
                return False
            vals.append(v)
        vals_set = set(vals)
        missing_any = any(k not in vals_set for k in keys)
        return missing_any if negate else not missing_any
    if isinstance(value, str):
        if len(keys) == 1 and keys[0] == value:
            return not negate
        arr = _value_as_string_list(value)
        if arr is None:
            return False
        arr_set = set(arr)
        if negate:
            return any(k not in arr_set for k in keys)
        return all(k in arr_set for k in keys)
    return False


def _not_in(key: Any, value: Any) -> bool:
    if isinstance(key, str):
        r = _key_in_array(key, value)
        return (not r) if r is not None else False
    if _is_num(key):
        r = _key_in_array(_sprint(key), value)
        return (not r) if r is not None else False
    if isinstance(key, list):
        keys = _string_slice(key, strict=True)
        if keys is None:
            return False
        return _set_in(keys, value, negate=True)
    return False


def _any_in(key: Any, value: Any) -> bool:
    # reference: operator/anyin.go
    if isinstance(key, str) or _is_num(key):
        k = key if isinstance(key, str) else _sprint(key)
        r = _key_in_array(k, value, allow_range=True)
        return bool(r)
    if isinstance(key, list):
        keys = _string_slice(key, strict=False)
        return _any_set_in(keys, value, negate=False)
    return False


def _any_not_in(key: Any, value: Any) -> bool:
    if isinstance(key, str) or _is_num(key):
        k = key if isinstance(key, str) else _sprint(key)
        r = _key_in_array(k, value, allow_range=True)
        return (not r) if r is not None else False
    if isinstance(key, list):
        keys = _string_slice(key, strict=False)
        return _any_set_in(keys, value, negate=True)
    return False


def _k_in_wild(k: str, vals: List[str]) -> bool:
    """Bidirectional wildcard membership (reference: anyin.go:190 isAnyIn
    inner loop — wildcard.Match(key, val) || wildcard.Match(val, key))."""
    return any(wildcard.match(k, v) or wildcard.match(v, k) for v in vals)


def _any_set_in(keys: List[str], value: Any, negate: bool) -> bool:
    # reference: operator/anyin.go:124 anySetExistsInArray
    if isinstance(value, list):
        vals = [v if isinstance(v, str) else _sprint(v) for v in value]
        if negate:
            return any(not _k_in_wild(k, vals) for k in keys)
        return any(_k_in_wild(k, vals) for k in keys)
    if isinstance(value, str):
        if len(keys) == 1 and keys[0] == value:
            return not negate
        if leaf_pattern.get_operator_from_string_pattern(value) == leaf_pattern.OP_IN_RANGE:
            if negate:
                not_range = value.replace('-', '!-', 1)
                return any(leaf_pattern.validate(k, not_range) for k in keys)
            return any(leaf_pattern.validate(k, value) for k in keys)
        arr = _value_as_string_list(value)
        if arr is None:
            arr = [value]
        # reference parses the JSON/string form then runs the same
        # isAnyIn/isAnyNotIn wildcard membership (anyin.go:168-183)
        if negate:
            return any(not _k_in_wild(k, arr) for k in keys)
        return any(_k_in_wild(k, arr) for k in keys)
    return False


def _all_in(key: Any, value: Any) -> bool:
    # reference: operator/allin.go
    if isinstance(key, str) or _is_num(key):
        k = key if isinstance(key, str) else _sprint(key)
        r = _key_in_array(k, value, allow_range=True)
        return bool(r)
    if isinstance(key, list):
        keys = _string_slice(key, strict=False)
        return _all_set_in(keys, value, negate=False)
    return False


def _all_not_in(key: Any, value: Any) -> bool:
    if isinstance(key, str) or _is_num(key):
        k = key if isinstance(key, str) else _sprint(key)
        r = _key_in_array(k, value, allow_range=True)
        return (not r) if r is not None else False
    if isinstance(key, list):
        keys = _string_slice(key, strict=False)
        return _all_set_in(keys, value, negate=True)
    return False


def _all_set_in(keys: List[str], value: Any, negate: bool) -> bool:
    # reference: operator/allin.go:112 allSetExistsInArray.  AllNotIn is
    # universal (allin.go:192 isAllNotIn): false if ANY key element
    # matches any value element.
    if isinstance(value, list):
        vals = [v if isinstance(v, str) else _sprint(v) for v in value]
        if negate:
            return all(not _k_in_wild(k, vals) for k in keys)
        return all(_k_in_wild(k, vals) for k in keys)
    if isinstance(value, str):
        if len(keys) == 1 and keys[0] == value:
            return not negate
        if leaf_pattern.get_operator_from_string_pattern(value) == leaf_pattern.OP_IN_RANGE:
            if negate:
                return all(not leaf_pattern.validate(k, value) for k in keys)
            return all(leaf_pattern.validate(k, value) for k in keys)
        arr = _value_as_string_list(value)
        if arr is None:
            arr = [value]
        # same isAllIn/isAllNotIn wildcard membership as the list form
        # (allin.go:137-139,168-170)
        if negate:
            return all(not _k_in_wild(k, arr) for k in keys)
        return all(_k_in_wild(k, arr) for k in keys)
    return False


# ---------------------------------------------------------------------------
# Numeric comparison

def _cmp(op: str, a: float, b: float) -> bool:
    if op == 'greaterthanorequals':
        return a >= b
    if op == 'greaterthan':
        return a > b
    if op == 'lessthanorequals':
        return a <= b
    if op == 'lessthan':
        return a < b
    return False


def _numeric(op: str):
    def handler(key: Any, value: Any) -> bool:
        # reference: operator/numeric.go
        if _is_num(key):
            return _numeric_num_key(op, float(key), value)
        if isinstance(key, str):
            pair = _duration_pair(key, value)
            if pair is not None:
                return _cmp(op, pair[0], pair[1])
            kq = _try_quantity(key)
            vq = _try_quantity(value) if isinstance(value, str) else None
            if kq is not None and vq is not None:
                return _cmp(op, float(kq.cmp(vq)), 0.0)
            try:
                return _numeric_num_key(op, float(key), value)
            except (ValueError, TypeError):
                pass
            sv = _try_semver(key)
            if sv is not None and isinstance(value, str):
                vv = _try_semver(value)
                if vv is None:
                    return False
                from .jmespath.custom import _semver_cmp
                return _cmp(op, float(_semver_cmp(sv, vv)), 0.0)
            return False
        return False
    return handler


def _numeric_num_key(op: str, key: float, value: Any) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, (int, float)):
        return _cmp(op, key, float(value))
    if isinstance(value, str):
        pair = _duration_pair(key, value)
        if pair is not None:
            return _cmp(op, pair[0], pair[1])
        try:
            return _cmp(op, key, float(value))
        except ValueError:
            return False
    return False


def _try_semver(v: str):
    from .jmespath.custom import _SEMVER_RE, _parse_semver
    if _SEMVER_RE.match(v.strip()):
        try:
            return _parse_semver(v)
        except Exception:
            return None
    return None


# ---------------------------------------------------------------------------
# Duration operators (deprecated)

def _duration(op: str):
    core = {'durationgreaterthanorequals': 'greaterthanorequals',
            'durationgreaterthan': 'greaterthan',
            'durationlessthanorequals': 'lessthanorequals',
            'durationlessthan': 'lessthan'}[op]

    def handler(key: Any, value: Any) -> bool:
        # reference: operator/duration.go — ints are seconds
        def to_seconds(v: Any) -> Optional[float]:
            if isinstance(v, bool):
                return None
            if isinstance(v, (int, float)):
                return float(v)
            if isinstance(v, str):
                try:
                    return parse_duration(v) / 1e9
                except ValueError:
                    return None
            return None
        ks, vs = to_seconds(key), to_seconds(value)
        if ks is None or vs is None:
            return False
        return _cmp(core, ks, vs)
    return handler


_HANDLERS = {
    'equal': _equal,
    'equals': _equal,
    'notequal': _not_equal,
    'notequals': _not_equal,
    'in': _in,
    'anyin': _any_in,
    'allin': _all_in,
    'notin': _not_in,
    'anynotin': _any_not_in,
    'allnotin': _all_not_in,
    'greaterthanorequals': _numeric('greaterthanorequals'),
    'greaterthan': _numeric('greaterthan'),
    'lessthanorequals': _numeric('lessthanorequals'),
    'lessthan': _numeric('lessthan'),
    'durationgreaterthanorequals': _duration('durationgreaterthanorequals'),
    'durationgreaterthan': _duration('durationgreaterthan'),
    'durationlessthanorequals': _duration('durationlessthanorequals'),
    'durationlessthan': _duration('durationlessthan'),
}
