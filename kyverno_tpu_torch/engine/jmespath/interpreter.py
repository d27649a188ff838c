"""JMESPath tree interpreter and built-in (spec) functions.

Semantics follow the JMESPath specification; behavioral quirks follow
go-jmespath where they differ, since that is what the reference engine uses
(reference: pkg/engine/jmespath/new.go).
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable, Dict, List, Optional

from .errors import (ArityError, FunctionError, JMESPathTypeError,
                     UnknownFunctionError)


class _NotFound:
    """Sentinel distinguishing a missing field from an explicit null.

    The reference's jmespath dependency is the kyverno/go-jmespath fork
    (reference: go.mod:342) whose Search returns NotFoundError when the
    expression resolves to a missing field — engine code branches on it
    (e.g. pkg/engine/variables/vars.go:395). The sentinel propagates
    through the tree like null and is converted to NotFoundError at the
    public search() boundary.
    """

    __slots__ = ()

    def __repr__(self):
        return '<not-found>'

    def __bool__(self):
        return False


NOT_FOUND = _NotFound()


def _defined(value: Any) -> Any:
    """Normalize NOT_FOUND to None for contexts that treat both as null."""
    return None if value is NOT_FOUND else value


def is_false(value: Any) -> bool:
    """JMESPath falsiness: null, empty string/array/object, and false."""
    value = _defined(value)
    return (value is None or value is False or value == '' or
            (isinstance(value, (list, dict)) and len(value) == 0))


def is_truthy(value: Any) -> bool:
    return not is_false(value)


def jp_type(value: Any) -> str:
    if value is None:
        return 'null'
    if isinstance(value, bool):
        return 'boolean'
    if isinstance(value, str):
        return 'string'
    if isinstance(value, (int, float)):
        return 'number'
    if isinstance(value, list):
        return 'array'
    if isinstance(value, dict):
        return 'object'
    if isinstance(value, ExprRef):
        return 'expref'
    return 'unknown'


def deep_equal(a: Any, b: Any) -> bool:
    """Deep equality that, unlike Python ==, distinguishes bools from numbers."""
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return False
        return all(deep_equal(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(deep_equal(x, y) for x, y in zip(a, b))
    return a == b


class ExprRef:
    """A reference to an unevaluated expression (&expr)."""

    __slots__ = ('node', 'interpreter')

    def __init__(self, node: Dict, interpreter: 'TreeInterpreter'):
        self.node = node
        self.interpreter = interpreter

    def visit(self, value: Any) -> Any:
        return _defined(self.interpreter.visit(self.node, value))


class FunctionRegistry:
    """Holds function signatures + handlers; shared by builtins and the
    Kyverno custom set (reference: pkg/engine/jmespath/functions.go:118)."""

    def __init__(self):
        self._functions: Dict[str, Dict] = {}

    def register(self, name: str, signature: List[Dict],
                 handler: Callable, variadic: bool = False):
        self._functions[name] = {
            'signature': signature,
            'handler': handler,
            'variadic': variadic,
        }

    def names(self) -> List[str]:
        return sorted(self._functions)

    def call(self, interpreter: 'TreeInterpreter', name: str,
             args: List[Any]) -> Any:
        entry = self._functions.get(name)
        if entry is None:
            raise UnknownFunctionError(f'unknown function: {name}()')
        sig = entry['signature']
        if entry['variadic']:
            if len(args) < len(sig):
                raise ArityError(
                    f'{name}() takes at least {len(sig)} arguments, '
                    f'got {len(args)}')
            specs = sig + [sig[-1]] * (len(args) - len(sig))
        else:
            if len(args) != len(sig):
                raise ArityError(
                    f'{name}() takes {len(sig)} arguments, got {len(args)}')
            specs = sig
        for i, (spec, arg) in enumerate(zip(specs, args)):
            types = spec.get('types')
            if not types or 'any' in types:
                continue
            if not _type_matches(arg, types):
                raise JMESPathTypeError(name, arg, jp_type(arg), types)
        return entry['handler'](interpreter, args)


def _type_matches(arg: Any, types: List[str]) -> bool:
    t = jp_type(arg)
    for expected in types:
        if expected == t:
            return True
        if expected == 'array-string' and t == 'array' and \
                all(isinstance(x, str) for x in arg):
            return True
        if expected == 'array-number' and t == 'array' and \
                all(isinstance(x, (int, float)) and not isinstance(x, bool)
                    for x in arg):
            return True
    return False


class TreeInterpreter:
    COMPARATOR_FUNC = {
        'eq': lambda a, b: deep_equal(a, b),
        'ne': lambda a, b: not deep_equal(a, b),
    }

    def __init__(self, functions: FunctionRegistry):
        self.functions = functions

    def visit(self, node: Dict, value: Any) -> Any:
        method = getattr(self, '_visit_' + node['type'])
        return method(node, value)

    # -- leaf nodes ----------------------------------------------------------

    def _visit_literal(self, node, value):
        return node['value']

    def _visit_identity(self, node, value):
        return value

    def _visit_current(self, node, value):
        return value

    def _visit_field(self, node, value):
        if isinstance(value, dict):
            return value.get(node['value'], NOT_FOUND)
        return NOT_FOUND if value is NOT_FOUND else None

    # -- structural ----------------------------------------------------------

    def _visit_subexpression(self, node, value):
        result = value
        for child in node['children']:
            result = self.visit(child, result)
        return result

    def _visit_index(self, node, value):
        if not isinstance(value, list):
            return NOT_FOUND if value is NOT_FOUND else None
        idx = node['value']
        try:
            return value[idx]
        except IndexError:
            return None

    def _visit_slice(self, node, value):
        if not isinstance(value, list):
            return NOT_FOUND if value is NOT_FOUND else None
        start, stop, step = node['value']
        if step == 0:
            raise FunctionError('slice step cannot be 0')
        return value[slice(start, stop, step)]

    def _visit_index_expression(self, node, value):
        result = value
        for child in node['children']:
            result = self.visit(child, result)
        return result

    def _visit_projection(self, node, value):
        base = self.visit(node['children'][0], value)
        if not isinstance(base, list):
            return NOT_FOUND if base is NOT_FOUND else None
        collected = []
        for element in base:
            current = _defined(self.visit(node['children'][1], element))
            if current is not None:
                collected.append(current)
        return collected

    def _visit_value_projection(self, node, value):
        base = self.visit(node['children'][0], value)
        if not isinstance(base, dict):
            return NOT_FOUND if base is NOT_FOUND else None
        collected = []
        for element in base.values():
            current = _defined(self.visit(node['children'][1], element))
            if current is not None:
                collected.append(current)
        return collected

    def _visit_flatten(self, node, value):
        base = self.visit(node['children'][0], value)
        if not isinstance(base, list):
            return NOT_FOUND if base is NOT_FOUND else None
        merged = []
        for element in base:
            if isinstance(element, list):
                merged.extend(element)
            else:
                merged.append(element)
        return merged

    def _visit_filter_projection(self, node, value):
        base = self.visit(node['children'][0], value)
        if not isinstance(base, list):
            return NOT_FOUND if base is NOT_FOUND else None
        comparator = node['children'][2]
        collected = []
        for element in base:
            if is_truthy(self.visit(comparator, element)):
                current = _defined(self.visit(node['children'][1], element))
                if current is not None:
                    collected.append(current)
        return collected

    # -- operators -----------------------------------------------------------

    def _visit_comparator(self, node, value):
        op = node['value']
        left = _defined(self.visit(node['children'][0], value))
        right = _defined(self.visit(node['children'][1], value))
        if op in self.COMPARATOR_FUNC:
            return self.COMPARATOR_FUNC[op](left, right)
        # ordering operators are only valid for numbers
        if not _is_number(left) or not _is_number(right):
            return None
        if op == 'lt':
            return left < right
        if op == 'gt':
            return left > right
        if op == 'lte':
            return left <= right
        if op == 'gte':
            return left >= right
        raise FunctionError(f'unknown comparator {op}')

    def _visit_or_expression(self, node, value):
        matched = self.visit(node['children'][0], value)
        if is_false(matched):
            matched = self.visit(node['children'][1], value)
        return matched

    def _visit_and_expression(self, node, value):
        matched = self.visit(node['children'][0], value)
        if is_false(matched):
            return matched
        return self.visit(node['children'][1], value)

    def _visit_not_expression(self, node, value):
        return is_false(self.visit(node['children'][0], value))

    def _visit_pipe(self, node, value):
        result = self.visit(node['children'][0], value)
        return self.visit(node['children'][1], result)

    # -- multiselect ---------------------------------------------------------

    def _visit_multi_select_list(self, node, value):
        if _defined(value) is None:
            return None
        return [_defined(self.visit(child, value))
                for child in node['children']]

    def _visit_multi_select_dict(self, node, value):
        if _defined(value) is None:
            return None
        return {child['value']: _defined(self.visit(child['children'][0], value))
                for child in node['children']}

    # -- functions -----------------------------------------------------------

    def _visit_function_expression(self, node, value):
        args = [_defined(self.visit(child, value))
                for child in node['children']]
        return self.functions.call(self, node['value'], args)

    def _visit_expref(self, node, value):
        return ExprRef(node['children'][0], self)


def _is_number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


# ---------------------------------------------------------------------------
# Spec built-in functions
# ---------------------------------------------------------------------------

def _require_number_array(name, arr):
    for x in arr:
        if not _is_number(x):
            raise JMESPathTypeError(name, x, jp_type(x), ['number'])


def _fn_abs(ip, args):
    return abs(args[0])


def _fn_avg(ip, args):
    arr = args[0]
    _require_number_array('avg', arr)
    if not arr:
        return None
    return sum(arr) / len(arr)


def _fn_ceil(ip, args):
    return int(math.ceil(args[0]))


def _fn_floor(ip, args):
    return int(math.floor(args[0]))


def _fn_contains(ip, args):
    subject, search = args
    if isinstance(subject, str):
        if not isinstance(search, str):
            return False
        return search in subject
    return any(deep_equal(x, search) for x in subject)


def _fn_ends_with(ip, args):
    return args[0].endswith(args[1])


def _fn_starts_with(ip, args):
    return args[0].startswith(args[1])


def _fn_join(ip, args):
    return args[0].join(args[1])


def _fn_keys(ip, args):
    return list(args[0].keys())


def _fn_values(ip, args):
    return list(args[0].values())


def _fn_length(ip, args):
    return len(args[0])


def _fn_map(ip, args):
    expref, arr = args
    return [expref.visit(x) for x in arr]


def _fn_max(ip, args):
    arr = args[0]
    if not arr:
        return None
    _require_uniform_sortable('max', arr)
    return max(arr)


def _fn_min(ip, args):
    arr = args[0]
    if not arr:
        return None
    _require_uniform_sortable('min', arr)
    return min(arr)


def _require_uniform_sortable(name, arr):
    if all(isinstance(x, str) for x in arr):
        return
    if all(_is_number(x) for x in arr):
        return
    raise JMESPathTypeError(name, arr, 'array',
                            ['array-number', 'array-string'])


def _sort_keys(name, expref, arr):
    """Evaluate sort keys for every element, requiring a uniform
    all-string or all-number key set (like go-jmespath)."""
    keys = []
    for element in arr:
        result = expref.visit(element)
        if not (isinstance(result, str) or _is_number(result)):
            raise JMESPathTypeError(name, result, jp_type(result),
                                    ['number', 'string'])
        keys.append(result)
    if not (all(isinstance(k, str) for k in keys) or
            all(_is_number(k) for k in keys)):
        raise JMESPathTypeError(name, keys, 'array',
                                ['array-number', 'array-string'])
    return keys


def _fn_max_by(ip, args):
    arr, expref = args
    if not arr:
        return None
    keys = _sort_keys('max_by', expref, arr)
    return arr[max(range(len(arr)), key=lambda i: keys[i])]


def _fn_min_by(ip, args):
    arr, expref = args
    if not arr:
        return None
    keys = _sort_keys('min_by', expref, arr)
    return arr[min(range(len(arr)), key=lambda i: keys[i])]


def _fn_sort(ip, args):
    arr = args[0]
    _require_uniform_sortable('sort', arr)
    return sorted(arr)


def _fn_sort_by(ip, args):
    arr, expref = args
    if not arr:
        return list(arr)
    keys = _sort_keys('sort_by', expref, arr)
    order = sorted(range(len(arr)), key=lambda i: keys[i])
    return [arr[i] for i in order]


def _fn_merge(ip, args):
    merged = {}
    for obj in args:
        merged.update(obj)
    return merged


def _fn_not_null(ip, args):
    for arg in args:
        if arg is not None:
            return arg
    return None


def _fn_reverse(ip, args):
    v = args[0]
    if isinstance(v, str):
        return v[::-1]
    return list(reversed(v))


def _fn_sum(ip, args):
    arr = args[0]
    _require_number_array('sum', arr)
    return sum(arr)


def _fn_to_array(ip, args):
    v = args[0]
    if isinstance(v, list):
        return v
    return [v]


def _fn_to_string(ip, args):
    v = args[0]
    if isinstance(v, str):
        return v
    return json.dumps(v, separators=(',', ':'), ensure_ascii=False)


def _fn_to_number(ip, args):
    v = args[0]
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return v
    if isinstance(v, str):
        try:
            if '.' in v or 'e' in v or 'E' in v:
                return float(v)
            return int(v)
        except ValueError:
            return None
    return None


def _fn_type(ip, args):
    return jp_type(args[0])


def make_builtin_registry() -> FunctionRegistry:
    r = FunctionRegistry()
    S = lambda *types: {'types': list(types)}  # noqa: E731
    r.register('abs', [S('number')], _fn_abs)
    r.register('avg', [S('array')], _fn_avg)
    r.register('ceil', [S('number')], _fn_ceil)
    r.register('contains', [S('array', 'string'), S('any')], _fn_contains)
    r.register('ends_with', [S('string'), S('string')], _fn_ends_with)
    r.register('floor', [S('number')], _fn_floor)
    r.register('join', [S('string'), S('array-string')], _fn_join)
    r.register('keys', [S('object')], _fn_keys)
    r.register('length', [S('string', 'array', 'object')], _fn_length)
    r.register('map', [S('expref'), S('array')], _fn_map)
    r.register('max', [S('array')], _fn_max)
    r.register('max_by', [S('array'), S('expref')], _fn_max_by)
    r.register('merge', [S('object')], _fn_merge, variadic=True)
    r.register('min', [S('array')], _fn_min)
    r.register('min_by', [S('array'), S('expref')], _fn_min_by)
    r.register('not_null', [S('any')], _fn_not_null, variadic=True)
    r.register('reverse', [S('string', 'array')], _fn_reverse)
    r.register('sort', [S('array')], _fn_sort)
    r.register('sort_by', [S('array'), S('expref')], _fn_sort_by)
    r.register('starts_with', [S('string'), S('string')], _fn_starts_with)
    r.register('sum', [S('array')], _fn_sum)
    r.register('to_array', [S('any')], _fn_to_array)
    r.register('to_number', [S('any')], _fn_to_number)
    r.register('to_string', [S('any')], _fn_to_string)
    r.register('type', [S('any')], _fn_type)
    r.register('values', [S('object')], _fn_values)
    return r
