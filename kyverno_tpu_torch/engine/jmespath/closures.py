"""AST → closure compiler for the JMESPath interpreter.

The tree interpreter (interpreter.py TreeInterpreter) dispatches through
``getattr(self, '_visit_' + type)`` and re-reads ``node['children']`` on
every evaluation; batch encoding (compiler/encode.py) runs the same
small set of expressions over every resource, so that per-node overhead
dominates.  ``compile_closure`` lowers each AST node once into a nested
Python closure with the children/values bound in cell variables —
semantics are a line-for-line mirror of the corresponding ``_visit_*``
method, verified by the conformance corpus running through both paths.

Unknown node types raise ``UnsupportedNode`` at compile time; callers
fall back to the interpreter (closures are an optimization, never a
semantic fork).
"""

from __future__ import annotations

from typing import Any, Callable

from .errors import FunctionError
from .interpreter import (NOT_FOUND, ExprRef, _defined, deep_equal,
                          is_false, is_truthy)

_Fn = Callable[[Any], Any]


class UnsupportedNode(Exception):
    pass


def compile_closure(node: dict, interpreter) -> _Fn:
    """Compile ``node`` to a closure; ``interpreter`` supplies the
    function registry and is handed to ExprRefs (function arguments that
    are expression references evaluate through the interpreter)."""
    ctor = _COMPILERS.get(node['type'])
    if ctor is None:
        raise UnsupportedNode(node['type'])
    return ctor(node, interpreter)


def _children(node, interpreter):
    return [compile_closure(c, interpreter) for c in node['children']]


def _c_literal(node, interp):
    v = node['value']
    return lambda value: v


def _c_identity(node, interp):
    return lambda value: value


def _c_field(node, interp):
    k = node['value']

    def field(value):
        if isinstance(value, dict):
            return value.get(k, NOT_FOUND)
        return NOT_FOUND if value is NOT_FOUND else None
    return field


def _c_subexpression(node, interp):
    fns = _children(node, interp)
    if len(fns) == 2:
        a, b = fns
        return lambda value: b(a(value))

    def subexpr(value):
        for fn in fns:
            value = fn(value)
        return value
    return subexpr


def _c_index(node, interp):
    idx = node['value']

    def index(value):
        if not isinstance(value, list):
            return NOT_FOUND if value is NOT_FOUND else None
        try:
            return value[idx]
        except IndexError:
            return None
    return index


def _c_slice(node, interp):
    start, stop, step = node['value']

    def slc(value):
        if not isinstance(value, list):
            return NOT_FOUND if value is NOT_FOUND else None
        if step == 0:
            raise FunctionError('slice step cannot be 0')
        return value[slice(start, stop, step)]
    return slc


def _c_projection(node, interp):
    left, right = _children(node, interp)

    def projection(value):
        base = left(value)
        if not isinstance(base, list):
            return NOT_FOUND if base is NOT_FOUND else None
        collected = []
        for element in base:
            current = right(element)
            if current is NOT_FOUND:
                current = None
            if current is not None:
                collected.append(current)
        return collected
    return projection


def _c_value_projection(node, interp):
    left, right = _children(node, interp)

    def vprojection(value):
        base = left(value)
        if not isinstance(base, dict):
            return NOT_FOUND if base is NOT_FOUND else None
        collected = []
        for element in base.values():
            current = right(element)
            if current is NOT_FOUND:
                current = None
            if current is not None:
                collected.append(current)
        return collected
    return vprojection


def _c_flatten(node, interp):
    [inner] = _children(node, interp)

    def flatten(value):
        base = inner(value)
        if not isinstance(base, list):
            return NOT_FOUND if base is NOT_FOUND else None
        merged = []
        for element in base:
            if isinstance(element, list):
                merged.extend(element)
            else:
                merged.append(element)
        return merged
    return flatten


def _c_filter_projection(node, interp):
    left, right, comparator = _children(node, interp)

    def fprojection(value):
        base = left(value)
        if not isinstance(base, list):
            return NOT_FOUND if base is NOT_FOUND else None
        collected = []
        for element in base:
            if is_truthy(comparator(element)):
                current = right(element)
                if current is NOT_FOUND:
                    current = None
                if current is not None:
                    collected.append(current)
        return collected
    return fprojection


def _c_comparator(node, interp):
    op = node['value']
    left, right = _children(node, interp)
    if op == 'eq':
        return lambda value: deep_equal(_defined(left(value)),
                                        _defined(right(value)))
    if op == 'ne':
        return lambda value: not deep_equal(_defined(left(value)),
                                            _defined(right(value)))
    import operator
    cmp = {'lt': operator.lt, 'gt': operator.gt,
           'lte': operator.le, 'gte': operator.ge}.get(op)
    if cmp is None:
        raise UnsupportedNode(f'comparator {op}')

    def ordering(value):
        a = _defined(left(value))
        b = _defined(right(value))
        if not _is_number(a) or not _is_number(b):
            return None
        return cmp(a, b)
    return ordering


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _c_or_expression(node, interp):
    left, right = _children(node, interp)

    def or_expr(value):
        matched = left(value)
        if is_false(matched):
            matched = right(value)
        return matched
    return or_expr


def _c_and_expression(node, interp):
    left, right = _children(node, interp)

    def and_expr(value):
        matched = left(value)
        if is_false(matched):
            return matched
        return right(value)
    return and_expr


def _c_not_expression(node, interp):
    [inner] = _children(node, interp)
    return lambda value: is_false(inner(value))


def _c_pipe(node, interp):
    left, right = _children(node, interp)
    return lambda value: right(left(value))


def _c_multi_select_list(node, interp):
    fns = _children(node, interp)

    def msl(value):
        if _defined(value) is None:
            return None
        return [_defined(fn(value)) for fn in fns]
    return msl


def _c_multi_select_dict(node, interp):
    pairs = [(child['value'],
              compile_closure(child['children'][0], interp))
             for child in node['children']]

    def msd(value):
        if _defined(value) is None:
            return None
        return {k: _defined(fn(value)) for k, fn in pairs}
    return msd


def _c_function_expression(node, interp):
    name = node['value']
    fns = _children(node, interp)
    functions = interp.functions

    def call(value):
        return functions.call(interp, name, [_defined(fn(value))
                                             for fn in fns])
    return call


def _c_expref(node, interp):
    child = node['children'][0]
    return lambda value: ExprRef(child, interp)


_COMPILERS = {
    'literal': _c_literal,
    'identity': _c_identity,
    'current': _c_identity,
    'field': _c_field,
    'subexpression': _c_subexpression,
    'index': _c_index,
    'slice': _c_slice,
    'index_expression': _c_subexpression,
    'projection': _c_projection,
    'value_projection': _c_value_projection,
    'flatten': _c_flatten,
    'filter_projection': _c_filter_projection,
    'comparator': _c_comparator,
    'or_expression': _c_or_expression,
    'and_expression': _c_and_expression,
    'not_expression': _c_not_expression,
    'pipe': _c_pipe,
    'multi_select_list': _c_multi_select_list,
    'multi_select_dict': _c_multi_select_dict,
    'function_expression': _c_function_expression,
    'expref': _c_expref,
}
