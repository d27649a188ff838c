"""JMESPath engine: spec-conformant implementation + Kyverno custom functions.

Public API mirrors the usual jmespath module shape:

    from kyverno_tpu_torch.engine import jmespath as jp
    jp.search('a.b[0]', {'a': {'b': [1, 2]}})      # -> 1
    expr = jp.compile('items(@, `"k"`, `"v"`)')
    expr.search({'x': 1})

The reference delegates to github.com/jmespath/go-jmespath plus 41 custom
functions (reference: pkg/engine/jmespath/new.go:7); here the whole language
is implemented natively so policies can also be *compiled* (see
kyverno_tpu/compiler) rather than only interpreted.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any

from .custom import register_custom_functions
from .errors import (ArityError, FunctionError, IncompleteExpressionError,
                     JMESPathError, JMESPathTypeError, LexerError,
                     NotFoundError, ParseError, UnknownFunctionError)
from .interpreter import (NOT_FOUND, FunctionRegistry, TreeInterpreter,
                          make_builtin_registry)
from .parser import parse as parse_ast

__all__ = [
    'compile', 'search', 'parse_ast', 'JMESPathError', 'LexerError',
    'ParseError', 'IncompleteExpressionError', 'ArityError',
    'JMESPathTypeError', 'UnknownFunctionError', 'FunctionError',
    'NotFoundError',
]

_REGISTRY = register_custom_functions(make_builtin_registry())
_INTERPRETER = TreeInterpreter(_REGISTRY)


class CompiledExpression:
    __slots__ = ('expression', 'ast', '_fn')

    def __init__(self, expression: str, ast: dict):
        self.expression = expression
        self.ast = ast
        self._fn = None

    def search(self, data: Any) -> Any:
        fn = self._fn
        if fn is None:
            # lower to closures on first use (closures.py); unsupported
            # nodes fall back to the tree interpreter permanently
            from .closures import UnsupportedNode, compile_closure
            try:
                fn = compile_closure(self.ast, _INTERPRETER)
            except UnsupportedNode:
                fn = lambda value: _INTERPRETER.visit(self.ast, value)  # noqa: E731
            self._fn = fn
        result = fn(data)
        if result is NOT_FOUND:
            raise NotFoundError(f'Unknown key "{self.expression}" in path')
        return result


@lru_cache(maxsize=16384)
def compile(expression: str) -> CompiledExpression:  # noqa: A001
    return CompiledExpression(expression, parse_ast(expression))


def search(expression: str, data: Any) -> Any:
    return compile(expression).search(data)


def function_names():
    return _REGISTRY.names()
