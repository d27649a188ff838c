"""JMESPath error types."""

from __future__ import annotations


class JMESPathError(ValueError):
    """Base error for all JMESPath failures."""


class LexerError(JMESPathError):
    def __init__(self, position: int, token: str, message: str):
        super().__init__(f'{message} (at position {position})')
        self.position = position
        self.token = token


class ParseError(JMESPathError):
    def __init__(self, position: int, token: object, token_type: str,
                 message: str = 'invalid token'):
        super().__init__(
            f'{message}: unexpected token {token!r} ({token_type}) at position {position}')
        self.position = position
        self.token = token
        self.token_type = token_type


class IncompleteExpressionError(ParseError):
    def __init__(self, position: int, token: object, token_type: str):
        super().__init__(position, token, token_type, 'incomplete expression')


class ArityError(JMESPathError):
    pass


class JMESPathTypeError(JMESPathError):
    def __init__(self, function_name, current_value, actual_type, expected_types):
        self.function_name = function_name
        self.current_value = current_value
        self.actual_type = actual_type
        self.expected_types = expected_types
        super().__init__(
            f'In function {function_name}(), invalid type for value: '
            f'{current_value!r}, expected one of: {expected_types}, '
            f'received: "{actual_type}"')


class UnknownFunctionError(JMESPathError):
    pass


class FunctionError(JMESPathError):
    """Raised by custom function implementations on bad input."""


class NotFoundError(JMESPathError):
    """The expression resolved to a missing field (kyverno/go-jmespath fork
    behavior — reference: go.mod:342, pkg/engine/variables/vars.go:395)."""

