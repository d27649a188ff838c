"""JMESPath Pratt parser producing a dict-based AST.

AST node shape: ``{'type': <str>, 'children': [<node>...], 'value': <any>}``.
Node types: field, subexpression, index, slice, index_expression, projection,
value_projection, flatten, filter_projection, comparator, or_expression,
and_expression, not_expression, pipe, multi_select_list, multi_select_dict,
key_val_pair, function_expression, expref, literal, identity, current.
"""

from __future__ import annotations

from typing import Any, Dict, List

from .errors import IncompleteExpressionError, ParseError
from .lexer import tokenize

BINDING_POWER = {
    'eof': 0,
    'unquoted_identifier': 0,
    'quoted_identifier': 0,
    'literal': 0,
    'rbracket': 0,
    'rparen': 0,
    'comma': 0,
    'rbrace': 0,
    'number': 0,
    'current': 0,
    'expref': 0,
    'colon': 0,
    'pipe': 1,
    'or': 2,
    'and': 3,
    'eq': 5,
    'gt': 5,
    'lt': 5,
    'gte': 5,
    'lte': 5,
    'ne': 5,
    'flatten': 9,
    'star': 20,
    'filter': 21,
    'dot': 40,
    'not': 45,
    'lbrace': 50,
    'lbracket': 55,
    'lparen': 60,
}

_PROJECTION_STOP = 10
_COMPARATOR_TOKENS = ('eq', 'ne', 'lt', 'gt', 'lte', 'gte')


def _node(type_: str, children: List = None, value: Any = None) -> Dict:
    return {'type': type_, 'children': children or [], 'value': value}


class Parser:
    def __init__(self, expression: str):
        self.expression = expression
        self.tokens = list(tokenize(expression))
        self.index = 0

    # -- token stream helpers -------------------------------------------------

    @property
    def current(self):
        return self.tokens[self.index]

    def advance(self):
        self.index += 1

    def expect(self, token_type: str):
        tok = self.current
        if tok.type != token_type:
            if tok.type == 'eof':
                raise IncompleteExpressionError(tok.start, tok.value, tok.type)
            raise ParseError(tok.start, tok.value, tok.type,
                             f'expected {token_type}')
        self.advance()
        return tok

    # -- entry ---------------------------------------------------------------

    def parse(self) -> Dict:
        parsed = self._expression(0)
        if self.current.type != 'eof':
            tok = self.current
            raise ParseError(tok.start, tok.value, tok.type,
                             'unexpected token after expression')
        return parsed

    def _expression(self, binding_power: int) -> Dict:
        left_token = self.current
        self.advance()
        left = self._nud(left_token)
        while binding_power < BINDING_POWER[self.current.type]:
            tok = self.current
            self.advance()
            left = self._led(tok, left)
        return left

    # -- prefix (nud) --------------------------------------------------------

    def _nud(self, token) -> Dict:
        t = token.type
        if t == 'literal':
            return _node('literal', value=token.value)
        if t == 'unquoted_identifier':
            return _node('field', value=token.value)
        if t == 'quoted_identifier':
            if self.current.type == 'lparen':
                raise ParseError(token.start, token.value, token.type,
                                 'quoted identifiers cannot be function names')
            return _node('field', value=token.value)
        if t == 'star':
            left = _node('identity')
            if self.current.type == 'rbracket':
                right = _node('identity')
            else:
                right = self._parse_projection_rhs(BINDING_POWER['star'])
            return _node('value_projection', [left, right])
        if t == 'filter':
            return self._parse_filter(_node('identity'))
        if t == 'lbrace':
            return self._parse_multi_select_hash()
        if t == 'lparen':
            expr = self._expression(0)
            self.expect('rparen')
            return expr
        if t == 'flatten':
            left = _node('flatten', [_node('identity')])
            right = self._parse_projection_rhs(BINDING_POWER['flatten'])
            return _node('projection', [left, right])
        if t == 'not':
            return _node('not_expression', [self._expression(BINDING_POWER['not'])])
        if t == 'lbracket':
            if self.current.type in ('number', 'colon'):
                right = self._parse_index_expression()
                return self._project_if_slice(_node('identity'), right)
            if self.current.type == 'star' and \
                    self.tokens[self.index + 1].type == 'rbracket':
                self.advance()
                self.advance()
                right = self._parse_projection_rhs(BINDING_POWER['star'])
                return _node('projection', [_node('identity'), right])
            return self._parse_multi_select_list()
        if t == 'current':
            return _node('current')
        if t == 'expref':
            return _node('expref', [self._expression(BINDING_POWER['expref'])])
        if t == 'eof':
            raise IncompleteExpressionError(token.start, token.value, token.type)
        raise ParseError(token.start, token.value, token.type)

    # -- infix (led) ---------------------------------------------------------

    def _led(self, token, left: Dict) -> Dict:
        t = token.type
        if t == 'dot':
            if self.current.type != 'star':
                right = self._parse_dot_rhs(BINDING_POWER['dot'])
                if left['type'] == 'subexpression':
                    left['children'].append(right)
                    return left
                return _node('subexpression', [left, right])
            # creates a value projection
            self.advance()
            right = self._parse_projection_rhs(BINDING_POWER['star'])
            return _node('value_projection', [left, right])
        if t == 'pipe':
            right = self._expression(BINDING_POWER['pipe'])
            return _node('pipe', [left, right])
        if t == 'or':
            right = self._expression(BINDING_POWER['or'])
            return _node('or_expression', [left, right])
        if t == 'and':
            right = self._expression(BINDING_POWER['and'])
            return _node('and_expression', [left, right])
        if t == 'lparen':
            if left['type'] != 'field':
                prev = self.tokens[self.index - 2]
                raise ParseError(prev.start, prev.value, prev.type,
                                 'invalid function name')
            name = left['value']
            args = []
            if self.current.type != 'rparen':
                args.append(self._expression(0))
                while self.current.type == 'comma':
                    self.advance()
                    args.append(self._expression(0))
            self.expect('rparen')
            return _node('function_expression', args, value=name)
        if t == 'filter':
            return self._parse_filter(left)
        if t in _COMPARATOR_TOKENS:
            right = self._expression(BINDING_POWER[t])
            return _node('comparator', [left, right], value=t)
        if t == 'flatten':
            new_left = _node('flatten', [left])
            right = self._parse_projection_rhs(BINDING_POWER['flatten'])
            return _node('projection', [new_left, right])
        if t == 'lbracket':
            if self.current.type in ('number', 'colon'):
                right = self._parse_index_expression()
                if left['type'] == 'index_expression' and right['type'] == 'index':
                    left['children'].append(right)
                    return left
                return self._project_if_slice(left, right)
            self.expect('star')
            self.expect('rbracket')
            right = self._parse_projection_rhs(BINDING_POWER['star'])
            return _node('projection', [left, right])
        raise ParseError(token.start, token.value, token.type)

    # -- helpers -------------------------------------------------------------

    def _parse_index_expression(self) -> Dict:
        # either a slice or an index
        if self.current.type == 'colon' or \
                self.tokens[self.index + 1].type == 'colon':
            return self._parse_slice_expression()
        node = _node('index', value=self.current.value)
        self.advance()
        self.expect('rbracket')
        return node

    def _parse_slice_expression(self) -> Dict:
        parts = [None, None, None]
        index = 0
        while self.current.type != 'rbracket' and index < 3:
            if self.current.type == 'colon':
                index += 1
                if index == 3:
                    tok = self.current
                    raise ParseError(tok.start, tok.value, tok.type,
                                     'too many colons in slice')
                self.advance()
            elif self.current.type == 'number':
                parts[index] = self.current.value
                self.advance()
            else:
                tok = self.current
                raise ParseError(tok.start, tok.value, tok.type,
                                 'invalid slice expression')
        self.expect('rbracket')
        return _node('slice', value=tuple(parts))

    def _project_if_slice(self, left: Dict, right: Dict) -> Dict:
        index_expr = _node('index_expression', [left, right])
        if right['type'] == 'slice':
            rhs = self._parse_projection_rhs(BINDING_POWER['star'])
            return _node('projection', [index_expr, rhs])
        return index_expr

    def _parse_filter(self, left: Dict) -> Dict:
        condition = self._expression(0)
        self.expect('rbracket')
        if self.current.type == 'flatten':
            right = _node('identity')
        else:
            right = self._parse_projection_rhs(BINDING_POWER['filter'])
        return _node('filter_projection', [left, right, condition])

    def _parse_multi_select_list(self) -> Dict:
        expressions = []
        while True:
            expressions.append(self._expression(0))
            if self.current.type == 'rbracket':
                break
            self.expect('comma')
        self.expect('rbracket')
        return _node('multi_select_list', expressions)

    def _parse_multi_select_hash(self) -> Dict:
        pairs = []
        while True:
            key_token = self.current
            if key_token.type not in ('quoted_identifier', 'unquoted_identifier'):
                raise ParseError(key_token.start, key_token.value,
                                 key_token.type, 'invalid key in multi-select hash')
            self.advance()
            self.expect('colon')
            value = self._expression(0)
            pairs.append(_node('key_val_pair', [value], value=key_token.value))
            if self.current.type == 'rbrace':
                break
            self.expect('comma')
        self.expect('rbrace')
        return _node('multi_select_dict', pairs)

    def _parse_projection_rhs(self, binding_power: int) -> Dict:
        t = self.current.type
        if BINDING_POWER[t] < _PROJECTION_STOP:
            return _node('identity')
        if t == 'lbracket':
            return self._expression(binding_power)
        if t == 'filter':
            return self._expression(binding_power)
        if t == 'dot':
            self.advance()
            return self._parse_dot_rhs(binding_power)
        tok = self.current
        raise ParseError(tok.start, tok.value, tok.type,
                         'invalid projection right-hand side')

    def _parse_dot_rhs(self, binding_power: int) -> Dict:
        t = self.current.type
        if t in ('unquoted_identifier', 'quoted_identifier', 'star'):
            return self._expression(binding_power)
        if t == 'lbracket':
            self.advance()
            return self._parse_multi_select_list()
        if t == 'lbrace':
            self.advance()
            return self._parse_multi_select_hash()
        tok = self.current
        raise ParseError(tok.start, tok.value, tok.type,
                         'invalid token after dot')


def parse(expression: str) -> Dict:
    return Parser(expression).parse()
