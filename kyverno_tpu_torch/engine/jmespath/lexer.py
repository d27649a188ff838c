"""JMESPath lexer (spec-conformant, https://jmespath.org/specification.html).

Produces the token stream consumed by ``parser.py``.  Built from scratch for
this framework; the reference engine delegates to github.com/jmespath/go-jmespath
(reference: pkg/engine/jmespath/new.go:7).
"""

from __future__ import annotations

import json
import string
from typing import Iterator, NamedTuple

from .errors import LexerError


class Token(NamedTuple):
    type: str
    value: object
    start: int
    end: int


START_IDENT = set(string.ascii_letters + '_')
VALID_IDENT = set(string.ascii_letters + string.digits + '_')
DIGITS = set(string.digits)
WHITESPACE = set(' \t\n\r')

SIMPLE_TOKENS = {
    '.': 'dot',
    '*': 'star',
    ']': 'rbracket',
    ',': 'comma',
    ':': 'colon',
    '@': 'current',
    '(': 'lparen',
    ')': 'rparen',
    '{': 'lbrace',
    '}': 'rbrace',
}


def tokenize(expression: str) -> Iterator[Token]:
    if not expression:
        raise LexerError(0, '', 'empty expression')
    pos = 0
    chars = expression
    length = len(expression)
    while pos < length:
        ch = chars[pos]
        if ch in SIMPLE_TOKENS:
            yield Token(SIMPLE_TOKENS[ch], ch, pos, pos + 1)
            pos += 1
        elif ch in START_IDENT:
            start = pos
            pos += 1
            while pos < length and chars[pos] in VALID_IDENT:
                pos += 1
            yield Token('unquoted_identifier', chars[start:pos], start, pos)
        elif ch in WHITESPACE:
            pos += 1
        elif ch == '[':
            if pos + 1 < length and chars[pos + 1] == ']':
                yield Token('flatten', '[]', pos, pos + 2)
                pos += 2
            elif pos + 1 < length and chars[pos + 1] == '?':
                yield Token('filter', '[?', pos, pos + 2)
                pos += 2
            else:
                yield Token('lbracket', '[', pos, pos + 1)
                pos += 1
        elif ch == "'":
            start = pos
            pos += 1
            buf = []
            while pos < length and chars[pos] != "'":
                if chars[pos] == '\\' and pos + 1 < length and chars[pos + 1] in ("'", '\\'):
                    buf.append(chars[pos + 1])
                    pos += 2
                else:
                    buf.append(chars[pos])
                    pos += 1
            if pos >= length:
                raise LexerError(start, chars[start:], 'unclosed raw string')
            pos += 1
            yield Token('literal', ''.join(buf), start, pos)
        elif ch == '|':
            if pos + 1 < length and chars[pos + 1] == '|':
                yield Token('or', '||', pos, pos + 2)
                pos += 2
            else:
                yield Token('pipe', '|', pos, pos + 1)
                pos += 1
        elif ch == '&':
            if pos + 1 < length and chars[pos + 1] == '&':
                yield Token('and', '&&', pos, pos + 2)
                pos += 2
            else:
                yield Token('expref', '&', pos, pos + 1)
                pos += 1
        elif ch == '`':
            start = pos
            pos += 1
            buf = []
            while pos < length and chars[pos] != '`':
                if chars[pos] == '\\' and pos + 1 < length and chars[pos + 1] == '`':
                    buf.append('`')
                    pos += 2
                else:
                    buf.append(chars[pos])
                    pos += 1
            if pos >= length:
                raise LexerError(start, chars[start:], 'unclosed backtick literal')
            pos += 1
            raw = ''.join(buf)
            try:
                parsed = json.loads(raw)
            except ValueError:
                try:
                    # legacy: bare words inside backticks are strings
                    parsed = json.loads('"%s"' % raw.strip())
                except ValueError:
                    raise LexerError(start, raw, 'bad token %s' % raw) from None
            yield Token('literal', parsed, start, pos)
        elif ch == '"':
            start = pos
            pos += 1
            buf = []
            while pos < length and chars[pos] != '"':
                if chars[pos] == '\\' and pos + 1 < length:
                    buf.append(chars[pos])
                    buf.append(chars[pos + 1])
                    pos += 2
                else:
                    buf.append(chars[pos])
                    pos += 1
            if pos >= length:
                raise LexerError(start, chars[start:], 'unclosed quoted identifier')
            pos += 1
            raw = ''.join(buf)
            try:
                parsed = json.loads('"%s"' % raw)
            except ValueError:
                raise LexerError(start, raw, 'invalid quoted identifier') from None
            yield Token('quoted_identifier', parsed, start, pos)
        elif ch in DIGITS:
            start = pos
            while pos < length and chars[pos] in DIGITS:
                pos += 1
            yield Token('number', int(chars[start:pos]), start, pos)
        elif ch == '-':
            start = pos
            pos += 1
            if pos >= length or chars[pos] not in DIGITS:
                raise LexerError(start, ch, "unknown token '-'")
            while pos < length and chars[pos] in DIGITS:
                pos += 1
            yield Token('number', int(chars[start:pos]), start, pos)
        elif ch == '<':
            if pos + 1 < length and chars[pos + 1] == '=':
                yield Token('lte', '<=', pos, pos + 2)
                pos += 2
            else:
                yield Token('lt', '<', pos, pos + 1)
                pos += 1
        elif ch == '>':
            if pos + 1 < length and chars[pos + 1] == '=':
                yield Token('gte', '>=', pos, pos + 2)
                pos += 2
            else:
                yield Token('gt', '>', pos, pos + 1)
                pos += 1
        elif ch == '=':
            if pos + 1 < length and chars[pos + 1] == '=':
                yield Token('eq', '==', pos, pos + 2)
                pos += 2
            else:
                raise LexerError(pos, '=', "unknown token '=' (did you mean '=='?)")
        elif ch == '!':
            if pos + 1 < length and chars[pos + 1] == '=':
                yield Token('ne', '!=', pos, pos + 2)
                pos += 2
            else:
                yield Token('not', '!', pos, pos + 1)
                pos += 1
        else:
            raise LexerError(pos, ch, 'unknown token %r' % ch)
    yield Token('eof', '', length, length)
