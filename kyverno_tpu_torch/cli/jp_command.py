"""``kyverno jp`` — JMESPath query/parse/function subcommands.

Reference: cmd/cli/kubectl-kyverno/jp/{query,parse,function} — a REPL-ish
debugger for the engine's JMESPath dialect (41 custom functions).
"""

from __future__ import annotations

import json
import sys

import yaml

from ..engine import jmespath as jp


def command_query(args) -> int:
    exprs = list(args.query or [])
    for qf in args.query_file or []:
        with open(qf, encoding='utf-8') as f:
            exprs.append(f.read().strip())
    if not exprs:
        print('no query given')
        return 1
    if args.input:
        with open(args.input, encoding='utf-8') as f:
            data = yaml.safe_load(f)
    else:
        data = yaml.safe_load(sys.stdin.read())
    for expr in exprs:
        try:
            compiled = jp.compile(expr)
        except jp.JMESPathError as exc:
            print(f'failed to compile query: {exc}')
            return 1
        try:
            result = compiled.search(data)
        except jp.JMESPathError as exc:
            print(f'failed to execute query: {exc}')
            return 1
        if len(exprs) > 1:
            print(f'# {expr}')
        if args.unquoted and isinstance(result, str):
            print(result)
        else:
            print(json.dumps(result, indent=2))
    return 0


def command_parse(args) -> int:
    from ..engine.jmespath.parser import parse
    exprs = list(args.expression or [])
    if not exprs:
        exprs = [sys.stdin.read().strip()]
    for expr in exprs:
        try:
            ast = parse(expr)
        except jp.JMESPathError as exc:
            print(f'failed to parse: {exc}')
            return 1
        print(_format_ast(ast))
    return 0


def _format_ast(node, indent: int = 0) -> str:
    pad = '  ' * indent
    ntype = node.get('type', '')
    value = node.get('value', '')
    children = node.get('children') or []
    line = f'{pad}{ntype}({value!r})'
    if children:
        inner = '\n'.join(_format_ast(c, indent + 1)
                          for c in children if isinstance(c, dict))
        return f'{line}\n{inner}' if inner else line
    return line


def command_function(args) -> int:
    from ..engine.jmespath.custom import register_custom_functions
    from ..engine.jmespath.interpreter import make_builtin_registry
    registry = register_custom_functions(make_builtin_registry())
    names = set(args.name or [])
    for fname in registry.names():
        if names and fname not in names:
            continue
        entry = registry._functions[fname]
        sig = ', '.join('|'.join(arg.get('types') or ['any'])
                        for arg in entry['signature'])
        if entry.get('variadic'):
            sig += ', ...'
        print(f'{fname}({sig})')
    return 0
