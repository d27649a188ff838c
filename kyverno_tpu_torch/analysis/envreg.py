"""Env-knob registry passes (KTPU4xx).

Every ``KTPU_*`` environment read must appear in the
:mod:`kyverno_tpu_torch.analysis.knobs` registry (which also generates the
README knob table), and every registry entry must still have a read
site.  Detection covers the spellings this tree actually uses:
``os.environ.get(...)``, ``os.environ[...]``, ``os.getenv(...)``, and
the import-dodging ``__import__('os').environ.get(...)`` /
``_os.environ.get(...)`` forms (any root object with an ``environ``
attribute counts).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Tuple

from .core import Context, Finding, SourceFile, register
from .knobs import KNOBS

PREFIX = 'KTPU_'


def _env_read_name(node: ast.AST):
    """The literal env-var name read by ``node``, if it is an environ
    access of any spelling."""
    # os.environ['X'] (including .get-less Subscript)
    if isinstance(node, ast.Subscript) and \
            isinstance(node.value, ast.Attribute) and \
            node.value.attr == 'environ':
        sl = node.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
            return sl.value
        return None
    if not isinstance(node, ast.Call) or not node.args:
        return None
    f = node.func
    key = node.args[0]
    if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
        return None
    if isinstance(f, ast.Attribute):
        if f.attr == 'get' and isinstance(f.value, ast.Attribute) and \
                f.value.attr == 'environ':
            return key.value
        if f.attr == 'getenv':
            return key.value
    elif isinstance(f, ast.Name) and f.id == 'getenv':
        return key.value
    return None


def env_reads(ctx: Context) -> List[Tuple[SourceFile, ast.AST, str]]:
    def build():
        out = []
        for sf in ctx.files:
            if sf.tree is None:
                continue
            for node in sf.walk():
                name = _env_read_name(node)
                if name is not None and name.startswith(PREFIX):
                    out.append((sf, node, name))
        return out
    return ctx.cached('env_reads', build)


@register('KTPU401', 'KTPU_* environ read missing from the knob '
                     'registry (analysis/knobs.py)')
def _check_unregistered_reads(ctx: Context) -> Iterable[Finding]:
    for sf, node, name in env_reads(ctx):
        if name not in KNOBS:
            yield sf.finding(
                'KTPU401', node,
                f'env knob {name!r} is not registered in '
                f'kyverno_tpu_torch/analysis/knobs.py — register it (with '
                f'default, type, and operator-facing help) so the '
                f'README table includes it')


@register('KTPU402', 'registered knob with no read site in the tree '
                     '(dead knob)')
def _check_dead_knobs(ctx: Context) -> Iterable[Finding]:
    read = {name for _sf, _node, name in env_reads(ctx)}
    anchor = ctx.by_rel('kyverno_tpu_torch/analysis/knobs.py')
    for name in sorted(KNOBS):
        if name not in read:
            target = anchor if anchor is not None else ctx.files[0]
            line = 1
            if anchor is not None:
                for i, text in enumerate(anchor.lines, start=1):
                    if f"'{name}'" in text:
                        line = i
                        break
            yield target.finding(
                'KTPU402', line,
                f'knob {name!r} is registered but never read — remove '
                f'the entry or wire the read site')
