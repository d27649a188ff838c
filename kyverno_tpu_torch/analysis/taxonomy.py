"""Fallback-taxonomy passes (KTPU3xx).

PR 3's coverage ledger only works if every host fallback is
*attributed*: a ``CompileError`` / ``FALLBACK`` / ``_HOST_MARKER`` site
that names no taxonomy reason shows up in dashboards as ``unknown``,
and a taxonomy reason with no raise site is documentation fiction.
Both are program-structure properties — enforced here, statically.

* **KTPU301** — a ``reason`` handed to a fallback-recording call
  (``CompileError``, ``_fallback``, ``tally.fallback``,
  ``coverage.record_fallback``, ``host_rule``, ``record_scan``) is not
  a member of the ``observability/coverage.py`` taxonomy (string
  literals and ``REASON_*`` constant references are both resolved).
* **KTPU302** — a bare ``return <SENTINEL>`` (``FALLBACK`` /
  ``_HOST_MARKER`` — any module-level ``X = object()`` sentinel) in a
  ``compiler/`` or ``mutate/`` (device-side mutate) file whose
  enclosing function never attributes a reason: the fallback escapes
  the ledger.
* **KTPU303** — dead reason: a taxonomy member no site ever raises
  (mirrors the dead-metric pass).
* **KTPU304** — a broad ``except Exception`` in a serving-path file
  (any ``serving/`` component, or a ``pipeline.py``) that neither
  re-raises nor records a shed/fallback reason: the never-500
  discipline says every swallowed serving error must land on a ledger
  somewhere, or degradation becomes silent.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, Optional, Set, Tuple

from .core import Context, Finding, register
from .jitgraph import jit_graph, walk_scope

#: reason-carrying calls: callee name → (positional index, kwarg name)
REASON_CALLS: Dict[str, Tuple[int, str]] = {
    'CompileError': (1, 'reason'),
    '_fallback': (0, 'reason'),
    'fallback': (1, 'reason'),
    'record_fallback': (1, 'reason'),
    'host_rule': (2, 'reason'),
    'record_scan': (3, 'reason'),
}

#: attribution calls that mark an enclosing function as ledger-aware
ATTRIBUTING_CALLS = {'_fallback', 'fallback', 'record_fallback',
                     'host_rule'}

COVERAGE_REL = os.path.join('kyverno_tpu_torch', 'observability', 'coverage.py')
COVERAGE_MODULE = 'kyverno_tpu_torch.observability.coverage'


def load_taxonomy(ctx: Context) -> Dict[str, str]:
    """``REASON_*`` constant name → slug, parsed from coverage.py's AST
    (the analyzed tree's copy when present, the installed one
    otherwise — fixture trees validate against the real taxonomy)."""
    def build():
        sf = ctx.by_rel(COVERAGE_REL.replace(os.sep, '/')) or \
            ctx.by_rel(COVERAGE_REL)
        if sf is not None and sf.tree is not None:
            tree = sf.tree
        else:
            path = os.path.join(os.path.dirname(__file__), '..',
                                'observability', 'coverage.py')
            with open(path, encoding='utf-8') as f:
                tree = ast.parse(f.read())
        consts: Dict[str, str] = {}
        members: Optional[Set[str]] = None
        for node in tree.body:
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name) and \
                            t.id.startswith('REASON_'):
                        consts[t.id] = node.value.value
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    getattr(node.value.func, 'id', '') == 'frozenset' and \
                    any(getattr(t, 'id', '') == 'REASONS'
                        for t in node.targets):
                members = set()
                for leaf in ast.walk(node.value):
                    if isinstance(leaf, ast.Name) and \
                            leaf.id.startswith('REASON_'):
                        members.add(leaf.id)
        if members is not None:
            consts = {k: v for k, v in consts.items() if k in members}
        return consts
    return ctx.cached('taxonomy', build)


def _callee_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _reason_arg(call: ast.Call) -> Optional[ast.AST]:
    name = _callee_name(call.func)
    if name not in REASON_CALLS:
        return None
    pos, kw = REASON_CALLS[name]
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    if len(call.args) > pos:
        return call.args[pos]
    return None


def _is_coverage_ref(mi, node: ast.AST) -> Optional[str]:
    """``REASON_*`` constant name when ``node`` references one through
    the coverage module (imported name or module-attribute access)."""
    if isinstance(node, ast.Name):
        imp = mi.imports.get(node.id)
        if imp and imp[0] == 'from' and imp[1] == COVERAGE_MODULE:
            return imp[2]
        return None
    if isinstance(node, ast.Attribute) and \
            node.attr.startswith('REASON_') and \
            isinstance(node.value, ast.Name):
        imp = mi.imports.get(node.value.id)
        if imp and ((imp[0] == 'module' and imp[1] == COVERAGE_MODULE) or
                    (imp[0] == 'from' and
                     f'{imp[1]}.{imp[2]}' == COVERAGE_MODULE)):
            return node.attr
    return None


@register('KTPU301', 'fallback reason outside the '
                     'observability/coverage.py taxonomy')
def _check_reason_values(ctx: Context) -> Iterable[Finding]:
    taxonomy = load_taxonomy(ctx)
    slugs = set(taxonomy.values())
    graph = jit_graph(ctx)
    for rel, mi in graph.modules.items():
        if rel.replace(os.sep, '/').endswith(
                'observability/coverage.py'):
            continue
        for node in mi.sf.walk():
            if not isinstance(node, ast.Call):
                continue
            arg = _reason_arg(node)
            if arg is None:
                continue
            if isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str):
                if arg.value not in slugs:
                    yield mi.sf.finding(
                        'KTPU301', node,
                        f'reason {arg.value!r} is not in the coverage '
                        f'taxonomy — use a slug from '
                        f'observability/coverage.py REASONS')
            else:
                const = _is_coverage_ref(mi, arg)
                if const is not None and const not in taxonomy:
                    yield mi.sf.finding(
                        'KTPU301', node,
                        f'`{const}` is not a taxonomy constant in '
                        f'observability/coverage.py')


def _sentinel_names(ctx: Context) -> Set[str]:
    """Module-level ``X = object()`` *fallback* sentinel names across
    the tree.  Only names that read as fallback markers count
    (``FALLBACK`` / ``*HOST*``) — encoder-internal sentinels like
    ``_MISSING`` mark absent values, not host escapes."""
    def build():
        out: Set[str] = set()
        for sf in ctx.files:
            if sf.tree is None:
                continue
            for node in sf.tree.body:
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call) and \
                        getattr(node.value.func, 'id', '') == 'object' \
                        and not node.value.args:
                    for t in node.targets:
                        if isinstance(t, ast.Name) and (
                                'FALLBACK' in t.id or 'HOST' in t.id):
                            out.add(t.id)
        return out
    return ctx.cached('sentinels', build)


def _attributes_reason(fn: ast.AST) -> bool:
    for node in walk_scope(fn):
        if isinstance(node, ast.Call) and \
                _callee_name(node.func) in ATTRIBUTING_CALLS:
            return True
        if isinstance(node, ast.Raise) and \
                isinstance(node.exc, ast.Call) and \
                _callee_name(node.exc.func) == 'CompileError':
            return True
    return False


@register('KTPU302', 'unattributed host-fallback site in compiler/ or '
                     'mutate/ (bare sentinel return with no taxonomy '
                     'reason)')
def _check_unattributed_fallback(ctx: Context) -> Iterable[Finding]:
    sentinels = _sentinel_names(ctx)
    graph = jit_graph(ctx)
    for rel, mi in graph.modules.items():
        parts = rel.replace(os.sep, '/').split('/')
        # compiler/ plus the device-side mutate package (its lowering
        # shares the FALLBACK discipline); engine/mutate/ is the host
        # oracle and carries no sentinels
        if 'compiler' not in parts and \
                not ('mutate' in parts and 'engine' not in parts):
            continue
        for defs in mi.defs.values():
            for fn in defs:
                attributes = None  # computed lazily per function
                for node in walk_scope(fn):
                    if not (isinstance(node, ast.Return) and
                            isinstance(node.value, ast.Name) and
                            node.value.id in sentinels):
                        continue
                    if attributes is None:
                        attributes = _attributes_reason(fn)
                    if not attributes:
                        yield mi.sf.finding(
                            'KTPU302', node,
                            f'`return {node.value.id}` in `{fn.name}` '
                            f'records no taxonomy reason — attribute '
                            f'via _fallback()/tally.fallback()/'
                            f'coverage.record_fallback()')


@register('KTPU303', 'dead taxonomy reason: no raise/record site '
                     'anywhere in the tree')
def _check_dead_reasons(ctx: Context) -> Iterable[Finding]:
    taxonomy = load_taxonomy(ctx)
    if not taxonomy:
        return
    used: Set[str] = set()
    graph = jit_graph(ctx)
    for rel, mi in graph.modules.items():
        if rel.replace(os.sep, '/').endswith(
                'observability/coverage.py'):
            continue
        for node in mi.sf.walk():
            if isinstance(node, ast.Call):
                arg = _reason_arg(node)
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str):
                    used.add(arg.value)
            const = _is_coverage_ref(mi, node) \
                if isinstance(node, (ast.Name, ast.Attribute)) else None
            if const is not None and const in taxonomy:
                used.add(taxonomy[const])
    cov = ctx.by_rel(COVERAGE_REL.replace(os.sep, '/'))
    for const, slug in sorted(taxonomy.items()):
        if slug in used:
            continue
        line = 1
        if cov is not None and cov.tree is not None:
            for node in cov.tree.body:
                if isinstance(node, ast.Assign) and any(
                        getattr(t, 'id', '') == const
                        for t in node.targets):
                    line = node.lineno
                    break
        anchor = cov if cov is not None else ctx.files[0]
        yield anchor.finding(
            'KTPU303', line,
            f'taxonomy reason {slug!r} ({const}) has no raise/record '
            f'site — remove it or wire the fallback that should '
            f'carry it')


#: calls inside an ``except Exception`` handler that prove the
#: failure was attributed instead of silently swallowed: shed-ledger
#: records, coverage records, and the batcher's quarantine entry
#: points (which shed transitively per isolated row)
SHED_CALLS = {'shed', '_try_shed', 'record', 'record_shed',
              'record_fallback', '_shed_batch', '_quarantine'}


def _is_broad_except(node: ast.ExceptHandler) -> bool:
    names = []
    if node.type is None:
        return True  # bare except:
    for leaf in ast.walk(node.type):
        if isinstance(leaf, ast.Name):
            names.append(leaf.id)
        elif isinstance(leaf, ast.Attribute):
            names.append(leaf.attr)
    return 'Exception' in names or 'BaseException' in names


def _handler_attributes(node: ast.ExceptHandler) -> bool:
    for stmt in node.body:
        for leaf in ast.walk(stmt):
            if isinstance(leaf, ast.Raise):
                return True
            if isinstance(leaf, ast.Call) and \
                    _callee_name(leaf.func) in SHED_CALLS:
                return True
    return False


@register('KTPU304', 'serving-path `except Exception` that neither '
                     'records a shed reason nor re-raises')
def _check_swallowed_serving_errors(ctx: Context) -> Iterable[Finding]:
    graph = jit_graph(ctx)
    for rel, mi in graph.modules.items():
        parts = rel.replace(os.sep, '/').split('/')
        if 'serving' not in parts and parts[-1] != 'pipeline.py':
            continue
        for node in mi.sf.walk():
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad_except(node) or _handler_attributes(node):
                continue
            yield mi.sf.finding(
                'KTPU304', node,
                'broad except on the serving path neither re-raises '
                'nor records a shed/fallback reason — a swallowed '
                'serving error is silent degradation; attribute it '
                'via the shed ledger or coverage.record_fallback()')
