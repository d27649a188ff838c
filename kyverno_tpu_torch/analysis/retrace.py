"""Retrace-hazard passes (KTPU2xx).

The reference's ``jax.jit`` caches compiled executables on (input
avals × static args × closure constants captured at trace time), and
KTPU201-203 guard that cache.  The port has no trace: its device
stages run eagerly as torch ops and hand-written kernels that take
any row count, so those three ids stay registered (their numbers are
a public contract in noqa comments and baselines) with a check that
finds nothing and the reason in the rule's summary:

* **KTPU201** — a jit-wrapped function reading a mutable closure
  container: an eager stage reads the container's current contents
  at every call, so nothing goes stale.
* **KTPU202** — a static jit argument with an unhashable default:
  the port's stages have no static arguments and no trace cache.
* **KTPU203** — shape-dependent Python branching in a jit-reachable
  function: an eager branch on ``.shape`` reads host metadata and
  compiles nothing, so it costs no executable per shape.

Two rules apply to the port as they do to the reference:

* **KTPU204** — a batch-encode entry (``encode_batch`` /
  ``encode_mutate_batch``) whose ``padded_n`` is computed instead of
  drawn from the canonical shape table (``compiler/shapes.py``): every
  computed row count is a fresh buffer size for the CUDA and pinned
  host caching allocators and a fresh row shape for each cache keyed
  by shape, and the admission batcher's occupancy accounting assumes
  the canonical capacities.
* **KTPU205** — per-row dict / deepcopy / json construction on the
  streaming encode hot path.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from .core import Context, Finding, register


def _scope_bindings(scope: ast.AST) -> dict:
    """name → last top-level assignment value in ``scope`` (direct
    statements only; nested function bodies are their own scopes)."""
    out = {}
    body = getattr(scope, 'body', [])
    stack = list(body)
    while stack:
        node = stack.pop(0)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.value
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name) and \
                node.value is not None:
            out[node.target.id] = node.value
        elif isinstance(node, (ast.If, ast.For, ast.While, ast.With,
                               ast.Try)):
            for attr in ('body', 'orelse', 'finalbody'):
                stack.extend(getattr(node, attr, []) or [])
            for h in getattr(node, 'handlers', []) or []:
                stack.extend(h.body)
    return out


def _not_applying(ctx: Context) -> Iterable[Finding]:
    return ()


register('KTPU201', 'not applicable to the port: jit-wrapped function '
                    'reading a mutable closure container — the port '
                    'has no trace, and an eager stage reads the '
                    'container\'s current contents at every call')(
    _not_applying)
register('KTPU202', 'not applicable to the port: static jit argument '
                    'with an unhashable default — the port\'s device '
                    'stages have no static arguments and no trace '
                    'cache')(_not_applying)
register('KTPU203', 'not applicable to the port: shape-dependent '
                    'branching retracing per shape — an eager branch on '
                    '.shape reads host metadata and compiles nothing')(
    _not_applying)


#: batch-encode entry points whose row padding decides a batch's row shape
_ENCODE_ENTRIES = frozenset({'encode_batch', 'encode_mutate_batch'})
#: provenance that marks a padded_n as canonical-table-derived
_CANONICAL_FNS = frozenset({'canonical_capacity', 'canonical_caps',
                            'small_capacity', 'pad_to_multiple'})


def _callee_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _padded_n_arg(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == 'padded_n':
            return kw.value
    # encode_batch(resources, cps, padded_n, ...) /
    # encode_mutate_batch(resources, program, padded_n, ...)
    if len(call.args) >= 3:
        return call.args[2]
    return None


def _contains_canonical_call(expr: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and
               _callee_name(n.func) in _CANONICAL_FNS
               for n in ast.walk(expr))


def _looks_computed(expr: ast.AST) -> bool:
    """True for the bucket-ladder shapes: bit_length()/shift
    arithmetic, or a hard-coded nonzero row count."""
    for n in ast.walk(expr):
        if isinstance(n, ast.Call) and _callee_name(n.func) == \
                'bit_length':
            return True
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.LShift):
            return True
        if isinstance(n, ast.Constant) and isinstance(n.value, int) and \
                not isinstance(n.value, bool) and n.value != 0:
            return True
    return False


#: functions whose bodies (plus their one-level same-file callees) ARE
#: the streaming encode hot path — per-row allocations here run a
#: million times per scan
_HOT_ENTRIES = frozenset({'encode_batch', 'encode_mutate_batch'})
#: call names that materialize per-row garbage: dict() construction,
#: deep copies, JSON serialization
_PER_ROW_ALLOC_CALLS = frozenset({'deepcopy', 'dumps', 'dict'})
#: comprehension nodes: their element expressions run once per
#: iteration, exactly like a loop body
_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                   ast.DictComp)


def _flag_hot_loop_allocs(sf, fn: ast.AST) -> Iterable[Finding]:
    found: List[ast.AST] = []

    def visit(node: ast.AST, in_loop: bool) -> None:
        if in_loop:
            if isinstance(node, (ast.Dict, ast.DictComp)):
                found.append(node)
            elif isinstance(node, ast.Call) and \
                    _callee_name(node.func) in _PER_ROW_ALLOC_CALLS:
                found.append(node)
        inner = in_loop or isinstance(
            node, (ast.For, ast.AsyncFor, ast.While) + _COMPREHENSIONS)
        for child in ast.iter_child_nodes(node):
            visit(child, inner)

    visit(fn, False)
    lines_seen: set = set()
    for node in found:
        if node.lineno in lines_seen:
            continue  # one finding per line, however many dicts it holds
        lines_seen.add(node.lineno)
        what = 'dict construction' if isinstance(
            node, (ast.Dict, ast.DictComp)) else \
            f'`{_callee_name(node.func)}(...)`'
        yield sf.finding(
            'KTPU205', node,
            f'per-row {what} inside `{fn.name}` on the streaming '
            f'encode hot path — hoist it out of the loop, reuse a '
            f'shared buffer/context, or go columnar '
            f'(encode.Lanes.encode_column)')


@register('KTPU205', 'per-row dict/deepcopy/json.dumps construction in '
                     'a function reachable from the streaming encode '
                     'hot path (encode_batch/encode_mutate_batch + '
                     'one-level callees) — allocations here run once '
                     'per resource per chunk')
def _check_hot_path_allocs(ctx: Context) -> Iterable[Finding]:
    for sf in ctx.files:
        if sf.tree is None:
            continue
        defs: dict = {}
        for node in sf.walk():
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, node)
        entries = [defs[n] for n in sorted(_HOT_ENTRIES) if n in defs]
        if not entries:
            continue
        # the hot set: the encode entries plus every same-file function
        # they call directly (bare-name resolution, one level — the
        # same local-dataflow depth as KTPU204)
        hot: List[ast.AST] = []
        seen: set = set()
        for fn in entries:
            if id(fn) not in seen:
                seen.add(id(fn))
                hot.append(fn)
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    target = defs.get(_callee_name(node.func))
                    if target is not None and id(target) not in seen:
                        seen.add(id(target))
                        hot.append(target)
        for fn in hot:
            yield from _flag_hot_loop_allocs(sf, fn)


@register('KTPU204', 'batch-encode padded_n not drawn from the '
                     'canonical shape table (compiler/shapes.py) — '
                     'each computed row count is a fresh buffer size '
                     'for the caching allocators and a fresh row shape '
                     'for every cache keyed by shape')
def _check_canonical_padding(ctx: Context) -> Iterable[Finding]:
    for sf in ctx.files:
        if sf.tree is None:
            continue
        # innermost enclosing scope per call site, for one-level
        # name resolution of `padded_n=<name>`
        scopes: List[Tuple[ast.AST, ast.Call]] = []

        def visit(node: ast.AST, scope: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                inner = scope
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    inner = child
                if isinstance(child, ast.Call) and \
                        _callee_name(child.func) in _ENCODE_ENTRIES:
                    scopes.append((scope, child))
                visit(child, inner)

        visit(sf.tree, sf.tree)
        for scope, call in scopes:
            expr = _padded_n_arg(call)
            if expr is None:
                continue
            if isinstance(expr, ast.Name):
                resolved = _scope_bindings(scope).get(expr.id)
                if resolved is None:
                    continue  # parameter / out-of-scope: undecidable
                expr = resolved
            if _contains_canonical_call(expr):
                continue
            if _looks_computed(expr):
                entry = _callee_name(call.func)
                yield sf.finding(
                    'KTPU204', call,
                    f'`{entry}` padded_n is computed locally — draw '
                    f'it from the canonical shape table '
                    f'(compiler/shapes.canonical_capacity) so every '
                    f'batch keeps the canonical row shapes')
