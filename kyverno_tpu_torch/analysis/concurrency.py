"""Concurrency-discipline passes (KTPU6xx) on the resolved call graph.

The serving and observability layers hand-maintain a set of thread
invariants that reviews keep re-litigating: worker threads must
re-install the ambient ``ScanCapture``/span before touching the
device path (PRs 11/16), residency gauges must be marked
``mark_reset_on_close`` so a drained server exports 0 (PR 13), and
shared attributes written from background threads need the same lock
their other writers hold.  With the v2 binder these are mechanical
reachability questions over ``Thread(target=...)`` roots, so they are
rules now:

* **KTPU601** — a module/instance attribute written from a
  ``Thread(target=...)``-reachable function while holding no lock
  that any *other* writer of the same attribute holds.  Lock context
  is lexical (``with self._lock:`` in the same function); writes in
  ``__init__`` are construction-time and don't count as a competing
  writer.  Scoped to classes that *own* a lock-typed attribute —
  a lockless class is declaring thread confinement, and flagging
  every such write would drown the signal (the rule checks lock
  *discipline*, not the absence of a threading design).
* **KTPU602** — a thread target whose reachable set records stage
  spans (``stage(...)`` / ``exec_scope(...)``) but never re-installs
  telemetry (``install_capture`` / ``install_span`` /
  ``ScanCapture``) — the worker's device work would record into no
  capture and parent to no request span.
* **KTPU603** — a residency-patterned gauge (``set_gauge`` from a
  loop or a thread-reachable worker) whose metric is never
  ``mark_reset_on_close``-marked (and never explicitly retracted via
  ``clear_gauge``) — a drained server would export the last sample
  forever.
* **KTPU604** — lock acquisition-order inversion: two locks the
  binder can identify acquired in both ``A→B`` and ``B→A`` order
  (nested ``with`` in one function, or one call edge deep).

All four passes share the binder's receiver typing: a "lock" is an
attribute or module var assigned from ``threading.Lock`` / ``RLock``
/ ``Condition``, identified as ``(ClassName, attr)`` or
``(module, name)`` — the same instance-attribute identity the code
uses."""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .core import Context, Finding, register
from .jitgraph import FuncKey, JitGraph, ModuleInfo, jit_graph

#: constructor names that produce a mutual-exclusion object
_LOCK_CTORS = {'Lock', 'RLock', 'Condition', 'Semaphore',
               'BoundedSemaphore'}

#: calls that record into the ambient stage-span machinery
_STAGE_CALLS = {'stage', 'exec_scope'}

#: calls that (re-)install the ambient telemetry on a thread
_INSTALL_CALLS = {'install_capture', 'install_span', 'ScanCapture'}

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)

LockId = Tuple  # ('attr', ClassName, attr) | ('module', rel, name)


def _is_lock_token(tok: Optional[Tuple]) -> bool:
    if tok is None:
        return False
    if tok[0] == 'local':
        return tok[1] in _LOCK_CTORS
    if tok[0] == 'attr':
        return tok[2] in _LOCK_CTORS
    return False


def _enclosing_function(mi: ModuleInfo,
                        node: ast.AST) -> Optional[ast.AST]:
    cur = mi.parents.get(node)
    while cur is not None:
        if isinstance(cur, _FUNC_DEFS):
            return cur
        cur = mi.parents.get(cur)
    return None


def _enclosing_class_name(mi: ModuleInfo,
                          node: ast.AST) -> Optional[str]:
    cur = mi.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur.name
        cur = mi.parents.get(cur)
    return None


class ThreadModel:
    """Shared KTPU6xx state: thread roots, lock identities, per-node
    lexical lock context — built once per Context on top of the
    binder."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.graph: JitGraph = jit_graph(ctx)
        # (root FuncKey, target mi, target fn, Thread() call, site sf)
        self.roots: List[Tuple] = []
        self._lock_withs_cache: Dict[FuncKey, List] = {}
        self._find_thread_roots()
        self.thread_reachable: Set[FuncKey] = set()
        self._root_reach: Dict[int, Set[FuncKey]] = {}
        for i, (_k, tmi, tfn, _call, _sf) in enumerate(self.roots):
            reach = self.graph.reachable_set(tmi, tfn)
            self._root_reach[i] = reach
            self.thread_reachable |= reach

    # -- thread roots --------------------------------------------------------

    @staticmethod
    def _is_thread_ctor(func: ast.AST) -> bool:
        if isinstance(func, ast.Name):
            return func.id == 'Thread'
        if isinstance(func, ast.Attribute):
            return func.attr == 'Thread'
        return False

    def _find_thread_roots(self) -> None:
        g = self.graph
        for mi in g.modules.values():
            for node in mi.sf.nodes_of(ast.Call):
                if not self._is_thread_ctor(node.func):
                    continue
                target = next((kw.value for kw in node.keywords
                               if kw.arg == 'target'), None)
                if target is None:
                    continue
                fn = _enclosing_function(mi, node)
                resolved: List[Tuple[ModuleInfo, ast.AST]] = []
                if isinstance(target, ast.Name):
                    resolved = [(mi, d)
                                for d in mi.defs.get(target.id, [])]
                    if not resolved:
                        imp = mi.imports.get(target.id)
                        if imp is not None and imp[0] == 'from':
                            tgt = g.by_dotted.get(imp[1])
                            if tgt is not None:
                                resolved = [(tgt, d) for d in
                                            tgt.defs.get(imp[2], [])]
                elif isinstance(target, ast.Attribute):
                    resolved = g._resolve_attr_call(mi, fn, target)
                for tmi, tfn in resolved:
                    self.roots.append(
                        ((tmi.sf.rel, tfn.lineno), tmi, tfn, node,
                         mi.sf))

    # -- lock identity -------------------------------------------------------

    def lock_id(self, mi: ModuleInfo, fn: Optional[ast.AST],
                expr: ast.AST) -> Optional[LockId]:
        """Identity of a ``with <expr>:`` context manager when the
        binder can prove it's a lock."""
        g = self.graph
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            base = expr.value.id
            if base == 'self':
                cls = _enclosing_class_name(mi, fn) \
                    if fn is not None else None
                if cls is not None:
                    ci = mi.classes.get(cls)
                    if ci is not None and \
                            _is_lock_token(ci.attr_types.get(expr.attr)):
                        return ('attr', cls, expr.attr)
                return None
            tok = g._receiver_token(mi, fn, expr.value)
            if tok is not None:
                resolved = g._resolve_class(mi, tok)
                if resolved is not None:
                    tmi, ci = resolved
                    if _is_lock_token(ci.attr_types.get(expr.attr)):
                        return ('attr', ci.name, expr.attr)
            return None
        if isinstance(expr, ast.Name):
            if _is_lock_token(mi.var_types.get(expr.id)):
                return ('module', mi.sf.rel, expr.id)
            if fn is not None and _is_lock_token(
                    g._local_types(mi, fn).get(expr.id)):
                return ('module', mi.sf.rel, expr.id)
        return None

    def held_locks(self, mi: ModuleInfo, fn: ast.AST,
                   node: ast.AST) -> Set[LockId]:
        """Locks lexically held at ``node`` (``with`` ancestors inside
        the same function)."""
        out: Set[LockId] = set()
        cur = mi.parents.get(node)
        while cur is not None and not isinstance(cur, _FUNC_DEFS):
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    lid = self.lock_id(mi, fn, item.context_expr)
                    if lid is not None:
                        out.add(lid)
            cur = mi.parents.get(cur)
        return out

    def fn_lock_withs(self, mi: ModuleInfo, fn: ast.AST
                      ) -> List[Tuple[ast.AST, List[LockId]]]:
        """``with`` statements in ``fn`` that acquire provable locks,
        with their per-item identities in acquisition order
        (memoized)."""
        key = (mi.sf.rel, fn.lineno)
        hit = self._lock_withs_cache.get(key)
        if hit is not None:
            return hit
        out = []
        for node in self.graph.scope_nodes(mi, fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                ids = []
                for item in node.items:
                    lid = self.lock_id(mi, fn, item.context_expr)
                    if lid is not None:
                        ids.append(lid)
                if ids:
                    out.append((node, ids))
        self._lock_withs_cache[key] = out
        return out


def thread_model(ctx: Context) -> ThreadModel:
    return ctx.cached('threadmodel', lambda: ThreadModel(ctx))


def _lock_name(lid: LockId) -> str:
    if lid[0] == 'attr':
        return f'{lid[1]}.{lid[2]}'
    return f'{lid[1]}:{lid[2]}'


# -- KTPU601: unlocked shared-attribute write from a thread ------------------

@register('KTPU601', 'attribute written from a Thread-reachable '
                     'function without holding a lock shared with '
                     'its other writers')
def _check_unlocked_write(ctx: Context) -> Iterable[Finding]:
    tm = thread_model(ctx)
    g = tm.graph
    # identity -> list of (fn key, fn node, write node, mi, locks)
    # One pass over the per-file assignment index; a write belongs to
    # its *innermost* enclosing function — the same attribution
    # walk_scope gives (it never descends into nested defs).
    writers: Dict[Tuple, List[Tuple]] = {}
    for mi in g.modules.values():
        globals_memo: Dict[int, Set[str]] = {}
        for node in mi.sf.nodes_of(ast.Assign, ast.AugAssign):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            cands = [t for t in targets
                     if (isinstance(t, ast.Attribute) and
                         isinstance(t.value, ast.Name) and
                         t.value.id == 'self')
                     or isinstance(t, ast.Name)]
            if not cands:
                continue
            fn = _enclosing_function(mi, node)
            if fn is None or fn.name in ('__init__', '__new__',
                                         '__del__'):
                continue
            fkey = (mi.sf.rel, fn.lineno)
            for t in cands:
                ident = None
                if isinstance(t, ast.Attribute):
                    cls = _enclosing_class_name(mi, fn)
                    ci = mi.classes.get(cls) \
                        if cls is not None else None
                    if ci is not None and any(
                            _is_lock_token(tok) for tok in
                            ci.attr_types.values()):
                        ident = ('attr', mi.sf.rel, cls, t.attr)
                else:
                    declared = globals_memo.get(id(fn))
                    if declared is None:
                        declared = set()
                        for g_node in g.scope_nodes(mi, fn):
                            if isinstance(g_node, ast.Global):
                                declared.update(g_node.names)
                        globals_memo[id(fn)] = declared
                    if t.id in declared:
                        ident = ('global', mi.sf.rel, t.id)
                if ident is None:
                    continue
                locks = tm.held_locks(mi, fn, node)
                writers.setdefault(ident, []).append(
                    (fkey, fn, node, mi, locks))
    for ident, sites in writers.items():
        fns = {s[0] for s in sites}
        if len(fns) < 2:
            continue  # single-writer attributes are uncontended
        for fkey, fn, node, mi, locks in sites:
            if fkey not in tm.thread_reachable:
                continue
            others = [s for s in sites if s[0] != fkey]
            other_locks: Set[Tuple] = set()
            for o in others:
                other_locks |= o[4]
            if locks & other_locks:
                continue
            attr = ident[-1]
            where = 'self.' + attr if ident[0] == 'attr' else attr
            held = ', '.join(sorted(_lock_name(x) for x in
                                    other_locks)) or 'none proven'
            yield mi.sf.finding(
                'KTPU601', node,
                f'`{where}` is written in thread-reachable '
                f'`{fn.name}` without a lock shared with its other '
                f'writer(s) (their locks: {held}) — take the same '
                f'lock, or make this the single writer')
            break  # one finding per (attribute, function)


# -- KTPU602: thread into span-recording code without re-install -------------

def _fn_calls_any(g: JitGraph, mi: ModuleInfo, fn: ast.AST,
                  names: Set[str]) -> bool:
    for node in g.scope_nodes(mi, fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in names:
            return True
        if isinstance(f, ast.Attribute) and f.attr in names:
            return True
    return False


@register('KTPU602', 'thread target reaches stage()/span-recording '
                     'code without a ScanCapture/install_span '
                     're-install on its path')
def _check_thread_span_install(ctx: Context) -> Iterable[Finding]:
    tm = thread_model(ctx)
    g = tm.graph
    stage_memo: Dict[FuncKey, bool] = {}
    install_memo: Dict[FuncKey, bool] = {}
    info_by_key: Dict[FuncKey, Tuple[ModuleInfo, ast.AST]] = {}
    for mi in g.modules.values():
        for defs in mi.defs.values():
            for fn in defs:
                info_by_key[(mi.sf.rel, fn.lineno)] = (mi, fn)
    seen_sites: Set[Tuple[str, int]] = set()
    for i, (_rk, tmi, tfn, call, site_sf) in enumerate(tm.roots):
        reach = tm._root_reach[i]
        stage_hit = None
        installed = False
        for key in reach:
            pair = info_by_key.get(key)
            if pair is None:
                continue
            if key not in stage_memo:
                stage_memo[key] = _fn_calls_any(g, pair[0], pair[1],
                                                _STAGE_CALLS)
            if key not in install_memo:
                install_memo[key] = _fn_calls_any(g, pair[0], pair[1],
                                                  _INSTALL_CALLS)
            if stage_memo[key] and stage_hit is None:
                stage_hit = pair
            if install_memo[key]:
                installed = True
                break
        if stage_hit is None or installed:
            continue
        site = (site_sf.rel, call.lineno)
        if site in seen_sites:
            continue
        seen_sites.add(site)
        smi, sfn = stage_hit
        yield site_sf.finding(
            'KTPU602', call,
            f'thread target `{tfn.name}` reaches span-recording '
            f'`{sfn.name}` ({smi.sf.rel}) but never re-installs '
            f'telemetry — wrap the worker body in '
            f'`devtel.install_capture(...)` / '
            f'`tracing.install_span(...)` so stage spans land on the '
            f'request trace')


# -- KTPU603: residency gauge without reset-on-close -------------------------

def _resolve_metric_name(g: JitGraph, mi: ModuleInfo,
                         arg: ast.AST) -> Optional[str]:
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.Name):
        return _module_str_constant(g, mi, arg.id)
    if isinstance(arg, ast.Attribute) and \
            isinstance(arg.value, ast.Name):
        imp = mi.imports.get(arg.value.id)
        if imp is not None:
            dotted = imp[1] if imp[0] == 'module' \
                else f'{imp[1]}.{imp[2]}'
            tgt = g.by_dotted.get(dotted)
            if tgt is not None:
                return _module_str_constant(g, tgt, arg.attr)
    return None


def _module_str_constant(g: JitGraph, mi: ModuleInfo,
                         name: str) -> Optional[str]:
    for node in mi.sf.nodes_of(ast.Assign):
        if not isinstance(mi.parents.get(node), ast.Module):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id == name and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, str):
                return node.value.value
    imp = mi.imports.get(name)
    if imp is not None and imp[0] == 'from':
        tgt = g.by_dotted.get(imp[1])
        if tgt is not None and tgt is not mi:
            return _module_str_constant(g, tgt, imp[2])
    return None


def _inside_loop(mi: ModuleInfo, node: ast.AST) -> bool:
    cur = mi.parents.get(node)
    while cur is not None and not isinstance(cur, _FUNC_DEFS):
        if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
            return True
        cur = mi.parents.get(cur)
    return False


@register('KTPU603', 'residency-pattern gauge (set from a loop or '
                     'worker thread) registered without '
                     'mark_reset_on_close')
def _check_residency_gauge(ctx: Context) -> Iterable[Finding]:
    tm = thread_model(ctx)
    g = tm.graph
    marked: Set[str] = set()
    cleared: Set[str] = set()
    for mi in g.modules.values():
        for node in mi.sf.nodes_of(ast.Call):
            f = node.func
            attr = f.attr if isinstance(f, ast.Attribute) else \
                (f.id if isinstance(f, ast.Name) else None)
            if attr not in ('mark_reset_on_close', 'clear_gauge'):
                continue
            if not node.args:
                continue
            name = _resolve_metric_name(g, mi, node.args[0])
            if name is None:
                continue
            (marked if attr == 'mark_reset_on_close'
             else cleared).add(name)
    for mi in g.modules.values():
        for node in mi.sf.nodes_of(ast.Call):
            f = node.func
            if not (isinstance(f, ast.Attribute) and
                    f.attr == 'set_gauge' and node.args):
                continue
            fn = _enclosing_function(mi, node)
            if fn is None:
                continue
            residency = _inside_loop(mi, node) or \
                (mi.sf.rel, fn.lineno) in tm.thread_reachable
            if not residency:
                continue
            name = _resolve_metric_name(g, mi, node.args[0])
            if name is None or name in marked or name in cleared:
                continue
            how = 'inside a loop' if _inside_loop(mi, node) \
                else 'from a thread-reachable worker'
            yield mi.sf.finding(
                'KTPU603', node,
                f'gauge {name!r} is set {how} in `{fn.name}` but '
                f'never marked reset-on-close — a drained server '
                f'exports the last sample forever; call '
                f'`registry.mark_reset_on_close({name!r})` at '
                f'registration (or retract with `clear_gauge`)')


# -- KTPU604: lock acquisition-order inversion --------------------------------

@register('KTPU604', 'lock acquisition-order inversion across a '
                     'two-lock pair the binder can prove')
def _check_lock_order(ctx: Context) -> Iterable[Finding]:
    tm = thread_model(ctx)
    g = tm.graph
    # ordered pair -> first (sf, node) observed acquiring that order
    orders: Dict[Tuple[LockId, LockId], Tuple] = {}

    def record(outer: LockId, inner: LockId, sf, node) -> None:
        if outer != inner:
            orders.setdefault((outer, inner), (sf, node))

    for mi in g.modules.values():
        for defs in mi.defs.values():
            for fn in defs:
                withs = tm.fn_lock_withs(mi, fn)
                if not withs:
                    continue
                for node, ids in withs:
                    # multi-item `with A, B:` acquires in order
                    for i in range(len(ids)):
                        for j in range(i + 1, len(ids)):
                            record(ids[i], ids[j], mi.sf, node)
                    held = tm.held_locks(mi, fn, node)
                    for outer in held:
                        for inner in ids:
                            record(outer, inner, mi.sf, node)
                    # one call edge deep: body calls into a function
                    # that takes its own provable lock
                    for sub in ast.walk(node):
                        if not isinstance(sub, ast.Call):
                            continue
                        for tmi, d in g.resolve_call(mi, fn, sub):
                            for _n2, ids2 in tm.fn_lock_withs(tmi, d):
                                for inner in ids2:
                                    for outer in ids:
                                        record(outer, inner,
                                               mi.sf, sub)
    reported: Set[frozenset] = set()
    for (a, b), (sf, node) in sorted(
            orders.items(), key=lambda kv: (kv[1][0].rel,
                                            kv[1][1].lineno)):
        if (b, a) not in orders:
            continue
        pair = frozenset((a, b))
        if pair in reported:
            continue
        reported.add(pair)
        other_sf, other_node = orders[(b, a)]
        yield sf.finding(
            'KTPU604', node,
            f'lock order inversion: `{_lock_name(a)}` then '
            f'`{_lock_name(b)}` here, but `{_lock_name(b)}` then '
            f'`{_lock_name(a)}` at {other_sf.rel}:{other_node.lineno} '
            f'— pick one global order or merge the critical sections')
