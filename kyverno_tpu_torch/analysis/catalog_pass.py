"""Metric- and span-catalog passes (KTPU5xx) — the reference's
standalone metric-name checker as lint passes, with its allowlist
semantics, module API (:func:`check_main`) and exit codes.

* **KTPU501** — a registry write (``inc`` / ``observe`` / ``set_gauge``
  / ``clear_gauge`` / ``register_histogram``) uses a metric name absent
  from ``observability/catalog.py``.
* **KTPU502** — a write site whose name argument is neither a string
  literal nor a resolvable UPPER_CASE module constant (uncheckable —
  use a constant).
* **KTPU503** — dead metric: a cataloged name with no write site in
  the tree (``DEAD_METRIC_ALLOWLIST`` names the deliberate
  exceptions, each with the reason it may exist without an emitter).
  The allowlist is itself checked both ways: an entry whose metric
  *gained* a write site is stale (the exception no longer excuses
  anything — remove it so the metric is catalog-checked like every
  other), and an entry naming a metric absent from the catalog is
  dead weight.  New subsystems therefore can't hide behind the
  allowlist: the moment their emitter lands, only the catalog rules.
* **KTPU504** — a span start site (``start_span`` / a device
  ``stage(...)`` timer) whose name is absent from the span catalog
  (``observability/catalog.py:SPANS``), or whose name cannot be
  resolved at all.  Dynamic (f-string) names are checked by literal
  prefix against the catalog, so route-templated spans like
  ``webhooks/<route>`` stay checkable.
* **KTPU505** — dead span: a cataloged span name nothing in the tree
  starts — the span analogue of KTPU503, so the README span table
  (generated from the same catalog) can never document spans that no
  longer exist.
* **KTPU507** — pipeline stage-label drift: a ``stage('<s>')`` /
  ``exec_scope`` / ``ChunkPipeline`` stage-list / ``add_backpressure``
  label used under ``compiler/`` that is not registered in
  ``observability/catalog.py:PIPELINE_STAGES`` (the timeline
  critical-path walk and the blame metric group by registered names,
  so an unregistered label silently drops out of attribution), or a
  registered stage with no use site anywhere in the tree (dead-stage
  check, the KTPU503/505 analogue).
* **KTPU508** — partition key hygiene: an ``executable_cache_key``
  call site outside ``kyverno_tpu_torch/partition/`` whose fingerprint
  operand (resolved one level through enclosing-scope bindings, the
  KTPU204 depth) consumes ``policy_set_fingerprint`` — the whole-set
  fingerprint in a compile/AOT key means one policy edit invalidates
  every partition's executables; draw it from
  ``partition/keys.compile_fingerprint`` instead.
* **KTPU509** — fleet-scope hygiene: metrics written from the mesh
  path (``kyverno_tpu_torch/parallel/``) feed the cross-host federation
  (``observability/fleet.py``), so without a shard/host identity label
  the merged view collapses every process's series into one lying
  number.  The catalog's ``fleet_scope`` field names the required
  label key (``shard`` / ``mesh``); the pass flags a parallel/ write
  of a metric with no declared scope, any write of a scoped metric
  missing its identity keyword, and a declared scope no parallel/
  write site exercises (dead scope, the KTPU503/505 analogue).
* **KTPU506** — unit mismatch at a write site: a cataloged metric whose
  name declares its unit (``*_seconds[_total]`` / ``*_bytes[_total]``)
  is fed a value that carries the wrong one — a ``*_ms`` name with no
  ``/ 1000`` conversion in the expression (milliseconds exported as
  seconds are off by 1000x on every dashboard), or ``len()`` of a str
  for a bytes metric (characters, not bytes — encode first).  Values
  are resolved one level through local assignments, the same
  local-dataflow depth as KTPU204.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from .core import Context, Finding, SourceFile, register

WRITE_METHODS = {'inc', 'observe', 'set_gauge', 'clear_gauge',
                 'register_histogram'}

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = os.path.join(REPO_ROOT, 'kyverno_tpu_torch')
CATALOG_PATH = os.path.join(PACKAGE, 'observability', 'catalog.py')

#: catalog entries with no write site in the tree that are legitimately
#: alive — the ONLY names the dead-metric pass may skip, each with the
#: reason it is allowed to exist without an emitter
DEAD_METRIC_ALLOWLIST = {
    'kyverno_client_queries_total':
        'reserved for a real cluster client transport (dclient '
        'interface exists; the in-memory fake does not emit queries)',
    'kyverno_tpu_metric_series_dropped_total':
        'written by the registry cardinality guard itself '
        '(metrics.py:_admit) through direct series access — an inc() '
        'there would recurse into the guard',
}


def _module_constants(tree: ast.Module) -> Dict[str, str]:
    """UPPER_CASE module-level string assignments (metric name consts)."""
    consts: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id.isupper():
                    consts[target.id] = node.value.value
    return consts


def _consts(sf: SourceFile) -> Dict[str, str]:
    """Per-file memo of ``_module_constants`` — several collectors and
    passes re-read the same files, and the constant map never changes
    within a run."""
    cached = getattr(sf, '_catalog_consts', None)
    if cached is None:
        cached = _module_constants(sf.tree)
        sf._catalog_consts = cached
    return cached


def _write_sites(ctx: Context):
    return ctx.cached('catalog:writes',
                      lambda: collect_from_files(ctx.files))


def _span_sites(ctx: Context):
    return ctx.cached('catalog:spans',
                      lambda: collect_span_sites(ctx.files))


def collect_from_files(files: List[SourceFile]
                       ) -> Tuple[List[Tuple[SourceFile, int, str]],
                                  List[Tuple[SourceFile, int, str]]]:
    """(resolved [(file, line, metric_name)], unresolved
    [(file, line, description)]) across a parsed file set."""
    all_consts: Dict[str, str] = {}
    for sf in files:
        if sf.tree is not None:
            all_consts.update(_consts(sf))
    resolved: List[Tuple[SourceFile, int, str]] = []
    unresolved: List[Tuple[SourceFile, int, str]] = []
    for sf in files:
        if sf.tree is None:
            continue
        local_consts = _consts(sf)
        for node in sf.walk():
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute) and
                    node.func.attr in WRITE_METHODS and node.args):
                continue
            arg = node.args[0]
            name: Optional[str] = None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                name = arg.value
            elif isinstance(arg, ast.Name):
                name = local_consts.get(arg.id, all_consts.get(arg.id))
            elif isinstance(arg, ast.Attribute):
                # module.CONST spelling: resolve by attribute name
                name = all_consts.get(arg.attr)
            if name is None:
                unresolved.append((sf, node.lineno, ast.dump(arg)[:80]))
            else:
                resolved.append((sf, node.lineno, name))
    return resolved, unresolved


def load_catalog() -> Dict[str, Tuple[str, str]]:
    from ..observability.catalog import METRICS
    return {name: (m.type, m.help) for name, m in METRICS.items()}


@register('KTPU501', 'metric write site with a name missing from '
                     'observability/catalog.py')
def _check_uncataloged(ctx: Context) -> Iterable[Finding]:
    catalog = load_catalog()
    resolved, _unresolved = _write_sites(ctx)
    for sf, line, name in resolved:
        if name not in catalog:
            yield sf.finding(
                'KTPU501', line,
                f'metric {name!r} is not in observability/catalog.py '
                f'— catalog it with a type and help text')


@register('KTPU502', 'metric write site whose name is not a literal '
                     'or module constant (uncheckable)')
def _check_unresolved(ctx: Context) -> Iterable[Finding]:
    _resolved, unresolved = _write_sites(ctx)
    for sf, line, desc in unresolved:
        yield sf.finding(
            'KTPU502', line,
            f'metric name is not a literal or module constant '
            f'({desc}) — uncheckable, use a constant')


def stale_allowlist_entries(catalog, used) -> List[Tuple[str, str]]:
    """(name, problem) per DEAD_METRIC_ALLOWLIST entry that no longer
    excuses anything: the metric gained a write site (the common case
    when a reserved metric's subsystem finally lands) or fell out of
    the catalog entirely."""
    out: List[Tuple[str, str]] = []
    for name in sorted(DEAD_METRIC_ALLOWLIST):
        if name not in catalog:
            out.append((name, 'names a metric absent from the catalog'))
        elif name in used:
            out.append((name, 'has a write site now — the metric is '
                              'catalog-checked like any other'))
    return out


@register('KTPU503', 'dead metric: cataloged name with no write site '
                     'in the tree (or stale allowlist entry)')
def _check_dead_metrics(ctx: Context) -> Iterable[Finding]:
    catalog = load_catalog()
    resolved, _unresolved = _write_sites(ctx)
    used = {name for _sf, _l, name in resolved}
    anchor = ctx.by_rel('kyverno_tpu_torch/observability/catalog.py')

    def locate(name):
        target = anchor if anchor is not None else ctx.files[0]
        line = 1
        if anchor is not None:
            for i, text in enumerate(anchor.lines, start=1):
                if f"'{name}'" in text:
                    line = i
                    break
        return target, line

    for name in sorted(catalog):
        if name in used or name in DEAD_METRIC_ALLOWLIST:
            continue
        target, line = locate(name)
        yield target.finding(
            'KTPU503', line,
            f'catalog: {name} has no write site in the tree — remove '
            f'the entry, add the emitter, or allowlist it with a '
            f'reason (DEAD_METRIC_ALLOWLIST)')
    for name, problem in stale_allowlist_entries(catalog, used):
        target, line = locate(name)
        yield target.finding(
            'KTPU503', line,
            f'DEAD_METRIC_ALLOWLIST: {name} {problem} — drop the '
            f'stale allowlist entry')


# -- span catalog (KTPU504/505) ----------------------------------------------

def load_span_catalog() -> Dict[str, str]:
    from ..observability.catalog import SPANS
    return dict(SPANS)


def _fstring_prefix(node: ast.JoinedStr) -> str:
    """Leading literal text of an f-string span name — the checkable
    part of a templated name like ``f'webhooks{path}'``."""
    prefix = ''
    for part in node.values:
        if isinstance(part, ast.Constant) and isinstance(part.value, str):
            prefix += part.value
        else:
            break
    return prefix


def collect_span_sites(files: List[SourceFile]
                       ) -> Tuple[List[Tuple[SourceFile, int, str]],
                                  List[Tuple[SourceFile, int, str]],
                                  List[Tuple[SourceFile, int, str]]]:
    """Span start sites across a parsed file set: (exact
    [(file, line, name)], dynamic [(file, line, prefix)], unresolved
    [(file, line, description)]).

    ``start_span(<name>)`` sites contribute the name directly; device
    ``stage('<s>')`` timers contribute ``kyverno/device/<s>`` (the
    generic ``f'kyverno/device/{name}'`` start inside ``stage`` itself
    lands in the dynamic set)."""
    all_consts: Dict[str, str] = {}
    for sf in files:
        if sf.tree is not None:
            all_consts.update(_consts(sf))
    exact: List[Tuple[SourceFile, int, str]] = []
    dynamic: List[Tuple[SourceFile, int, str]] = []
    unresolved: List[Tuple[SourceFile, int, str]] = []
    for sf in files:
        if sf.tree is None:
            continue
        local_consts = _consts(sf)
        for node in sf.walk():
            if not (isinstance(node, ast.Call) and node.args):
                continue
            func = node.func
            attr = func.attr if isinstance(func, ast.Attribute) else \
                (func.id if isinstance(func, ast.Name) else '')
            if attr not in ('start_span', 'stage'):
                continue
            arg = node.args[0]
            name: Optional[str] = None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                name = arg.value
            elif isinstance(arg, ast.Name):
                name = local_consts.get(arg.id, all_consts.get(arg.id))
            elif isinstance(arg, ast.JoinedStr):
                prefix = _fstring_prefix(arg)
                if attr == 'stage':
                    prefix = 'kyverno/device/' + prefix
                dynamic.append((sf, node.lineno, prefix))
                continue
            if name is None:
                # a `stage` param (def stage(name...)) has no literal —
                # only calls matter, and non-constant args through a
                # variable are uncheckable
                unresolved.append((sf, node.lineno, ast.dump(arg)[:80]))
                continue
            if attr == 'stage':
                name = 'kyverno/device/' + name
            exact.append((sf, node.lineno, name))
    return exact, dynamic, unresolved


@register('KTPU504', 'span start site with a name missing from the '
                     'span catalog (observability/catalog.py SPANS) '
                     'or unresolvable')
def _check_uncataloged_spans(ctx: Context) -> Iterable[Finding]:
    catalog = load_span_catalog()
    exact, dynamic, unresolved = _span_sites(ctx)
    for sf, line, name in exact:
        if name not in catalog:
            yield sf.finding(
                'KTPU504', line,
                f'span {name!r} is not in the span catalog '
                f'(observability/catalog.py SPANS) — catalog it with '
                f'help text')
    for sf, line, prefix in dynamic:
        if not prefix or not any(s.startswith(prefix) for s in catalog):
            yield sf.finding(
                'KTPU504', line,
                f'dynamic span name with prefix {prefix!r} matches no '
                f'span catalog entry — catalog a templated name '
                f'(e.g. "{prefix}<...>")')
    for sf, line, desc in unresolved:
        yield sf.finding(
            'KTPU504', line,
            f'span name is not a literal, module constant, or '
            f'f-string ({desc}) — uncheckable, use a constant')


@register('KTPU505', 'dead span: cataloged span name with no start '
                     'site in the tree')
def _check_dead_spans(ctx: Context) -> Iterable[Finding]:
    catalog = load_span_catalog()
    exact, dynamic, _unresolved = _span_sites(ctx)
    used = {name for _sf, _l, name in exact}
    for _sf, _l, prefix in dynamic:
        if prefix:
            used |= {s for s in catalog if s.startswith(prefix)}
    anchor = ctx.by_rel('kyverno_tpu_torch/observability/catalog.py')

    def locate(name):
        target = anchor if anchor is not None else ctx.files[0]
        line = 1
        if anchor is not None:
            for i, text in enumerate(anchor.lines, start=1):
                if f"'{name}'" in text:
                    line = i
                    break
        return target, line

    for name in sorted(catalog):
        if name in used:
            continue
        target, line = locate(name)
        yield target.finding(
            'KTPU505', line,
            f'span catalog: {name!r} has no start site in the tree — '
            f'remove the entry or add the span')


# -- fleet-scope hygiene (KTPU509) --------------------------------------------

def load_fleet_scopes() -> Dict[str, str]:
    """Cataloged metrics that declare a ``fleet_scope`` — the identity
    label key every write site must pass so cross-host federation can
    tell the series apart."""
    from ..observability.catalog import METRICS
    return {name: m.fleet_scope for name, m in METRICS.items()
            if getattr(m, 'fleet_scope', '')}


def collect_labeled_writes(files: List[SourceFile]
                           ) -> List[Tuple[SourceFile, int, str,
                                           Optional[frozenset]]]:
    """Resolved metric write sites with the label keys they pass:
    ``[(file, line, metric_name, label_keys)]``.  ``label_keys`` is
    None when the site splats ``**labels`` (uncheckable keys)."""
    all_consts: Dict[str, str] = {}
    for sf in files:
        if sf.tree is not None:
            all_consts.update(_consts(sf))
    sites: List[Tuple[SourceFile, int, str, Optional[frozenset]]] = []
    for sf in files:
        if sf.tree is None:
            continue
        local_consts = _consts(sf)
        for node in sf.walk():
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute) and
                    node.func.attr in WRITE_METHODS and node.args):
                continue
            arg = node.args[0]
            name: Optional[str] = None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                name = arg.value
            elif isinstance(arg, ast.Name):
                name = local_consts.get(arg.id, all_consts.get(arg.id))
            elif isinstance(arg, ast.Attribute):
                name = all_consts.get(arg.attr)
            if name is None:
                continue  # KTPU502's finding, not ours
            keys: Optional[frozenset]
            if any(kw.arg is None for kw in node.keywords):
                keys = None  # **labels splat — keys unknowable
            else:
                keys = frozenset(kw.arg for kw in node.keywords)
            sites.append((sf, node.lineno, name, keys))
    return sites


@register('KTPU509', 'fleet-scope hygiene: a parallel/ metric write '
                     'with no shard/host identity scope, a scoped '
                     'write missing its identity label, or a dead '
                     'fleet_scope')
def _check_fleet_scope(ctx: Context) -> Iterable[Finding]:
    scopes = load_fleet_scopes()
    sites = ctx.cached('catalog:labeled',
                       lambda: collect_labeled_writes(ctx.files))
    exercised: set = set()
    for sf, line, name, keys in sites:
        rel = '/' + sf.rel.replace(os.sep, '/')
        in_parallel = '/parallel/' in rel
        scope = scopes.get(name)
        if in_parallel:
            if scope is None:
                yield sf.finding(
                    'KTPU509', line,
                    f'metric {name!r} is written from parallel/ but '
                    f'declares no fleet_scope in the catalog — '
                    f'without a shard/host identity label the '
                    f'cross-host federation merges every process '
                    f'into one series')
                continue
            exercised.add(name)
        if scope is not None and keys is not None and scope not in keys:
            yield sf.finding(
                'KTPU509', line,
                f'metric {name!r} declares fleet_scope='
                f'{scope!r} but this write site passes no '
                f'{scope}=... label — the federated series from '
                f'different shards/meshes would collide')
    anchor = ctx.by_rel('kyverno_tpu_torch/observability/catalog.py')

    def locate(name):
        target = anchor if anchor is not None else ctx.files[0]
        line = 1
        if anchor is not None:
            for i, text in enumerate(anchor.lines, start=1):
                if f"'{name}'" in text:
                    line = i
                    break
        return target, line

    for name in sorted(scopes):
        if name in exercised:
            continue
        target, line = locate(name)
        yield target.finding(
            'KTPU509', line,
            f'catalog: {name} declares fleet_scope='
            f'{scopes[name]!r} but no parallel/ write site exercises '
            f'it — drop the scope or move the emitter onto the mesh '
            f'path')


# -- pipeline stage registry (KTPU507) ----------------------------------------

def load_stage_registry() -> Dict[str, str]:
    from ..observability.catalog import PIPELINE_STAGES
    return dict(PIPELINE_STAGES)


def collect_stage_labels(files: List[SourceFile]
                         ) -> List[Tuple[SourceFile, int, str]]:
    """Pipeline stage-label sites across a parsed file set:
    ``stage('<s>')`` timers, ``add_backpressure('<s>', ...)``
    attributions, ``exec_scope(tl, c, '<s>')`` inline wrappers, and the
    literal ``(name, fn)`` stage lists handed to ``ChunkPipeline``.
    Non-literal labels are skipped (variables flow from these same
    literal surfaces)."""
    sites: List[Tuple[SourceFile, int, str]] = []
    for sf in files:
        if sf.tree is None:
            continue
        for node in sf.walk():
            if not (isinstance(node, ast.Call) and node.args):
                continue
            func = node.func
            attr = func.attr if isinstance(func, ast.Attribute) else \
                (func.id if isinstance(func, ast.Name) else '')
            if attr in ('stage', 'add_backpressure'):
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str):
                    sites.append((sf, node.lineno, arg.value))
            elif attr == 'exec_scope' and len(node.args) >= 3:
                arg = node.args[2]
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str):
                    sites.append((sf, node.lineno, arg.value))
            elif attr == 'ChunkPipeline':
                arg = node.args[0]
                if isinstance(arg, (ast.List, ast.Tuple)):
                    for elt in arg.elts:
                        if isinstance(elt, ast.Tuple) and elt.elts and \
                                isinstance(elt.elts[0], ast.Constant) and \
                                isinstance(elt.elts[0].value, str):
                            sites.append((sf, elt.lineno,
                                          elt.elts[0].value))
    return sites


@register('KTPU507', 'pipeline stage label in compiler/ missing from '
                     'the stage registry (catalog PIPELINE_STAGES), '
                     'or a registered stage no code uses')
def _check_stage_labels(ctx: Context) -> Iterable[Finding]:
    registry = load_stage_registry()
    sites = collect_stage_labels(ctx.files)
    for sf, line, label in sites:
        if label in registry:
            continue
        rel = '/' + sf.rel.replace(os.sep, '/')
        if '/compiler/' in rel:
            yield sf.finding(
                'KTPU507', line,
                f'stage label {label!r} is not a registered pipeline '
                f'stage (observability/catalog.py PIPELINE_STAGES) — '
                f'register it, or the timeline critical-path walk and '
                f'the blame metric silently drop its intervals')
    used = {label for _sf, _l, label in sites}
    anchor = ctx.by_rel('kyverno_tpu_torch/observability/catalog.py')

    def locate(name):
        target = anchor if anchor is not None else ctx.files[0]
        line = 1
        if anchor is not None:
            for i, text in enumerate(anchor.lines, start=1):
                if f"'{name}'" in text:
                    line = i
                    break
        return target, line

    for name in sorted(registry):
        if name in used:
            continue
        target, line = locate(name)
        yield target.finding(
            'KTPU507', line,
            f'stage registry: {name!r} has no stage()/exec_scope/'
            f'ChunkPipeline/add_backpressure site in the tree — '
            f'remove the entry or add the stage')


# -- unit-mismatch pass (KTPU506) ---------------------------------------------

#: registry writes that carry a measured value (register_histogram
#: takes buckets, clear_gauge takes nothing — neither can mismatch)
_VALUE_METHODS = {'inc', 'observe', 'set_gauge'}


def _metric_unit(name: str) -> Optional[str]:
    """'seconds' | 'bytes' when the metric name declares a unit."""
    base = name[:-len('_total')] if name.endswith('_total') else name
    if base.endswith('_seconds'):
        return 'seconds'
    if base.endswith('_bytes'):
        return 'bytes'
    return None


def _iter_scopes(tree: ast.Module):
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _scope_nodes(scope: ast.AST):
    """Every node in ``scope`` excluding nested function bodies (each
    nested function is visited as its own scope)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _value_arg(call: ast.Call) -> Optional[ast.AST]:
    if len(call.args) >= 2:
        return call.args[1]
    for kw in call.keywords:
        if kw.arg in ('value', 'amount', 'seconds'):
            return kw.value
    return None  # inc() with the implicit 1.0 — no unit to carry


def _ms_name(expr: ast.AST) -> Optional[str]:
    """A terminal ``*_ms`` name/attribute inside ``expr``, if any."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id.endswith('_ms'):
            return node.id
        if isinstance(node, ast.Attribute) and node.attr.endswith('_ms'):
            return node.attr
    return None


def _has_ms_conversion(expr: ast.AST) -> bool:
    """True when ``expr`` contains a ms→s conversion (``/ 1000`` or
    ``* 0.001`` against a constant)."""
    for node in ast.walk(expr):
        if not isinstance(node, ast.BinOp):
            continue
        if isinstance(node.op, ast.Div) and \
                isinstance(node.right, ast.Constant) and \
                node.right.value in (1000, 1000.0):
            return True
        if isinstance(node.op, ast.Mult):
            for side in (node.left, node.right):
                if isinstance(side, ast.Constant) and \
                        side.value == 0.001:
                    return True
    return False


def _is_str_expr(expr: ast.AST) -> bool:
    """Conservatively: does ``expr`` evaluate to a str?"""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str)
    if isinstance(expr, ast.JoinedStr):
        return True
    if isinstance(expr, ast.Call):
        f = expr.func
        if isinstance(f, ast.Name) and f.id in ('str', 'repr'):
            return True
        if isinstance(f, ast.Attribute) and \
                f.attr in ('decode', 'dumps', 'format', 'join'):
            return True
    return False


def _str_len_call(expr: ast.AST, bindings: Dict[str, ast.AST]
                  ) -> bool:
    """``len(<str-valued expression>)`` anywhere in ``expr``, with the
    len argument resolved one level through local assignments."""
    for node in ast.walk(expr):
        if not (isinstance(node, ast.Call) and
                isinstance(node.func, ast.Name) and
                node.func.id == 'len' and node.args):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Name):
            arg = bindings.get(arg.id, arg)
        if _is_str_expr(arg):
            return True
    return False


@register('KTPU506', 'unit mismatch: a *_seconds/*_bytes metric '
                     'written from a *_ms value (no /1000) or a '
                     'len() of a str')
def _check_unit_mismatch(ctx: Context) -> Iterable[Finding]:
    from .retrace import _scope_bindings
    all_consts: Dict[str, str] = {}
    for sf in ctx.files:
        if sf.tree is not None:
            all_consts.update(_consts(sf))
    for sf in ctx.files:
        if sf.tree is None:
            continue
        local_consts = _consts(sf)

        def _unit_of(node):
            arg = node.args[0]
            name: Optional[str] = None
            if isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str):
                name = arg.value
            elif isinstance(arg, ast.Name):
                name = local_consts.get(arg.id, all_consts.get(arg.id))
            elif isinstance(arg, ast.Attribute):
                name = all_consts.get(arg.attr)
            return (name, _metric_unit(name)
                    if name is not None else None)

        # cheap pre-filter off the per-file node index: the expensive
        # per-scope binding walk only runs for the handful of files
        # that write a unit-suffixed metric at all
        if not any(isinstance(n.func, ast.Attribute) and
                   n.func.attr in _VALUE_METHODS and n.args and
                   _unit_of(n)[1] is not None
                   for n in sf.nodes_of(ast.Call)):
            continue
        for scope in _iter_scopes(sf.tree):
            bindings = _scope_bindings(scope)
            for node in _scope_nodes(scope):
                if not (isinstance(node, ast.Call) and
                        isinstance(node.func, ast.Attribute) and
                        node.func.attr in _VALUE_METHODS and node.args):
                    continue
                name, unit = _unit_of(node)
                if unit is None:
                    continue
                value = _value_arg(node)
                if value is None:
                    continue
                # one-level local-dataflow resolution (KTPU204 depth):
                # a bare name checks its own spelling AND what it was
                # assigned from in this scope
                exprs = [value]
                if isinstance(value, ast.Name):
                    resolved = bindings.get(value.id)
                    if resolved is not None:
                        exprs.append(resolved)
                if unit == 'seconds':
                    for expr in exprs:
                        ms = _ms_name(expr)
                        if ms is not None and \
                                not any(_has_ms_conversion(e)
                                        for e in exprs):
                            yield sf.finding(
                                'KTPU506', node.lineno,
                                f'{name} is a seconds metric but its '
                                f'value derives from {ms!r} with no '
                                f'/1000 conversion — milliseconds '
                                f'exported as seconds are off by '
                                f'1000x on every consumer')
                            break
                elif unit == 'bytes':
                    if any(_str_len_call(e, bindings) for e in exprs):
                        yield sf.finding(
                            'KTPU506', node.lineno,
                            f'{name} is a bytes metric but its value '
                            f'is len() of a str — that counts '
                            f'characters, not bytes; len(s.encode()) '
                            f'measures the wire size')


# -- partition key-hygiene pass (KTPU508) -------------------------------------

def _fingerprint_arg(call: ast.Call) -> Optional[ast.AST]:
    """The fingerprint operand of an ``executable_cache_key`` call
    (first positional, or the ``fingerprint=`` keyword)."""
    for kw in call.keywords:
        if kw.arg == 'fingerprint':
            return kw.value
    if call.args:
        return call.args[0]
    return None


def _contains_set_fingerprint(expr: ast.AST) -> bool:
    from .retrace import _callee_name
    return any(isinstance(n, ast.Call) and
               _callee_name(n.func) == 'policy_set_fingerprint'
               for n in ast.walk(expr))


@register('KTPU508', 'compile/AOT key construction outside partition/ '
                     'consumes the whole-set fingerprint '
                     '(policy_set_fingerprint) — one policy edit would '
                     'invalidate every partition\'s executables')
def _check_partition_key_hygiene(ctx: Context) -> Iterable[Finding]:
    """``executable_cache_key`` callers must take their fingerprint
    from ``partition/keys.compile_fingerprint`` (which scopes it to the
    policies actually compiled into the evaluator), never directly from
    ``policy_set_fingerprint`` over the whole set — that spelling works
    until the first partitioned build, then silently degrades every
    policy edit back to a recompile-the-world.  ``partition/`` itself
    is the sanctioned authority and is exempt.  The fingerprint operand
    resolves one level through enclosing-scope bindings (KTPU204
    depth), innermost scope first — the binding feeding a nested
    closure's name may live in the enclosing builder function
    (``ops/eval.py:build_evaluator``)."""
    from .retrace import _callee_name, _scope_bindings
    for sf in ctx.files:
        if sf.tree is None:
            continue
        rel = '/' + sf.rel.replace(os.sep, '/')
        if '/partition/' in rel:
            continue
        sites: List[Tuple[List[ast.AST], ast.Call]] = []

        def visit(node: ast.AST, chain: List[ast.AST]) -> None:
            for child in ast.iter_child_nodes(node):
                inner = chain
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    inner = chain + [child]
                if isinstance(child, ast.Call) and \
                        _callee_name(child.func) == \
                        'executable_cache_key':
                    sites.append((chain, child))
                visit(child, inner)

        visit(sf.tree, [sf.tree])
        for chain, call in sites:
            expr = _fingerprint_arg(call)
            if expr is None:
                continue
            if isinstance(expr, ast.Name):
                resolved = None
                for scope in reversed(chain):
                    resolved = _scope_bindings(scope).get(expr.id)
                    if resolved is not None:
                        break
                if resolved is None:
                    continue  # parameter / out-of-scope: undecidable
                expr = resolved
            if _contains_set_fingerprint(expr):
                yield sf.finding(
                    'KTPU508', call,
                    'executable cache key consumes the whole-set '
                    'fingerprint (policy_set_fingerprint) outside '
                    'partition/ — draw it from '
                    'partition/keys.compile_fingerprint so partitioned '
                    'builds key executables per partition')


def render_span_table() -> str:
    """The README span table, generated from the catalog so docs
    cannot drift from it (mirrors the knob table)."""
    rows = ['| Span | Covers |', '|---|---|']
    catalog = load_span_catalog()
    for name in sorted(catalog):
        rows.append(f'| `{name}` | {catalog[name]} |')
    return '\n'.join(rows)


# -- standalone checker API --------------------------------------------------

def default_sources() -> List[str]:
    """The checker file set, rooted at the repo — one list
    (``core.DEFAULT_SOURCE_PATHS``) shared with the lint driver
    (``python -m kyverno_tpu_torch.analysis``) so the standalone
    catalog checker and the driver can't drift."""
    from .core import DEFAULT_SOURCE_PATHS
    return [os.path.join(REPO_ROOT, p) for p in DEFAULT_SOURCE_PATHS]


def collect_call_sites() -> Tuple[List[Tuple[str, int, str]],
                                  List[Tuple[str, int, str]]]:
    """Original shim signature: (resolved [(relpath, line, name)],
    unresolved [(relpath, line, desc)]), walking the real tree fresh
    on every call."""
    from .core import collect_files
    files = collect_files(default_sources(), REPO_ROOT)
    resolved, unresolved = collect_from_files(files)
    return ([(sf.rel, line, name) for sf, line, name in resolved],
            [(sf.rel, line, desc) for sf, line, desc in unresolved])


def check_main() -> int:
    """Exit-code semantics of the original standalone checker."""
    catalog = load_catalog()
    resolved, unresolved = collect_call_sites()
    errors: List[str] = []
    for name, (mtype, mhelp) in catalog.items():
        if mtype not in ('counter', 'gauge', 'histogram'):
            errors.append(f'catalog: {name} has invalid type {mtype!r}')
        if not mhelp.strip():
            errors.append(f'catalog: {name} has empty help text')
    used = {name for _r, _l, name in resolved}
    for rel, line, name in resolved:
        if name not in catalog:
            errors.append(
                f'{rel}:{line}: metric {name!r} not in '
                f'observability/catalog.py')
    for rel, line, desc in unresolved:
        errors.append(
            f'{rel}:{line}: metric name is not a literal or module '
            f'constant ({desc}) — uncheckable, use a constant')
    for name in catalog:
        if name not in used and name not in DEAD_METRIC_ALLOWLIST:
            errors.append(
                f'catalog: {name} has no write site in the tree — '
                f'remove the entry, add the emitter, or allowlist it '
                f'with a reason (DEAD_METRIC_ALLOWLIST)')
    for name, problem in stale_allowlist_entries(catalog, used):
        errors.append(f'DEAD_METRIC_ALLOWLIST: {name} {problem} — '
                      f'drop the stale allowlist entry')
    if not resolved:
        errors.append('no metric call sites found — checker is broken')
    if errors:
        for e in errors:
            print(e, file=sys.stderr)
        return 1
    print(f'ok: {len(resolved)} call sites over {len(used)} metrics, '
          f'{len(catalog)} cataloged')
    return 0
