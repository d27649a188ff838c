"""Precompiled appliers for the common bulk-mutation shapes.

The engine's generic mutate loop re-substitutes and re-walks the rule
tree per (resource, element) — correct, but 10-20x more host work than
the mutation itself on dump-scale applies (BASELINE config 5).  This
module compiles the three dominant shapes into direct appliers:

* static ``patchStrategicMerge`` overlays of nested dicts with scalar
  leaves and ``+(key)`` add-if-absent anchors
* static ``patchesJson6902`` add/replace ops on object paths
* single-entry ``foreach`` over a resource list with simple per-element
  preconditions and a merge-by-name strategic overlay whose only
  variable is the ``{{element.name}}`` self-reference

Everything else returns ``None`` and the caller keeps the engine loop.
Appliers may also return :data:`FALLBACK` per resource when the live
document's shape leaves the compiled fast path (e.g. a non-dict where
the overlay expects a map) — the caller re-runs that resource through
the engine, so results are bit-identical by construction
(tests/test_mutate_compile.py pins equality on randomized docs;
reference semantics: pkg/engine/mutate/patch/strategicMergePatch.go,
patchJSON6902.go, mutation.go ForEach).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..engine import operators
from ..engine.api import RuleStatus
from ..engine.jmespath import compile as jp_compile
from ..engine.mutate.mutate import _success_message
from ..engine.variables import RE_VARIABLE_INIT, tree_has_variables
from ..observability import coverage
from ..observability.coverage import (REASON_DUP_ELEMENT_NAMES,
                                      REASON_NON_DICT,
                                      REASON_PRECONDITION_ESCAPE,
                                      REASON_REPLACE_PATH_MISSING)

#: sentinel: this resource's shape left the compiled fast path
FALLBACK = object()


def _fallback(reason: str, rule_name: str = '', policy_name: str = ''):
    """Record one attributed fast-path escape on the coverage ledger
    (``kyverno_tpu_host_fallback_total{path="mutate", reason=...}``; a
    no-op until coverage.configure) and return the shared FALLBACK
    sentinel — callers and tests compare by identity."""
    coverage.record_fallback('mutate', reason, policy=policy_name,
                             rule=rule_name)
    return FALLBACK

_ADD_ANCHOR_RE = re.compile(r'^\+\((.+)\)$')


def _static(node) -> bool:
    """No {{...}} variables / $() references anywhere in the tree —
    the engine's own predicate, shared so the fast-mutate compiler can
    never drift from substitution semantics."""
    return not tree_has_variables(node)


class CompiledMutation:
    """One rule's fast applier: ``apply(doc) -> (status, message,
    changed, patched) | FALLBACK``."""

    __slots__ = ('apply',)

    def __init__(self, apply_fn):
        self.apply = apply_fn


# -- static strategic merge (dict paths) ------------------------------------

def _compile_overlay(overlay: Any) -> Optional[List[Tuple[Tuple[str, ...],
                                                          bool, Any]]]:
    """Flatten a static dict overlay into (path, add_only, value) sets;
    None when the shape is outside the fast vocabulary."""
    if not isinstance(overlay, dict) or not _static(overlay):
        return None
    out: List[Tuple[Tuple[str, ...], bool, Any]] = []

    def walk(node: dict, path: Tuple[str, ...]) -> bool:
        for key, value in node.items():
            if not isinstance(key, str):
                return False
            add_only = False
            m = _ADD_ANCHOR_RE.match(key)
            if m:
                add_only = True
                key = m.group(1)
            elif '(' in key or ')' in key:
                return False  # conditional/equality/global anchors
            if isinstance(value, dict):
                if add_only:
                    return False  # +() on maps: engine semantics differ
                if not walk(value, path + (key,)):
                    return False
            elif isinstance(value, (list,)):
                return False
            else:
                out.append((path + (key,), add_only, value))
        return True

    if not walk(overlay, ()):
        return None
    return out


def _apply_sets(doc: dict, sets: List[Tuple[Tuple[str, ...], bool, Any]],
                rule_name: str = '', policy_name: str = ''):
    """Copy-on-write application of flattened scalar sets; returns
    (changed, patched) or FALLBACK on a non-dict intermediate.  Every
    escape is attributed on the coverage ledger at its decision site —
    the three returns below each name their reason via ``_fallback`` —
    so callers propagate the sentinel without re-recording."""
    changes = []
    for path, add_only, value in sets:
        cur: Any = doc
        for part in path[:-1]:
            if not isinstance(cur, dict):
                # the overlay path descends through a non-map value
                return _fallback(REASON_NON_DICT, rule_name, policy_name)
            cur = cur.get(part)
            if cur is None:
                break
        leaf = path[-1]
        if cur is None:
            # missing intermediate maps: the merge creates the path
            changes.append((path, value))
            continue
        if not isinstance(cur, dict):
            # the leaf's parent container is a non-map value
            return _fallback(REASON_NON_DICT, rule_name, policy_name)
        if leaf in cur:
            if not add_only and cur[leaf] != value:
                changes.append((path, value))
        else:
            changes.append((path, value))
    if not changes:
        return False, doc
    patched = apply_edit_list(doc, changes)
    if patched is None:
        # copy-on-write hit a non-map while rebuilding the path
        return _fallback(REASON_NON_DICT, rule_name, policy_name)
    return True, patched


def apply_edit_list(doc: dict,
                    changes: List[Tuple[Tuple[str, ...], Any]]):
    """Copy-on-write application of a DECIDED (path, value) edit list —
    the patch phase shared by ``_apply_sets`` and the device-mutate
    decode (``kyverno_tpu/mutate/scanner.py``, which reads the edit
    bitmask back from the device and materializes it here).  Returns
    the patched document, or None when a non-map parent appears while
    rebuilding a path (callers attribute the escape)."""
    if not changes:
        return doc
    patched = dict(doc)
    copied: Dict[Tuple[str, ...], dict] = {(): patched}

    def cow(path: Tuple[str, ...]) -> Any:
        node = copied.get(path)
        if node is not None:
            return node
        parent = cow(path[:-1])
        if not isinstance(parent, dict):
            return None
        child = parent.get(path[-1])
        child = dict(child) if isinstance(child, dict) else {}
        parent[path[-1]] = child
        copied[path] = child
        return child

    for path, value in changes:
        parent = cow(path[:-1])
        if parent is None:
            return None
        parent[path[-1]] = value
    return patched


def compile_strategic_merge(overlay: Any, rule_name: str = '',
                            policy_name: str = ''
                            ) -> Optional[CompiledMutation]:
    sets = _compile_overlay(overlay)
    if sets is None:
        return None

    def apply(doc: dict):
        result = _apply_sets(doc, sets, rule_name, policy_name)
        if result is FALLBACK:
            return result  # attributed at the _apply_sets decision site
        changed, patched = result
        if not changed:
            return (RuleStatus.SKIP, 'no patches applied', False, doc)
        return (RuleStatus.PASS, _success_message(patched), True, patched)

    return CompiledMutation(apply)


# -- static json6902 --------------------------------------------------------

def parse_json6902_sets(patch_text: Any):
    """``(sets, replace_paths)`` for a static add/replace object-path
    json6902 patch, or None when the shape leaves the fast vocabulary
    (array indexes, other ops, variables, unparseable text).  Shared by
    :func:`compile_json6902` and the device-mutate lowering
    (``kyverno_tpu/mutate/plan.py``) so the two paths can never accept
    different patch grammars."""
    from ..engine.mutate.mutate import _load_patches_cached
    if not isinstance(patch_text, str) or '{{' in patch_text:
        return None
    try:
        ops = _load_patches_cached(patch_text)
    except Exception:  # noqa: BLE001 - engine reports the parse error
        return None
    sets: List[Tuple[Tuple[str, ...], bool, Any]] = []
    replace_paths: List[Tuple[str, ...]] = []
    for op in ops:
        op_name = (op or {}).get('op')
        if op_name not in ('add', 'replace'):
            return None
        path = str(op.get('path', ''))
        parts = tuple(p.replace('~1', '/').replace('~0', '~')
                      for p in path.split('/') if p)
        if not parts or any(p.isdigit() or p == '-' for p in parts):
            return None  # array-index ops keep the engine path
        if not _static(op.get('value')):
            return None
        if op_name == 'replace':
            replace_paths.append(parts)
        sets.append((parts, False, op.get('value')))
    return sets, replace_paths


def compile_json6902(patch_text: Any, rule_name: str = '',
                     policy_name: str = '') -> Optional[CompiledMutation]:
    parsed = parse_json6902_sets(patch_text)
    if parsed is None:
        return None
    sets, replace_paths = parsed

    def apply(doc: dict):
        # `replace` requires the leaf AND every intermediate to exist —
        # the engine FAILs with "replace path not found"; only `add`
        # may create paths.  FALLBACK re-runs the engine for the exact
        # failure response.
        for parts in replace_paths:
            cur: Any = doc
            for part in parts:
                if not isinstance(cur, dict) or part not in cur:
                    return _fallback(REASON_REPLACE_PATH_MISSING,
                                     rule_name, policy_name)
                cur = cur[part]
        result = _apply_sets(doc, sets, rule_name, policy_name)
        if result is FALLBACK:
            return result  # attributed at the _apply_sets decision site
        changed, patched = result
        if not changed:
            return (RuleStatus.SKIP, 'no patches applied', False, doc)
        return (RuleStatus.PASS, _success_message(patched), True, patched)

    return CompiledMutation(apply)


# -- foreach ----------------------------------------------------------------

def _compile_element_conditions(conditions: Any) -> Optional[Callable]:
    """Per-element precondition evaluator for conditions whose keys are
    single {{element...}} JMESPath expressions and values are static."""
    if conditions is None:
        return lambda element: True
    blocks: List[Tuple[str, list]] = []
    if isinstance(conditions, dict):
        for mode in ('all', 'any'):
            if conditions.get(mode) is not None:
                blocks.append((mode, conditions[mode]))
    elif isinstance(conditions, list):
        blocks.append(('all', conditions))
    else:
        return None
    compiled_blocks = []
    for mode, conds in blocks:
        compiled = []
        for cond in conds or []:
            if not isinstance(cond, dict):
                return None
            key = cond.get('key')
            if not isinstance(key, str):
                return None
            stripped = key.strip()
            m = RE_VARIABLE_INIT.match(stripped)
            if not m or m.group(0) != stripped:
                return None  # key must be exactly one {{...}} variable
            expr = stripped[2:-2].strip()
            if 'element' not in expr:
                return None
            value = cond.get('value')
            if not _static(value) or not _static(cond.get('operator', '')):
                return None
            try:
                searcher = jp_compile(expr)
            except Exception:  # noqa: BLE001
                return None
            compiled.append((searcher, str(cond.get('operator', '')),
                             value))
        compiled_blocks.append((mode, compiled))

    def evaluate(element: Any) -> Optional[bool]:
        ctx = {'element': element}
        for mode, compiled in compiled_blocks:
            outcomes = []
            for searcher, op, value in compiled:
                try:
                    key_val = searcher.search(ctx)
                except Exception:  # noqa: BLE001 - engine decides
                    return None
                if key_val is None:
                    # the engine surfaces unresolved keys as substitution
                    # errors; anything null-ish leaves the fast path
                    return None
                outcomes.append(operators.evaluate(
                    None, {'key': key_val, 'operator': op,
                           'value': value}))
            if mode == 'all' and not all(outcomes):
                return False
            if mode == 'any' and outcomes and not any(outcomes):
                return False
        return True

    return evaluate


def compile_foreach(foreach_list: Any, rule: dict,
                    policy_name: str = '') -> Optional[CompiledMutation]:
    """Single-entry foreach over a list of named maps with an inner
    merge-by-name overlay (the imagePullPolicy shape)."""
    rule_name = str(rule.get('name', ''))
    if rule.get('preconditions') is not None or \
            not isinstance(foreach_list, list) or len(foreach_list) != 1:
        return None
    entry = foreach_list[0] or {}
    if entry.get('context') or entry.get('foreach') is not None or \
            entry.get('patchesJson6902') is not None:
        return None
    list_expr = entry.get('list', '')
    if not isinstance(list_expr, str) or '{{' in list_expr:
        return None
    if not list_expr.startswith('request.object.'):
        return None
    list_path = tuple(list_expr[len('request.object.'):].split('.'))
    cond_eval = _compile_element_conditions(entry.get('preconditions'))
    if cond_eval is None:
        return None
    overlay = entry.get('patchStrategicMerge')
    # expected shape: the list path mirrored with ONE element dict whose
    # merge key is name: "{{element.name}}" and static scalar sets
    node = overlay
    for part in list_path:
        if not isinstance(node, dict) or set(node) - {part}:
            return None
        node = node.get(part)
    if not isinstance(node, list) or len(node) != 1 or \
            not isinstance(node[0], dict):
        return None
    elem_overlay = dict(node[0])
    name_ref = elem_overlay.pop('name', None)
    if not isinstance(name_ref, str) or \
            name_ref.replace(' ', '') != '{{element.name}}':
        return None
    elem_sets = _compile_overlay(elem_overlay)
    if elem_sets is None:
        return None

    def apply(doc: dict):
        cur: Any = doc
        for part in list_path:
            if not isinstance(cur, dict):
                return _fallback(REASON_NON_DICT, rule_name, policy_name)
            cur = cur.get(part)
        if not isinstance(cur, list) or \
                not all(isinstance(e, dict) for e in cur):
            return _fallback(REASON_NON_DICT, rule_name, policy_name)
        # the engine's strategic merge matches overlay entries to list
        # elements BY NAME and coalesces duplicates onto the first
        # occurrence; the fast path patches elements independently, so
        # duplicate (or non-string) names must take the engine path
        names = [e.get('name') for e in cur]
        if any(not isinstance(n, str) for n in names) or \
                len(set(names)) != len(names):
            return _fallback(REASON_DUP_ELEMENT_NAMES, rule_name,
                             policy_name)
        new_list = None
        for i, element in enumerate(cur):
            passed = cond_eval(element)
            if passed is None:
                return _fallback(REASON_PRECONDITION_ESCAPE, rule_name,
                                 policy_name)
            if not passed:
                continue
            result = _apply_sets(element, elem_sets, rule_name, policy_name)
            if result is FALLBACK:
                return result  # attributed at the _apply_sets decision site
            changed, patched_elem = result
            if changed:
                if new_list is None:
                    new_list = list(cur)
                new_list[i] = patched_elem
        if new_list is None:
            # the engine's foreach reports PASS per processed entry even
            # without patches (mutation.go ForEach apply_count)
            return (RuleStatus.PASS, _success_message(doc), False, doc)
        patched = dict(doc)
        node: Any = patched
        for part in list_path[:-1]:
            child = dict(node[part])
            node[part] = child
            node = child
        node[list_path[-1]] = new_list
        return (RuleStatus.PASS, _success_message(patched), True, patched)

    return CompiledMutation(apply)


def compile_mutate_rule(rule: dict,
                        policy_name: str = '') -> Optional[CompiledMutation]:
    """Fast applier for one mutate rule, or None → engine loop.
    ``policy_name`` labels the applier's runtime FALLBACK attribution
    on the coverage ledger."""
    if rule.get('context') or rule.get('preconditions') is not None:
        return None
    mutation = rule.get('mutate') or {}
    if mutation.get('targets'):
        return None
    rule_name = str(rule.get('name', ''))
    if mutation.get('foreach') is not None:
        return compile_foreach(mutation['foreach'], rule, policy_name)
    if mutation.get('patchStrategicMerge') is not None:
        if mutation.get('patchesJson6902'):
            return None
        return compile_strategic_merge(mutation['patchStrategicMerge'],
                                       rule_name, policy_name)
    if mutation.get('patchesJson6902'):
        return compile_json6902(mutation['patchesJson6902'], rule_name,
                                policy_name)
    return None
