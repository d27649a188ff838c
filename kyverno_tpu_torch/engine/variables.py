"""Variable ``{{...}}`` and reference ``$(...)`` substitution.

Re-implements the reference's substitution walk
(reference: pkg/engine/variables/vars.go):

* ``{{ expr }}`` — JMESPath evaluated against the context; if a string leaf
  is exactly one variable, the raw (possibly non-string) value replaces the
  leaf; otherwise the JSON-encoded value is spliced into the string
* nested variables are resolved by re-scanning after each substitution round
* ``\\{{ ... }}`` escapes to a literal ``{{ ... }}``
* ``$(./../path)`` — relative references into the same document (used in
  validate patterns); resolved against the origin pattern with an optional
  leading operator preserved
* the preconditions resolver swallows resolution failures and substitutes
  the error (returning the value unchanged downstream)
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Optional, Tuple

from .context import Context, ContextError, InvalidVariableError

# reference: pkg/engine/variables/vars.go:22-34
RE_VARIABLES = re.compile(r'(^|[^\\])(\{\{(?:\{[^{}]*\}|[^{}])*\}\})')
RE_ESC_VARIABLES = re.compile(r'\\\{\{(?:\{[^{}]*\}|[^{}])*\}\}')
RE_REFERENCES = re.compile(r'^\$\(.[^\ ]*\)|[^\\]\$\(.[^\ ]*\)')
RE_ESC_REFERENCES = re.compile(r'\\\$\(.[^\ ]*\)')
RE_VARIABLE_INIT = re.compile(r'^\{\{(?:\{[^{}]*\}|[^{}])*\}\}')
RE_ELEMENT_INDEX = re.compile(r'{{\s*elementIndex\d*\s*}}')


class SubstitutionError(Exception):
    def __init__(self, msg: str, path: str = ''):
        super().__init__(msg)
        self.path = path


class NotResolvedReferenceError(SubstitutionError):
    pass


def is_variable(value: str) -> bool:
    return bool(RE_VARIABLES.search(value))


def is_reference(value: str) -> bool:
    return bool(RE_REFERENCES.search(value))


def _find_variables(value: str):
    """Return the list of {{...}} occurrences including a possible leading
    non-escape char (mirrors RegexVariables group behavior)."""
    return [m.group(0) for m in RE_VARIABLES.finditer(value)]


def replace_all_vars(src: str, repl: Callable[[str], str]) -> str:
    """Replace each {{...}} occurrence using ``repl`` (reference:
    pkg/engine/variables/vars.go:50 ReplaceAllVars)."""
    def wrapper(m: re.Match) -> str:
        return m.group(1) + repl(m.group(2))
    return RE_VARIABLES.sub(wrapper, src)


def _strip_braces(v: str) -> str:
    return v.replace('{{', '').replace('}}', '').strip()


# A resolver takes (context, variable_expr) and returns the value.
Resolver = Callable[[Context, str], Any]


def default_resolver(ctx: Context, variable: str) -> Any:
    return ctx.query(variable)


def tree_has_variables(document: Any) -> bool:
    """True when any string in the tree carries a ``{{..}}`` variable or
    a ``$(..)`` reference — var-free rule trees skip the per-resource
    deepcopy + substitution walk entirely (bulk-apply hot path).
    Memoized by identity: rule dicts are immutable for a policy's
    lifetime."""
    doc_id = id(document)
    hit = _VARFREE_CACHE.get(doc_id)
    if hit is not None and hit[0] is document:
        return hit[1]
    result = _scan_vars(document)
    if len(_VARFREE_CACHE) > 4096:
        _VARFREE_CACHE.clear()
    _VARFREE_CACHE[doc_id] = (document, result)
    return result


_VARFREE_CACHE: dict = {}


def _scan_vars(doc: Any) -> bool:
    if isinstance(doc, str):
        return '{{' in doc or '$(' in doc
    if isinstance(doc, dict):
        return any(_scan_vars(k) or _scan_vars(v) for k, v in doc.items())
    if isinstance(doc, list):
        return any(_scan_vars(v) for v in doc)
    return False


def substitute_all(ctx: Context, document: Any) -> Any:
    """Substitute references then variables across a JSON document
    (reference: pkg/engine/variables/vars.go:82 SubstituteAll).

    The output is READ-ONLY and may alias ``document``: subtrees with
    no variables/references are returned by reference (the
    ``_STATIC_TREES`` fast path in ``_traverse``), so mutating the
    result in place would corrupt the shared rule tree for every later
    resource.  Consumers must copy before mutating (the engine's
    appliers all do)."""
    document = substitute_references(document)
    return substitute_vars(ctx, document, default_resolver)


def substitute_all_in_preconditions(ctx: Context, document: Any) -> Any:
    # the preconditions resolver tolerates failures: unresolved vars raise,
    # caller treats that as "condition not met" (reference vars.go:66)
    document = substitute_references(document)
    return substitute_vars(ctx, document, default_resolver)


def substitute_vars(ctx: Optional[Context], document: Any,
                    resolver: Resolver) -> Any:
    # hoisted per call: querying request.operation per LEAF dominated
    # bulk substitution
    is_delete = _is_delete_request(ctx)
    return _traverse(document, document, '',
                     lambda leaf, doc, path: _substitute_vars_leaf(
                         ctx, leaf, resolver, path, is_delete))


def substitute_references(document: Any) -> Any:
    return _traverse(document, document, '',
                     lambda leaf, doc, path: _substitute_refs_leaf(
                         leaf, doc, path))


#: static-subtree memo for _traverse: rule trees are constants shared
#: across resources/elements, so a subtree with no variables and no
#: references is returned AS-IS (by reference).  Consumers treat
#: substitution output as read-only (the same contract context documents
#: already have), so the sharing is never observable.  The node object is
#: pinned in the value to guard against id() reuse.
_STATIC_TREES: dict = {}


def _tree_static(node: Any) -> bool:
    if isinstance(node, str):
        return '{{' not in node and '$(' not in node
    if isinstance(node, (int, float, bool)) or node is None:
        return True
    if isinstance(node, (dict, list)):
        key = id(node)
        hit = _STATIC_TREES.get(key)
        if hit is not None and hit[0] is node:
            return hit[1]
        if isinstance(node, dict):
            static = all(_tree_static(k) and _tree_static(v)
                         for k, v in node.items())
        else:
            static = all(_tree_static(v) for v in node)
        if len(_STATIC_TREES) > 16384:
            _STATIC_TREES.clear()
        _STATIC_TREES[key] = (node, static)
        return static
    return False


def _traverse(element: Any, document: Any, path: str,
              leaf_action: Callable[[Any, Any, str], Any]) -> Any:
    """Walk a JSON document applying ``leaf_action`` to leaves and map keys
    (reference: pkg/engine/jsonutils/traverse.go)."""
    if isinstance(element, (dict, list)) and _tree_static(element):
        return element
    if isinstance(element, dict):
        out = {}
        for key, value in element.items():
            new_key = leaf_action(key, document, path)
            if not isinstance(new_key, str):
                new_key = key
            # JSON-pointer escaping: a key containing '/' (label/
            # annotation domains) must stay one path component
            esc = str(key).replace('~', '~0').replace('/', '~1')
            out[new_key] = _traverse(value, document, f'{path}/{esc}',
                                     leaf_action)
        return out
    if isinstance(element, list):
        return [_traverse(v, document, f'{path}/{i}', leaf_action)
                for i, v in enumerate(element)]
    return leaf_action(element, document, path)


def _substitute_vars_leaf(ctx: Optional[Context], value: Any,
                          resolver: Resolver, path: str,
                          is_delete: Optional[bool] = None) -> Any:
    if not isinstance(value, str):
        return value
    if is_delete is None:
        is_delete = _is_delete_request(ctx)
    variables = _find_variables(value)
    while variables:
        original_pattern = value
        for occurrence in variables:
            initial = bool(RE_VARIABLE_INIT.match(occurrence))
            old = occurrence
            v = occurrence if initial else occurrence[1:]
            variable = _strip_braces(v)

            if variable == '@':
                variable = _at_to_path(ctx, path)

            if is_delete:
                variable = variable.replace('request.object', 'request.oldObject')

            try:
                substituted = resolver(ctx, variable)
            except (InvalidVariableError, ContextError) as e:
                raise SubstitutionError(
                    f'failed to resolve {variable} at path {path}: {e}',
                    path) from e

            if original_pattern == v:
                # whole leaf is one variable: return raw value
                return substituted

            prefix = '' if initial else old[0]
            value = _splice(prefix, value, v, substituted, variable, path)
        variables = _find_variables(value)

    value = RE_ESC_VARIABLES.sub(lambda m: m.group(0)[1:], value)
    return value


def _splice(prefix: str, pattern: str, variable_text: str, value: Any,
            variable: str, path: str) -> str:
    if isinstance(value, str):
        s = value
    else:
        try:
            s = json.dumps(value, separators=(',', ':'))
        except (TypeError, ValueError) as e:
            raise SubstitutionError(
                f'failed to resolve {variable} at path {path}: {e}', path)
    return pattern.replace(prefix + variable_text, prefix + s, 1)


def _at_to_path(ctx: Optional[Context], path: str) -> str:
    """Translate the ``@`` self-reference into an absolute JMESPath
    (reference: pkg/engine/variables/vars.go:367-380)."""
    prefix = 'request.object'
    if ctx is not None:
        try:
            if ctx.query('target') is not None:
                prefix = 'target'
        except (ContextError, InvalidVariableError):
            pass
    parts = [p.replace('~1', '/').replace('~0', '~')
             for p in path.split('/') if p != '']
    # skip past "foreach" if present, then the leading two elements
    if 'foreach' in parts:
        parts = parts[parts.index('foreach') + 1:]
    parts = parts[2:]
    segments = prefix.split('.')
    for p in parts:
        if p.isdigit():
            if segments:
                segments[-1] = f'{segments[-1]}[{p}]'
        else:
            if not re.fullmatch(r'[A-Za-z_][A-Za-z0-9_]*', p):
                # quoted identifier for keys JMESPath cannot take bare
                # (reference: pkg/utils/jsonpointer/pointer.go:139
                # JMESPath())
                p = '"' + p.replace('\\', '\\\\').replace('"', '\\"') + '"'
            segments.append(p)
    return '.'.join(segments)


def _is_delete_request(ctx: Optional[Context]) -> bool:
    if ctx is None:
        return False
    try:
        return ctx.query('request.operation') == 'DELETE'
    except (ContextError, InvalidVariableError):
        return False


# ---------------------------------------------------------------------------
# $(...) references

def _substitute_refs_leaf(value: Any, document: Any, path: str) -> Any:
    if not isinstance(value, str):
        return value
    for m in list(RE_REFERENCES.finditer(value)):
        occurrence = m.group(0)
        initial = occurrence.startswith('$(')
        old = occurrence
        ref = occurrence if initial else occurrence[1:]
        resolved = _resolve_reference(document, ref, path)
        if resolved is None:
            raise SubstitutionError(
                f'got nil resolved variable {ref} at path {path}', path)
        if isinstance(resolved, str):
            replacement = ('' if initial else old[0]) + resolved
            value = value.replace(old, replacement, 1)
            continue
        raise NotResolvedReferenceError(
            f'NotResolvedReferenceErr,reference {ref} not resolved at path '
            f'{path}', path)
    value = RE_ESC_REFERENCES.sub(lambda m2: m2.group(0)[1:], value)
    return value


def _resolve_reference(document: Any, reference: str, absolute_path: str) -> Any:
    from . import pattern as leaf_pattern
    path = reference.strip('$()')
    op = leaf_pattern.get_operator_from_string_pattern(path)
    path = path[len(op):]
    if not path:
        raise SubstitutionError('expected path, found empty reference')
    path = _form_absolute_path(path, absolute_path)
    value = _get_value_by_pointer(document, path)
    if op == '':
        return value
    if isinstance(value, str):
        return op + value
    if isinstance(value, bool):
        raise SubstitutionError(
            f'incorrect expression: operator {op} does not match with value '
            f'{value}')
    if isinstance(value, int):
        return f'{op}{value}'
    if isinstance(value, float):
        return f'{op}{value:f}'
    raise SubstitutionError(
        f'incorrect expression: operator {op} does not match with value {value}')


def _form_absolute_path(reference_path: str, absolute_path: str) -> str:
    import posixpath
    if reference_path.startswith('/'):
        return reference_path
    return posixpath.normpath(posixpath.join(absolute_path, reference_path))


def _get_value_by_pointer(document: Any, pointer: str) -> Any:
    from .anchor import remove_anchor
    cur = document
    # traversal paths are JSON-pointer escaped (~1 = '/', ~0 = '~')
    for part in [p.replace('~1', '/').replace('~0', '~')
                 for p in pointer.split('/') if p]:
        if isinstance(cur, dict):
            if part in cur:
                cur = cur[part]
                continue
            # try anchored keys
            found = False
            for k in cur:
                bare, _mod = remove_anchor(k)
                if bare == part:
                    cur = cur[k]
                    found = True
                    break
            if not found:
                raise SubstitutionError(
                    f'failed to resolve reference: path {pointer} not found')
        elif isinstance(cur, list):
            try:
                cur = cur[int(part)]
            except (ValueError, IndexError):
                raise SubstitutionError(
                    f'failed to resolve reference: path {pointer} not found')
        else:
            raise SubstitutionError(
                f'failed to resolve reference: path {pointer} not found')
    return cur


def validate_element_in_foreach(document: Any) -> None:
    """Raise if element/elementIndex variables appear outside a foreach block
    (reference: pkg/engine/variables/vars.go:252 ValidateElementInForEach)."""
    def leaf(value, doc, path):
        if isinstance(value, str):
            for occurrence in _find_variables(value):
                v = occurrence if RE_VARIABLE_INIT.match(occurrence) else occurrence[1:]
                variable = _strip_braces(v)
                is_element = variable.startswith('element') or variable == 'elementIndex'
                if is_element and '/foreach/' not in path:
                    raise SubstitutionError(
                        f"variable '{variable}' present outside of foreach at "
                        f"path {path}", path)
        return value
    _traverse(document, document, '', leaf)
