"""RFC 6902 JSON Patch: apply and diff.

Apply mirrors the reference's evanphx/json-patch usage
(reference: pkg/engine/mutate/patch/patchJSON6902.go); diff mirrors the
patch generation used after strategic merge
(reference: pkg/engine/mutate/patch/patchesUtils.go generatePatches).
"""

from __future__ import annotations

import copy
import json
from typing import Any, List, Optional, Tuple

import yaml


class JsonPatchError(Exception):
    pass


def _unescape(token: str) -> str:
    return token.replace('~1', '/').replace('~0', '~')


def _escape(token: str) -> str:
    return token.replace('~', '~0').replace('/', '~1')


def _split_pointer(pointer: str) -> List[str]:
    if pointer == '':
        return []
    if not pointer.startswith('/'):
        raise JsonPatchError(f'invalid JSON pointer {pointer!r}')
    return [_unescape(t) for t in pointer.split('/')[1:]]


def _get(doc: Any, tokens: List[str]) -> Any:
    cur = doc
    for t in tokens:
        if isinstance(cur, dict):
            if t not in cur:
                raise JsonPatchError(f'path not found: {t!r}')
            cur = cur[t]
        elif isinstance(cur, list):
            try:
                cur = cur[int(t)]
            except (ValueError, IndexError):
                raise JsonPatchError(f'invalid array index {t!r}')
        else:
            raise JsonPatchError(f'cannot traverse scalar at {t!r}')
    return cur


def _resolve_parent(doc: Any, tokens: List[str]) -> Tuple[Any, str]:
    if not tokens:
        raise JsonPatchError('cannot operate on root document')
    return _get(doc, tokens[:-1]), tokens[-1]


def apply_patch(doc: Any, operations: List[dict]) -> Any:
    """Apply an RFC 6902 operation list, returning the patched document.

    Matches the reference's evanphx/json-patch ApplyOptions
    (patchJSON6902.go:78): EnsurePathExistsOnAdd (add creates missing
    intermediate containers), AllowMissingPathOnRemove (remove of a
    missing path is a no-op), SupportNegativeIndices.
    """
    doc = copy.deepcopy(doc)
    for op in operations:
        action = op.get('op')
        path = op.get('path', '')
        tokens = _split_pointer(path)
        if action == 'add':
            doc = _op_add(doc, tokens, copy.deepcopy(op.get('value')),
                          ensure_path=True)
        elif action == 'replace':
            doc = _op_replace(doc, tokens, copy.deepcopy(op.get('value')))
        elif action == 'remove':
            doc = _op_remove(doc, tokens, allow_missing=True)
        elif action == 'move':
            from_tokens = _split_pointer(op.get('from', ''))
            value = _get(doc, from_tokens)
            doc = _op_remove(doc, from_tokens)
            doc = _op_add(doc, tokens, value)
        elif action == 'copy':
            from_tokens = _split_pointer(op.get('from', ''))
            value = copy.deepcopy(_get(doc, from_tokens))
            doc = _op_add(doc, tokens, value)
        elif action == 'test':
            if _get(doc, tokens) != op.get('value'):
                raise JsonPatchError(f'test failed at {path}')
        else:
            raise JsonPatchError(f'invalid operation {action!r}')
    return doc


def _op_add(doc: Any, tokens: List[str], value: Any,
            ensure_path: bool = False) -> Any:
    if not tokens:
        return value
    if ensure_path:
        doc = _ensure_parents(doc, tokens)
    parent, last = _resolve_parent(doc, tokens)
    if isinstance(parent, dict):
        parent[last] = value
    elif isinstance(parent, list):
        if last == '-':
            parent.append(value)
        else:
            try:
                idx = int(last)
            except ValueError:
                raise JsonPatchError(f'invalid array index {last!r}')
            if idx < 0:
                idx += len(parent)  # SupportNegativeIndices
            if idx < 0 or idx > len(parent):
                raise JsonPatchError(f'array index {last} out of bounds')
            parent.insert(idx, value)
    else:
        raise JsonPatchError('add target parent is a scalar')
    return doc


def _ensure_parents(doc: Any, tokens: List[str]) -> Any:
    """Create missing intermediate containers along an add path
    (evanphx/json-patch EnsurePathExistsOnAdd). A next token that is an
    array index or ``-`` makes the missing container a list, else a map."""
    cur = doc
    for i, t in enumerate(tokens[:-1]):
        nxt = tokens[i + 1]
        want_list = nxt == '-' or nxt.lstrip('-').isdigit()
        if isinstance(cur, dict):
            if t not in cur or cur[t] is None:
                cur[t] = [] if want_list else {}
            cur = cur[t]
        elif isinstance(cur, list):
            if t == '-':
                cur.append([] if want_list else {})
                cur = cur[-1]
            else:
                try:
                    idx = int(t)
                except ValueError:
                    raise JsonPatchError(f'invalid array index {t!r}')
                if idx < 0:
                    idx += len(cur)
                if idx == len(cur):
                    cur.append([] if want_list else {})
                if idx < 0 or idx >= len(cur):
                    raise JsonPatchError(f'array index {t} out of bounds')
                if cur[idx] is None:
                    cur[idx] = [] if want_list else {}
                cur = cur[idx]
        else:
            raise JsonPatchError(f'cannot create path under scalar at {t!r}')
    return doc


def _op_replace(doc: Any, tokens: List[str], value: Any) -> Any:
    if not tokens:
        return value
    parent, last = _resolve_parent(doc, tokens)
    if isinstance(parent, dict):
        if last not in parent:
            raise JsonPatchError(f'replace path not found: {last!r}')
        parent[last] = value
    elif isinstance(parent, list):
        try:
            parent[int(last)] = value
        except (ValueError, IndexError):
            raise JsonPatchError(f'invalid array index {last!r}')
    else:
        raise JsonPatchError('replace target parent is a scalar')
    return doc


def _op_remove(doc: Any, tokens: List[str],
               allow_missing: bool = False) -> Any:
    try:
        parent, last = _resolve_parent(doc, tokens)
    except JsonPatchError:
        if allow_missing:
            return doc
        raise
    if isinstance(parent, dict):
        if last not in parent:
            if allow_missing:
                return doc
            raise JsonPatchError(f'remove path not found: {last!r}')
        del parent[last]
    elif isinstance(parent, list):
        try:
            idx = int(last)
        except ValueError:
            raise JsonPatchError(f'invalid array index {last!r}')
        if idx < 0:
            idx += len(parent)
        if 0 <= idx < len(parent):
            del parent[idx]
        elif not allow_missing:
            raise JsonPatchError(f'invalid array index {last!r}')
    else:
        raise JsonPatchError('remove target parent is a scalar')
    return doc


def load_patches(text: str) -> List[dict]:
    """Parse a patchesJson6902 string (JSON or YAML list of ops)."""
    try:
        ops = json.loads(text)
    except ValueError:
        try:
            ops = yaml.safe_load(text)
        except yaml.YAMLError as e:
            raise JsonPatchError(f'invalid patchesJson6902: {e}')
    if not isinstance(ops, list):
        raise JsonPatchError('patchesJson6902 must be a list of operations')
    return ops


# ---------------------------------------------------------------------------
# Diff: original → patched as RFC 6902 operations

def generate_patches(original: Any, patched: Any) -> List[dict]:
    """Produce an operation list transforming original into patched."""
    ops: List[dict] = []
    _diff(original, patched, '', ops)
    return ops


def _diff(a: Any, b: Any, path: str, ops: List[dict]) -> None:
    if type(a) is not type(b) and not (
            isinstance(a, (int, float)) and isinstance(b, (int, float))
            and not isinstance(a, bool) and not isinstance(b, bool)):
        ops.append({'op': 'replace', 'path': path or '', 'value': b})
        return
    if isinstance(a, dict):
        for k in a:
            if k not in b:
                ops.append({'op': 'remove', 'path': f'{path}/{_escape(k)}'})
        for k, v in b.items():
            child = f'{path}/{_escape(k)}'
            if k not in a:
                ops.append({'op': 'add', 'path': child, 'value': v})
            elif a[k] != v:
                _diff(a[k], v, child, ops)
    elif isinstance(a, list):
        common = min(len(a), len(b))
        for i in range(common):
            if a[i] != b[i]:
                _diff(a[i], b[i], f'{path}/{i}', ops)
        if len(b) > len(a):
            for i in range(len(a), len(b)):
                ops.append({'op': 'add', 'path': f'{path}/{i}', 'value': b[i]})
        else:
            for i in reversed(range(len(b), len(a))):
                ops.append({'op': 'remove', 'path': f'{path}/{i}'})
    else:
        if a != b:
            ops.append({'op': 'replace', 'path': path or '', 'value': b})
