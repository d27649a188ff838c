"""Per-request JSON variable context with a checkpoint stack.

Re-implements the reference's engine context
(reference: pkg/engine/context/context.go, evaluate.go):

* a single JSON document built by RFC-7386 merge-patch semantics (null
  deletes, objects merge recursively, everything else replaces)
* well-known paths: request.object / request.oldObject / request.operation /
  request.userInfo / request.namespace, images, element / elementIndex
  (with `elementN` nesting for nested foreach)
* Checkpoint / Restore / Reset stack used for rule and foreach isolation
* Query() evaluates a JMESPath expression over the document
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional

from . import jmespath as jp


class ContextError(Exception):
    pass


class InvalidVariableError(ContextError):
    pass


class VariableNotFoundError(ContextError):
    """Query resolved to a missing field (maps the fork's NotFoundError)."""


def merge_patch(target: Any, patch: Any) -> Any:
    """RFC 7386 JSON merge patch (reference merges via
    jsonpatch.MergeMergePatches, pkg/engine/context/context.go:123).

    Non-dict patch values are shared by reference, not copied: the engine
    treats context documents as immutable (queries only read; substitution
    builds new objects), which also makes checkpoints O(1)."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    else:
        target = dict(target)
    for k, v in patch.items():
        if v is None:
            target.pop(k, None)
        elif k not in target:
            # absent key: share the patch subtree by reference — context
            # documents are immutable (see above), and every writer
            # copies the target spine, so sharing is never observable.
            # RFC 7386 still requires nested nulls to be STRIPPED, so
            # dicts only short-circuit when verifiably null-free.
            if isinstance(v, dict) and not _null_free(v):
                target[k] = merge_patch(None, v)
            else:
                target[k] = v
        else:
            target[k] = merge_patch(target[k], v)
    return target


#: null-free memo, id-pinned: the same resource dict is merged into many
#: contexts (one per policy/element), so the scan amortizes
_NULL_FREE: dict = {}


def _null_free(node: Any) -> bool:
    if isinstance(node, dict):
        key = id(node)
        hit = _NULL_FREE.get(key)
        if hit is not None and hit[0] is node:
            return hit[1]
        ok = all(v is not None and _null_free(v) for v in node.values())
        if len(_NULL_FREE) > 16384:
            _NULL_FREE.clear()
        _NULL_FREE[key] = (node, ok)
        return ok
    if isinstance(node, list):
        return all(_null_free(v) for v in node)
    return True


class Context:
    """The engine's per-request variable store."""

    def __init__(self, data: Optional[dict] = None):
        self._data: dict = data if data is not None else {}
        self._checkpoints: List[dict] = []

    # -- raw document --------------------------------------------------------

    @property
    def data(self) -> dict:
        return self._data

    def add_json(self, patch: Any) -> None:
        self._data = merge_patch(self._data, patch)

    # -- well-known paths ----------------------------------------------------

    def add_request(self, request: dict) -> None:
        self.add_json({'request': request})

    def add_resource(self, resource: dict) -> None:
        self.add_json({'request': {'object': resource}})

    def add_old_resource(self, resource: dict) -> None:
        self.add_json({'request': {'oldObject': resource}})

    def add_target_resource(self, resource: dict) -> None:
        self.add_json({'target': resource})

    def add_operation(self, op: str) -> None:
        self.add_json({'request': {'operation': op}})

    def add_user_info(self, user_info: dict) -> None:
        self.add_json({'request': user_info})

    def add_namespace(self, namespace: str) -> None:
        self.add_json({'request': {'namespace': namespace}})

    def add_variable(self, key: str, value: Any) -> None:
        patch: Any = value
        for part in reversed(key.split('.')):
            patch = {part: patch}
        self.add_json(patch)

    def add_context_entry(self, name: str, value: Any) -> None:
        self.add_json({name: value})

    def replace_context_entry(self, name: str, value: Any) -> None:
        self.add_json({name: None})
        self.add_json({name: value})

    def add_element(self, data: Any, index: int, nesting: int = 0) -> None:
        # reference: pkg/engine/context/context.go:244 AddElement
        self.add_json({
            'element': data,
            f'element{nesting}': data,
            'elementIndex': index,
            f'elementIndex{nesting}': index,
        })

    def add_service_account(self, username: str) -> None:
        # reference: pkg/engine/context/context.go:193 AddServiceAccount
        sa_prefix = 'system:serviceaccount:'
        sa = username[len(sa_prefix):] if len(username) > len(sa_prefix) else ''
        name, namespace = '', ''
        groups = sa.split(':')
        if len(groups) >= 2:
            namespace, name = groups[0], groups[1]
        self.add_json({'serviceAccountName': name})
        self.add_json({'serviceAccountNamespace': namespace})

    def add_image_infos(self, images: dict) -> None:
        self.add_json({'images': images})

    # -- checkpoint stack ----------------------------------------------------
    # O(1) snapshots: every mutation goes through add_json → merge_patch,
    # which is copy-on-write (builds new dicts along patched paths, never
    # mutates in place), so a checkpoint is just a reference
    # (the reference deep-copies raw bytes instead,
    # pkg/engine/context/context.go:301)

    def checkpoint(self) -> None:
        self._checkpoints.append(self._data)

    def restore(self) -> None:
        if self._checkpoints:
            self._data = self._checkpoints.pop()

    def reset(self) -> None:
        if self._checkpoints:
            self._data = self._checkpoints[-1]

    # -- querying ------------------------------------------------------------

    def query(self, query: str) -> Any:
        query = query.strip()
        if not query:
            raise InvalidVariableError('invalid query (nil)')
        try:
            compiled = jp.compile(query)
        except jp.JMESPathError as e:
            raise InvalidVariableError(f'incorrect query {query}: {e}') from e
        try:
            return compiled.search(self._data)
        except jp.NotFoundError as e:
            raise VariableNotFoundError(str(e)) from e
        except jp.JMESPathError as e:
            raise ContextError(f'JMESPath query failed: {e}') from e

    def has_changed(self, expr: str) -> bool:
        obj = self.query('request.object.' + expr)
        if obj is None:
            raise ContextError(f'request.object.{expr} not found')
        old = self.query('request.oldObject.' + expr)
        if old is None:
            raise ContextError(f'request.oldObject.{expr} not found')
        return obj != old


class MockContext(Context):
    """Context that only allows an allow-listed set of query roots, for the
    CLI / tests (reference: pkg/engine/context/mock_context.go)."""

    def __init__(self, allowed: List[str], data: Optional[dict] = None):
        super().__init__(data)
        self._allowed = list(allowed)

    def query(self, query: str) -> Any:
        from ..utils import wildcard
        q = query.strip()
        if not any(wildcard.match(pat, q) or q.startswith(pat.rstrip('*').rstrip('.'))
                   for pat in self._allowed):
            raise InvalidVariableError(f'variable {q} not allowed')
        return super().query(query)
