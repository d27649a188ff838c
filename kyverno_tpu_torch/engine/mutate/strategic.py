"""Strategic merge patch with Kyverno anchor preprocessing.

Two stages, mirroring the reference:

1. **Preprocessing** (reference: pkg/engine/mutate/patch/strategicPreprocessing.go)
   resolves mutate-overlay anchors against the resource: conditional anchors
   ``(key)``/``<(key)`` gate whether (parts of) the patch apply,
   ``+(key)`` adds only when absent, and anchored list-of-map elements are
   expanded per matching resource element (carrying the resource's ``name``
   so associative merge can target it).

2. **Merge** (reference: pkg/engine/mutate/patch/strategicMergePatch.go via
   kustomize kyaml merge2): maps merge recursively, ``null`` deletes,
   ``$patch: delete|replace`` directives honored, and lists of maps merge
   associatively when their elements share one of kyaml's associative keys
   (mountPath, devicePath, ip, type, topologyKey, name, containerPort);
   other lists are replaced.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from .. import anchor
from ..validate_pattern import PatternError, match_pattern


class ConditionError(Exception):
    """A conditional anchor did not match → skip this part/rule."""


class GlobalConditionError(Exception):
    """A global anchor did not match → skip the whole rule."""


# kyaml's associative sequence keys (kustomize kyaml/yaml/types.go)
ASSOCIATIVE_KEYS = ('mountPath', 'devicePath', 'ip', 'type', 'topologyKey',
                    'name', 'containerPort')


def apply_strategic_merge_patch(base: Any, overlay: Any) -> Any:
    """Preprocess the overlay against base, then merge. Returns the patched
    document; on a failed condition returns base unchanged.  Neither
    input is mutated: preprocessing rebuilds containers as it walks and
    the merge is copy-on-write, so the output may structurally SHARE
    unpatched subtrees with both inputs (the ``substitute_all`` aliasing
    contract — treat outputs read-only or copy before mutating)."""
    try:
        overlay = preprocess_pattern(overlay, base)
    except (ConditionError, GlobalConditionError):
        return base
    return strategic_merge(base, overlay)


# ---------------------------------------------------------------------------
# Stage 1: preprocessing
#
# The whole walk is NON-MUTATING toward ``pattern``: every map level is
# rebuilt before being written to (`_handle_add_if_not_present` /
# `_delete_anchors_in_map` return fresh dicts; `_validate_conditions`
# only ever writes into the fresh dict `_walk_map` just made), so
# callers apply rule-constant overlays per resource WITHOUT a deepcopy
# — the per-(resource, element) deepcopy used to dominate bulk mutate
# profiles the same way `calculate_resource_hash`'s did (PR 6).
# tests/test_mutate.py pins both the no-mutation property and output
# identity against a deepcopy-based reference.

def preprocess_pattern(pattern: Any, resource: Any) -> Any:
    pattern = _preprocess_recursive(pattern, resource)
    return _delete_condition_elements(pattern)


def _preprocess_recursive(pattern: Any, resource: Any) -> Any:
    if isinstance(pattern, dict):
        return _walk_map(pattern, resource)
    if isinstance(pattern, list):
        return _walk_list(pattern, resource)
    return pattern


def _walk_map(pattern: dict, resource: Any) -> dict:
    pattern = _handle_add_if_not_present(pattern, resource)
    _validate_conditions(pattern, resource)
    out = {}
    for key, value in pattern.items():
        a = anchor.parse(key)
        if a is not None and (anchor.contains_condition(a) or
                              anchor.is_add_if_not_present(a)):
            out[key] = value
            continue
        resource_value = None
        if isinstance(resource, dict):
            resource_value = resource.get(a.key if a else key)
        out[key] = _preprocess_recursive(value, resource_value)
    return out


def _walk_list(pattern: list, resource: Any) -> list:
    if not pattern:
        return pattern
    if isinstance(pattern[0], dict):
        return _process_list_of_maps(pattern, resource)
    return pattern


def _process_list_of_maps(pattern: list, resource: Any) -> list:
    # reference: strategicPreprocessing.go:119 processListOfMaps
    resource_elements = resource if isinstance(resource, list) else []
    out = list(pattern)
    for pattern_element in pattern:
        has_any_anchor = _has_anchors(pattern_element)
        has_global = _has_anchors(pattern_element, global_only=True)
        if not has_any_anchor:
            continue
        any_global_passed = False
        last_global_error: Optional[GlobalConditionError] = None
        # the recursive walk never mutates its pattern argument (module
        # note above), so one shared pattern_element serves every
        # resource element — no per-(resource, element) deepcopy
        for resource_element in resource_elements:
            try:
                processed = _preprocess_recursive(pattern_element,
                                                  resource_element)
            except ConditionError:
                continue
            except GlobalConditionError as e:
                last_global_error = e
                continue
            if has_global:
                any_global_passed = True
            else:
                new_elem = _pattern_with_name(processed, resource_element)
                if new_elem is not None:
                    out.append(new_elem)
        if not resource_elements:
            try:
                _preprocess_recursive(pattern_element, None)
                if has_global:
                    any_global_passed = True
            except ConditionError:
                continue
            except GlobalConditionError as e:
                last_global_error = e
        if not any_global_passed and last_global_error is not None:
            raise last_global_error
    return out


def _pattern_with_name(pattern_element: dict, resource_element: Any) -> Optional[dict]:
    # reference: strategicPreprocessing.go:186 handlePatternName
    if not isinstance(resource_element, dict):
        return None
    name = resource_element.get('name')
    if not name:
        return None
    new_node, empty = _delete_anchors(pattern_element,
                                      delete_scalar=True,
                                      traverse_mapping=False)
    if empty or not isinstance(new_node, dict):
        return None
    new_node['name'] = name
    return new_node


def _validate_conditions(pattern: dict, resource: Any) -> None:
    # reference: strategicPreprocessing.go:236 validateConditions
    for filter_fn, err_cls in ((anchor.is_global, GlobalConditionError),
                               (anchor.is_condition, ConditionError)):
        for key in list(pattern.keys()):
            a = anchor.parse(key)
            if a is None or not filter_fn(a):
                continue
            if not isinstance(resource, dict) or a.key not in resource:
                raise err_cls(
                    f'could not found "{a.key}" key in the resource')
            pattern_value = pattern[key]
            resource_value = resource[a.key]
            if isinstance(pattern_value, dict):
                processed = _handle_add_if_not_present(pattern_value,
                                                       resource_value)
                if processed != pattern_value:
                    pattern[key] = processed
                    continue
                had_add = any(anchor.is_add_if_not_present(anchor.parse(k))
                              for k in pattern_value)
                if had_add:
                    pattern[key] = processed
                    continue
            try:
                match_pattern(resource_value, _strip_all_anchors(pattern_value))
            except PatternError as e:
                raise err_cls(str(e)) from e


def _strip_all_anchors(pattern: Any) -> Any:
    if isinstance(pattern, dict):
        out = {}
        for k, v in pattern.items():
            a = anchor.parse(k)
            key = a.key if a is not None and anchor.contains_condition(a) else k
            out[key] = _strip_all_anchors(v)
        return out
    if isinstance(pattern, list):
        return [_strip_all_anchors(v) for v in pattern]
    return pattern


def _handle_add_if_not_present(pattern: dict, resource: Any) -> dict:
    # reference: strategicPreprocessing.go:253 handleAddIfNotPresentAnchor
    out = {}
    for key, value in pattern.items():
        a = anchor.parse(key)
        if a is not None and anchor.is_add_if_not_present(a):
            if isinstance(resource, dict) and a.key in resource:
                continue  # field exists → drop the +() entry
            out[a.key] = value  # strip the anchor wrapping
        else:
            out[key] = value
    return out


def _has_anchors(pattern: Any, global_only: bool = False) -> bool:
    def check(a) -> bool:
        if a is None:
            return False
        if global_only:
            return anchor.is_global(a)
        return anchor.contains_condition(a) or anchor.is_add_if_not_present(a)

    if isinstance(pattern, dict):
        for key, value in pattern.items():
            if check(anchor.parse(key)):
                return True
            if _has_anchors(value, global_only):
                return True
        return False
    if isinstance(pattern, list):
        return any(_has_anchors(e, global_only) for e in pattern)
    if isinstance(pattern, str):
        return check(anchor.parse(pattern))
    return False


def _delete_condition_elements(pattern: Any) -> Any:
    # reference: strategicPreprocessing.go:399 deleteConditionElements
    if not isinstance(pattern, dict):
        return pattern
    out = {}
    for key, value in pattern.items():
        delete_scalar = anchor.contains_condition(anchor.parse(key))
        new_value, can_delete = _delete_anchors(value, delete_scalar, False)
        if not can_delete:
            out[key] = new_value
    return out


def _delete_anchors(node: Any, delete_scalar: bool,
                    traverse_mapping: bool) -> Tuple[Any, bool]:
    # reference: strategicPreprocessing.go:432 deleteAnchors
    if isinstance(node, dict):
        return _delete_anchors_in_map(node, traverse_mapping)
    if isinstance(node, list):
        return _delete_anchors_in_list(node, traverse_mapping)
    return node, delete_scalar


def _delete_anchors_in_map(node: dict, traverse_mapping: bool) -> Tuple[dict, bool]:
    node = dict(node)
    # conditional anchors: resolve, strip wrapping if subtree survives
    anchors_exist = False
    for key in list(node.keys()):
        a = anchor.parse(key)
        if a is None or not anchor.contains_condition(a):
            continue
        value, should_delete = _delete_anchors(node[key], True,
                                               traverse_mapping)
        del node[key]
        if not should_delete:
            node[a.key] = value
            anchors_exist = True
    need_to_delete = True
    out = {}
    for key, value in node.items():
        new_value, can_delete = _delete_anchors(value, False, traverse_mapping)
        if not can_delete:
            out[key] = new_value
            need_to_delete = False
    if anchors_exist:
        need_to_delete = False
    return out, need_to_delete and not anchors_exist


def _delete_anchors_in_list(node: list, traverse_mapping: bool) -> Tuple[list, bool]:
    was_empty = len(node) == 0
    out = []
    for element in node:
        if _has_anchors(element):
            if traverse_mapping and isinstance(element, dict):
                new_elem, should_delete = _delete_anchors(element, True,
                                                          traverse_mapping)
                if not should_delete:
                    out.append(new_elem)
            # else: drop the anchored element
        else:
            new_elem, can_delete = _delete_anchors(element, False,
                                                   traverse_mapping)
            if not can_delete:
                out.append(new_elem)
    if len(out) == 0 and not was_empty:
        return out, True
    return out, False


# ---------------------------------------------------------------------------
# Stage 2: merge

def strategic_merge(base: Any, patch: Any) -> Any:
    """Pure merge: inputs are never mutated and the OUTPUT structurally
    shares unmodified subtrees with them (new containers are built only
    along patched paths — the same copy-on-write discipline as the JSON
    context's merge_patch).  Deep-copying the whole base per map level
    dominated bulk-apply profiles."""
    if isinstance(patch, dict):
        directive = patch.get('$patch')
        if directive == 'delete':
            return None
        if directive == 'replace':
            return {k: v for k, v in patch.items() if k != '$patch'}
        if not isinstance(base, dict):
            base = {}
        out = dict(base)
        for k, v in patch.items():
            if k == '$patch':
                continue
            if v is None:
                out.pop(k, None)
            elif k in out:
                merged = strategic_merge(out[k], v)
                if merged is None:
                    out.pop(k, None)
                else:
                    out[k] = merged
            else:
                cleaned = _strip_directives(v)
                if cleaned is not None:
                    out[k] = cleaned
        return out
    if isinstance(patch, list):
        if isinstance(base, list):
            key = _associative_key(base, patch)
            if key is not None:
                return _merge_associative(base, patch, key)
        return [x for x in (_strip_directives(e) for e in patch)
                if x is not None]
    return patch


def _strip_directives(v: Any) -> Any:
    if isinstance(v, dict):
        if v.get('$patch') == 'delete':
            return None
        return {k: _strip_directives(val) for k, val in v.items()
                if k != '$patch'}
    if isinstance(v, list):
        return [x for x in (_strip_directives(e) for e in v) if x is not None]
    return v


def _associative_key(base: list, patch: list) -> Optional[str]:
    elements = [e for e in list(base) + list(patch) if e is not None]
    if not elements or not all(isinstance(e, dict) for e in elements):
        return None
    patch_elements = [e for e in patch if isinstance(e, dict)]
    candidates = patch_elements or elements
    for key in ASSOCIATIVE_KEYS:
        if all(key in e for e in candidates):
            return key
    return None


def _merge_associative(base: list, patch: list, key: str) -> list:
    out = list(base)  # unmerged elements are shared, never mutated
    index = {e.get(key): i for i, e in enumerate(out)
             if isinstance(e, dict)}
    for p in patch:
        if not isinstance(p, dict):
            out.append(p)
            continue
        k = p.get(key)
        if p.get('$patch') == 'delete':
            if k in index:
                i = index[k]
                out[i] = None
            continue
        if k in index:
            out[index[k]] = strategic_merge(out[index[k]], p)
        else:
            cleaned = _strip_directives(p)
            if cleaned is not None:
                out.append(cleaned)
                index[k] = len(out) - 1
    return [e for e in out if e is not None]
