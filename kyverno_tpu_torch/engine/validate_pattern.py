"""Pattern ("overlay") validation: tree-walk of a resource against a pattern.

Re-implements the reference's MatchPattern walk
(reference: pkg/engine/validate/validate.go) with anchor semantics from
``anchor.py``.  The public entry is :func:`match_pattern`, which returns None
on success and raises :class:`PatternError` on mismatch; ``PatternError.skip``
distinguishes "rule does not apply" (conditional/global anchor miss) from a
genuine validation failure.
"""

from __future__ import annotations

from typing import Any, Optional

from . import anchor
from . import pattern as leaf
from ..utils import wildcard


class PatternError(Exception):
    def __init__(self, msg: str, path: str = '', skip: bool = False):
        super().__init__(msg)
        self.path = path
        self.skip = skip


def match_pattern(resource: Any, pattern: Any) -> None:
    """Validate ``resource`` against ``pattern`` starting at root
    (reference: pkg/engine/validate/validate.go:31).  Raises PatternError."""
    ac = anchor.AnchorMap()
    try:
        _validate_element(resource, pattern, pattern, '/', ac)
    except anchor.ValidateError as err:
        if anchor.is_skip_error(err):
            raise PatternError(str(err), '', skip=True) from err
        if anchor.is_fail_error(err):
            raise PatternError(str(err), err.path, skip=False) from err
        if ac.keys_are_missing():
            raise PatternError(str(err), '', skip=False) from err
        raise PatternError(str(err), err.path, skip=False) from err


def _validate_element(resource_element: Any, pattern_element: Any,
                      origin_pattern: Any, path: str,
                      ac: anchor.AnchorMap) -> None:
    # reference: pkg/engine/validate/validate.go:71 validateResourceElement
    if isinstance(pattern_element, dict):
        if not isinstance(resource_element, dict):
            raise anchor.ValidateError(
                f'pattern and resource have different structures. Path: {path}. '
                f'Expected map, found {_type_name(resource_element)}', path)
        ac.check_anchor_in_resource(pattern_element, resource_element)
        _validate_map(resource_element, pattern_element, origin_pattern, path, ac)
    elif isinstance(pattern_element, list):
        if not isinstance(resource_element, list):
            raise anchor.ValidateError(
                f'validation rule failed at path {path}, resource does not '
                f'satisfy the expected overlay pattern', path)
        _validate_array(resource_element, pattern_element, origin_pattern, path, ac)
    elif isinstance(pattern_element, (str, float, int, bool)) or pattern_element is None:
        if isinstance(resource_element, list):
            for res in resource_element:
                if not leaf.validate(res, pattern_element):
                    raise anchor.ValidateError(
                        f"resource value '{_fmt(resource_element)}' does not "
                        f"match '{_fmt(pattern_element)}' at path {path}", path)
        else:
            if not leaf.validate(resource_element, pattern_element):
                raise anchor.ValidateError(
                    f"resource value '{_fmt(resource_element)}' does not "
                    f"match '{_fmt(pattern_element)}' at path {path}", path)
    else:
        raise anchor.ValidateError(
            f"failed at '{path}', pattern contains unknown type", path)


def _validate_map(resource_map: dict, pattern_map: dict, origin_pattern: Any,
                  path: str, ac: anchor.AnchorMap) -> None:
    # reference: pkg/engine/validate/validate.go:118 validateMap
    pattern_map = expand_metadata_wildcards(pattern_map, resource_map)
    anchors, resources = anchor.get_anchors_resources_from_map(pattern_map)

    # Phase 1: condition/existence/equality/negation anchors, sorted key order
    for key in sorted(anchors):
        anchor.handle_element(key, anchors[key], path, _validate_element,
                              resource_map, origin_pattern, ac)

    # Phase 2: plain keys + global anchors; global anchors and keys whose
    # subtree contains anchors are processed first
    for key in _sorted_nested_anchor_keys(resources):
        anchor.handle_element(key, resources[key], path, _validate_element,
                              resource_map, origin_pattern, ac)


def _validate_array(resource_array: list, pattern_array: list,
                    origin_pattern: Any, path: str,
                    ac: anchor.AnchorMap) -> None:
    # reference: pkg/engine/validate/validate.go:163 validateArray
    if len(pattern_array) == 0:
        raise anchor.ValidateError('pattern Array empty', path)
    first = pattern_array[0]
    if isinstance(first, dict):
        _validate_array_of_maps(resource_array, first, origin_pattern, path, ac)
    elif isinstance(first, (str, float, int, bool)) or first is None:
        _validate_element(resource_array, first, origin_pattern, path, ac)
    else:
        if len(resource_array) < len(pattern_array):
            raise anchor.ValidateError(
                f'validate Array failed, array length mismatch, resource Array '
                f'len is {len(resource_array)} and pattern Array len is '
                f'{len(pattern_array)}', '')
        apply_count = 0
        skip_errors = []
        for i, pattern_element in enumerate(pattern_array):
            current_path = f'{path}{i}/'
            try:
                _validate_element(resource_array[i], pattern_element,
                                  origin_pattern, current_path, ac)
            except anchor.ValidateError as err:
                if anchor.is_skip_error(err):
                    skip_errors.append(err)
                    continue
                raise
            apply_count += 1
        if apply_count == 0 and skip_errors:
            raise anchor.ConditionalAnchorError(
                '; '.join(str(e) for e in skip_errors), path)


def _validate_array_of_maps(resource_array: list, pattern_map: dict,
                            origin_pattern: Any, path: str,
                            ac: anchor.AnchorMap) -> None:
    # reference: pkg/engine/validate/validate.go:218 validateArrayOfMaps
    apply_count = 0
    skip_errors = []
    for i, resource_element in enumerate(resource_array):
        current_path = f'{path}{i}/'
        try:
            _validate_element(resource_element, pattern_map, origin_pattern,
                              current_path, ac)
        except anchor.ValidateError as err:
            if anchor.is_skip_error(err):
                skip_errors.append(err)
                continue
            raise
        apply_count += 1
    if apply_count == 0 and skip_errors:
        raise anchor.ConditionalAnchorError(
            '; '.join(str(e) for e in skip_errors), path)


# ---------------------------------------------------------------------------

def has_nested_anchors(pattern: Any) -> bool:
    if isinstance(pattern, dict):
        for key, value in pattern.items():
            if anchor.parse(key) is not None:
                return True
            if has_nested_anchors(value):
                return True
        return False
    if isinstance(pattern, list):
        return any(has_nested_anchors(v) for v in pattern)
    return False


def _sorted_nested_anchor_keys(resources: dict) -> list:
    front, back = [], []
    for k in sorted(resources):
        v = resources[k]
        if anchor.is_global(anchor.parse(k)) or has_nested_anchors(v):
            # pushed to the front in reverse-sorted order like the reference's
            # PushFront over sorted keys
            front.insert(0, k)
        else:
            back.append(k)
    return front + back


def expand_metadata_wildcards(pattern_map: dict, resource_map: dict) -> dict:
    """Expand wildcard keys under metadata.labels / metadata.annotations of a
    pattern against the resource's actual keys
    (reference: pkg/engine/wildcards/wildcards.go:62 ExpandInMetadata)."""
    meta_key, pattern_meta = _get_pattern_value('metadata', pattern_map)
    if pattern_meta is None or not isinstance(pattern_meta, dict):
        return pattern_map
    resource_meta = resource_map.get('metadata')
    if not isinstance(resource_meta, dict):
        return pattern_map
    out_meta = dict(pattern_meta)
    changed = False
    for tag in ('labels', 'annotations'):
        pk, pdata = _get_string_map(tag, pattern_meta)
        _, rdata = _get_string_map(tag, resource_meta)
        if pdata is None or rdata is None:
            continue
        expanded = {}
        for k, v in pdata.items():
            if wildcard.contains_wildcard(k):
                a = anchor.parse(k)
                bare = a.key if a else k
                match_k = next((rk for rk in rdata if wildcard.match(bare, rk)), bare)
                expanded[f'{a.modifier}({match_k})' if a else match_k] = v
            else:
                expanded[k] = v
        out_meta[pk] = expanded
        changed = True
    if not changed:
        return pattern_map
    out = dict(pattern_map)
    out[meta_key] = out_meta
    return out


def _get_pattern_value(tag: str, pattern: dict):
    for k, v in pattern.items():
        if k == tag:
            return k, v
        a = anchor.parse(k)
        if a is not None and a.key == tag:
            return k, v
    return '', None


def _get_string_map(tag: str, data: Any):
    if not isinstance(data, dict):
        return '', None
    k, v = _get_pattern_value(tag, data)
    if not isinstance(v, dict):
        return '', None
    return k, {str(kk): str(vv) for kk, vv in v.items()}


def _type_name(v: Any) -> str:
    if v is None:
        return 'nil'
    return type(v).__name__


def _fmt(v: Any) -> str:
    if v is None:
        return '<nil>'
    if isinstance(v, bool):
        return 'true' if v else 'false'
    return str(v)
