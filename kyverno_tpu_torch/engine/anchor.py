"""Anchor grammar and map-level anchor handlers for pattern validation.

Anchor forms (reference: pkg/engine/anchor/anchor.go:10-19):
  ``(key)``   condition        — if key exists, its pattern must match, else the
                                 whole rule is *skipped* for this resource
  ``<(key)``  global condition — like condition but a failure skips the rule
                                 from anywhere in the tree
  ``^(key)``  existence        — at least one element of the resource list must
                                 match the pattern
  ``=(key)``  equality         — if key exists it must match (no skip)
  ``X(key)``  negation         — key must NOT exist; presence fails the rule
  ``+(key)``  add-if-not-present (mutation overlays only)

The handlers mirror pkg/engine/anchor/handlers.go and the anchor bookkeeping
mirrors pkg/engine/anchor/anchormap.go.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Optional, Tuple

CONDITION = ''
GLOBAL = '<'
NEGATION = 'X'
ADD_IF_NOT_PRESENT = '+'
EQUALITY = '='
EXISTENCE = '^'

_ANCHOR_RE = re.compile(r'^(?P<modifier>[+<=X^])?\((?P<key>.+)\)$')


class Anchor:
    __slots__ = ('modifier', 'key')

    def __init__(self, modifier: str, key: str):
        self.modifier = modifier
        self.key = key

    def __str__(self):
        return f'{self.modifier}({self.key})'


def parse(s: str) -> Optional[Anchor]:
    m = _ANCHOR_RE.match(s.strip())
    if not m:
        return None
    return Anchor(m.group('modifier') or '', m.group('key'))


def is_condition(a: Optional[Anchor]) -> bool:
    return a is not None and a.modifier == CONDITION


def is_global(a: Optional[Anchor]) -> bool:
    return a is not None and a.modifier == GLOBAL


def is_negation(a: Optional[Anchor]) -> bool:
    return a is not None and a.modifier == NEGATION


def is_equality(a: Optional[Anchor]) -> bool:
    return a is not None and a.modifier == EQUALITY


def is_existence(a: Optional[Anchor]) -> bool:
    return a is not None and a.modifier == EXISTENCE


def is_add_if_not_present(a: Optional[Anchor]) -> bool:
    return a is not None and a.modifier == ADD_IF_NOT_PRESENT


def contains_condition(a: Optional[Anchor]) -> bool:
    return a is not None and a.modifier in (CONDITION, GLOBAL)


def remove_anchor(key: str) -> Tuple[str, str]:
    """Return (bare key, modifier) for a possibly-anchored key."""
    a = parse(key)
    if a is None:
        return key, ''
    return a.key, a.modifier


# ---------------------------------------------------------------------------
# Errors used to steer the validate walk (skip vs fail semantics,
# reference: pkg/engine/validate/validate.go:58-66)

class ValidateError(Exception):
    """Plain validation failure."""

    def __init__(self, msg: str, path: str = ''):
        super().__init__(msg)
        self.path = path


class ConditionalAnchorError(ValidateError):
    """Condition anchor did not apply → rule is skipped."""


class GlobalAnchorError(ValidateError):
    """Global anchor did not apply → rule is skipped."""


class NegationAnchorError(ValidateError):
    """Negation anchor matched → rule fails."""


def is_skip_error(e: Exception) -> bool:
    return isinstance(e, (ConditionalAnchorError, GlobalAnchorError))


def is_fail_error(e: Exception) -> bool:
    return isinstance(e, NegationAnchorError)


class AnchorMap:
    """Tracks whether condition/existence/negation anchor keys appear in the
    resource (reference: pkg/engine/anchor/anchormap.go)."""

    def __init__(self):
        self.anchor_map: dict[str, bool] = {}
        self.anchor_error: Optional[ValidateError] = None

    def keys_are_missing(self) -> bool:
        return any(not v for v in self.anchor_map.values())

    def check_anchor_in_resource(self, pattern: dict, resource: Any):
        for key in pattern:
            a = parse(key)
            if is_condition(a) or is_existence(a) or is_negation(a):
                if self.anchor_map.get(key):
                    continue
                self.anchor_map.setdefault(key, False)
                if isinstance(resource, dict) and resource.get(a.key) is not None:
                    self.anchor_map[key] = True


def get_anchors_resources_from_map(pattern_map: dict) -> Tuple[dict, dict]:
    """Split a pattern map into {anchored keys} and {plain keys}.
    Condition/existence/equality/negation are 'anchors' for phase 1; global
    (and add-if-not-present) anchors are processed with the plain keys in
    phase 2, where globals are pushed to the front
    (reference: pkg/engine/anchor/utils.go:9 GetAnchorsResourcesFromMap)."""
    anchors, resources = {}, {}
    for key, value in pattern_map.items():
        a = parse(key)
        if is_condition(a) or is_existence(a) or is_equality(a) or is_negation(a):
            anchors[key] = value
        else:
            resources[key] = value
    return anchors, resources


# Handler type: fn(resource_element, pattern_element, origin_pattern, path, ac)
# raising ValidateError subclasses on mismatch.
ElementHandler = Callable[[Any, Any, Any, str, AnchorMap], None]


def handle_element(element_key: str, pattern: Any, path: str,
                   handler: ElementHandler, resource_map: dict,
                   origin_pattern: Any, ac: AnchorMap) -> None:
    """Dispatch one pattern-map entry against the resource map, applying the
    anchor semantics for its key (reference: pkg/engine/anchor/handlers.go:31)."""
    a = parse(element_key)
    if is_condition(a):
        current_path = path + a.key + '/'
        if a.key in resource_map:
            try:
                handler(resource_map[a.key], pattern, origin_pattern, current_path, ac)
            except ValidateError as e:
                err = ConditionalAnchorError(str(e), getattr(e, 'path', current_path))
                ac.anchor_error = err
                raise err from e
        else:
            raise ConditionalAnchorError(
                "conditional anchor key doesn't exist in the resource", current_path)
        return
    if is_global(a):
        current_path = path + a.key + '/'
        if a.key in resource_map:
            try:
                handler(resource_map[a.key], pattern, origin_pattern, current_path, ac)
            except ValidateError as e:
                err = GlobalAnchorError(str(e), getattr(e, 'path', current_path))
                ac.anchor_error = err
                raise err from e
        return
    if is_existence(a):
        _handle_existence(a, pattern, path, handler, resource_map, origin_pattern, ac)
        return
    if is_equality(a):
        current_path = path + a.key + '/'
        if a.key in resource_map:
            handler(resource_map[a.key], pattern, origin_pattern, current_path, ac)
        return
    if is_negation(a):
        current_path = path + a.key + '/'
        if a.key in resource_map:
            err = NegationAnchorError(f'{current_path} is not allowed', current_path)
            ac.anchor_error = err
            raise err
        return
    if is_add_if_not_present(a):
        return  # mutation-only anchor: no-op during validation
    # default (non-anchored) key
    current_path = path + element_key + '/'
    value = resource_map.get(element_key)
    if pattern == '*' and value is not None:
        return
    if pattern == '*' and value is None:
        raise ValidateError(f'{path}/{element_key} not found', path)
    handler(value, pattern, origin_pattern, current_path, ac)


def _handle_existence(a: Anchor, pattern: Any, path: str,
                      handler: ElementHandler, resource_map: dict,
                      origin_pattern: Any, ac: AnchorMap) -> None:
    # reference: pkg/engine/anchor/handlers.go:228
    current_path = path + a.key + '/'
    if a.key not in resource_map:
        return
    value = resource_map[a.key]
    if not isinstance(value, list):
        raise ValidateError(
            f'invalid resource type {type(value).__name__}: existence anchor '
            f'can only be used on list/array type resource', current_path)
    if not isinstance(pattern, list):
        raise ValidateError(
            'invalid pattern type: existence anchor pattern must be a list',
            current_path)
    for pattern_map in pattern:
        if not isinstance(pattern_map, dict):
            raise ValidateError(
                'invalid pattern type: existence anchor pattern elements must '
                'be maps', current_path)
        # at least one element of the resource list must satisfy the pattern
        satisfied = False
        for i, elem in enumerate(value):
            try:
                handler(elem, pattern_map, origin_pattern,
                        current_path + str(i) + '/', ac)
                satisfied = True
                break
            except ValidateError:
                continue
        if not satisfied:
            raise ValidateError(
                f'existence anchor validation failed at path {current_path}',
                current_path)
