"""Mutate-batch encoder: resources → per-(resource, edit-site) lanes.

Projects each resource onto the lowered edit-site table exactly the way
``compiler/encode.py`` projects onto the validate slot table: the
document itself never reaches the device — only the lanes the kernel's
comparisons read.  Per (resource, site):

  tag      i8   type tag of the leaf value (compiler.ir TAG_*)
  istate   i8   path-intermediate state: 0 = every intermediate is a
                map (leaf parent reached), 1 = a missing/null
                intermediate (the merge creates the path), 2 = a
                non-map intermediate (host fallback)
  milli    i64  leaf numeric value ×1000 (bool/int/float), exact only
  milli_ok bool
  slen     i32  utf-8 byte length of a string leaf
  sbytes   u8[W] first bytes of a string leaf (W sized to the longest
                string patch constant in the program)

Plus one per-resource lane:

  valid    bool row is a live resource (False = canonical-capacity
                padding; the kernel masks padding rows so their edit
                bitmasks and statuses are identically empty)

The walk mirrors ``mutate_compile._apply_sets``' decision loop byte for
byte — non-map intermediates, null-as-creatable intermediates, and the
leaf-parent map check — so a device verdict can only ever differ from
the host fast path by being *more* conservative (FALLBACK).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, Dict, List, Tuple

import numpy as np

from ..compiler.ir import (TAG_ARRAY, TAG_BOOL, TAG_FLOAT, TAG_INT,
                           TAG_MAP, TAG_MISSING, TAG_NULL, TAG_STRING)
from .plan import EditSite, MutateSetProgram

_INT64_MAX = (1 << 63) - 1

#: cap on the string-constant byte window (and so on sbytes memory)
MAX_STR_WINDOW = 256

_MISSING = object()


def exact_milli(value: Any):
    """``value * 1000`` as an exact int, or None when the value leaves
    the exact milli window (the device then cannot decide equality)."""
    if isinstance(value, bool):
        return 1000 if value else 0
    if isinstance(value, int):
        return value * 1000 if abs(value) <= _INT64_MAX // 1000 else None
    if isinstance(value, float):
        if not math.isfinite(value):
            return None
        frac = Fraction(str(value)) * 1000
        if frac.denominator == 1 and abs(frac.numerator) <= _INT64_MAX:
            return int(frac)
        return None
    return None


def string_window(program: MutateSetProgram) -> int:
    """Byte width of the shared string-constant lane, 8-aligned."""
    longest = 1
    for prog in program.programs:
        for site in prog.sites:
            if isinstance(site.value, str) and \
                    not isinstance(site.value, bool):
                longest = max(longest, len(site.value.encode('utf-8')))
    return min(MAX_STR_WINDOW, (longest + 7) & ~7)


def _walk_site(doc: dict, path: Tuple[str, ...]):
    """(istate, leaf_value) for one site path — the `_apply_sets`
    decision walk: isinstance check before descent, ``None``
    intermediates creatable, leaf parent must be a map."""
    cur: Any = doc
    for part in path[:-1]:
        if not isinstance(cur, dict):
            return 2, _MISSING
        cur = cur.get(part)
        if cur is None:
            return 1, _MISSING
    if not isinstance(cur, dict):
        return 2, _MISSING
    leaf = path[-1]
    if leaf not in cur:
        return 0, _MISSING
    return 0, cur[leaf]


def _leaf_tag(value: Any) -> int:
    if value is _MISSING:
        return TAG_MISSING
    if value is None:
        return TAG_NULL
    if isinstance(value, bool):
        return TAG_BOOL
    if isinstance(value, int):
        return TAG_INT
    if isinstance(value, float):
        return TAG_FLOAT
    if isinstance(value, str):
        return TAG_STRING
    if isinstance(value, dict):
        return TAG_MAP
    if isinstance(value, list):
        return TAG_ARRAY
    return TAG_MISSING


def encode_mutate_batch(resources: List[dict],
                        program: MutateSetProgram,
                        padded_n: int = 0,
                        width: int = 0) -> Dict[str, np.ndarray]:
    """Lane tensors for ``resources`` over the program's edit sites.
    ``padded_n`` is a canonical capacity (``compiler/shapes.py``):
    padding rows encode as all-MISSING and carry ``valid=False``, so
    the kernel's edit bitmasks ignore them entirely."""
    sites: List[EditSite] = [s for prog in program.programs
                             for s in prog.sites]
    n = max(len(resources), padded_n)
    s = len(sites)
    w = width or string_window(program)
    lanes = {
        'tag': np.zeros((n, s), np.int8),
        'istate': np.zeros((n, s), np.int8),
        'milli': np.zeros((n, s), np.int64),
        'milli_ok': np.zeros((n, s), bool),
        'slen': np.zeros((n, s), np.int32),
        'sbytes': np.zeros((n, s, w), np.uint8),
        'valid': np.arange(n) < len(resources),
    }
    for r, doc in enumerate(resources):
        for k, site in enumerate(sites):
            istate, value = _walk_site(doc, site.path)
            lanes['istate'][r, k] = istate
            tag = _leaf_tag(value)
            lanes['tag'][r, k] = tag
            if tag in (TAG_BOOL, TAG_INT, TAG_FLOAT):
                m = exact_milli(value)
                if m is not None:
                    lanes['milli'][r, k] = m
                    lanes['milli_ok'][r, k] = True
            elif tag == TAG_STRING:
                b = value.encode('utf-8')
                lanes['slen'][r, k] = len(b)
                head = b[:w]
                if head:
                    lanes['sbytes'][r, k, :len(head)] = \
                        np.frombuffer(head, np.uint8)
    return lanes
