"""Batch encoder v2: resources → fixed-shape slot + gather tensors.

Projects each resource onto the compiled slot table and evaluates gather
expressions with the in-repo JMESPath interpreter (the document itself
never reaches the device).  Encoding is conservative toward UNKNOWN: any
value the encoder cannot represent exactly sets flags that make the
device evaluator emit STATUS_HOST, after which the host engine re-runs
that (resource, rule) pair — correctness is never lost.

Lane schema (shared by slots and gather elements; shapes are [R],
[R, E], [R, E, E2] for slots by star-depth, [R, G] for gathers):
  tag        i8   type tag (ir.TAG_*)
  milli      i64  numeric value ×1000 (ints exact; quantity strings)
  milli_ok   bool milli lane is exact
  nanos      i64  Go duration in ns (strings with units)
  nanos_ok   bool
  str_is_int / str_is_float / str_is_qty / str_is_dur   bool
  has_wild   bool value's string form contains * or ? (gathers only)
  str_len    i32  byte length of the value's string form
  str_head   u8[STR_LEN]  first bytes
  str_tail   u8[TAIL_LEN] last bytes, right-aligned
Array nodes referenced by forall/exists additionally get, keyed by path:
  count      i32  number of elements (clamped to MAX_ELEMS)
  overflow   bool more than MAX_ELEMS elements → device UNKNOWN
Gathers additionally get:
  kind       i8   0 = null/absent, 1 = scalar, 2 = list
  count      i32
  overflow   bool
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.duration import parse_duration
from ..utils.quantity import Quantity
from ..utils.wildcard import match as _wild_match
from .ir import (MAX_ELEMS, MAX_GATHER, STR_LEN, TAG_ARRAY, TAG_BOOL,
                 TAG_FLOAT, TAG_INT, TAG_MAP, TAG_MISSING, TAG_NULL,
                 TAG_STRING, TAIL_LEN, CompiledPolicySet, GatherSlot, Slot,
                 StatusExpr)

_INT64_MAX = (1 << 63) - 1

_MISSING = object()

# Per-slot/gather lane requirements, computed from exactly the ops the
# evaluator performs against it (ops/eval.py read-set).  ``head`` is the
# byte width of the string-head window — sized to the longest constant a
# comparison needs, not a fixed 64 — which is the dominant memory/transfer
# term of the encoded batch.
@dataclass
class LaneNeeds:
    head: int = 0
    tail: bool = False
    length: bool = False
    milli: bool = False
    nanos: bool = False
    wild: bool = False
    lit_zero: bool = False

    def merge(self, other: 'LaneNeeds') -> None:
        self.head = max(self.head, other.head)
        self.tail = self.tail or other.tail
        self.length = self.length or other.length
        self.milli = self.milli or other.milli
        self.nanos = self.nanos or other.nanos
        self.wild = self.wild or other.wild
        self.lit_zero = self.lit_zero or other.lit_zero

    def add_pattern(self, pattern: str) -> None:
        """Lanes read by a constant glob comparison (ir.classify_wildcard
        keeps this in sync with eval._View.match_const_pattern)."""
        from .ir import classify_wildcard
        kind, parts = classify_wildcard(pattern)
        if kind == 'eq':
            self.head = max(self.head, len(parts[0].encode('utf-8')))
            self.length = True
        elif kind == 'nonempty':
            self.length = True
        elif kind == 'prefix':
            self.head = max(self.head, len(parts[0].encode('utf-8')))
            self.length = True
        elif kind == 'suffix':
            self.tail = True
            self.length = True
        elif kind == 'prefix_suffix':
            self.head = max(self.head, len(parts[0].encode('utf-8')))
            self.tail = True
            self.length = True
        elif kind == 'dp':
            self.head = STR_LEN
            self.length = True
        # 'any' reads only the tag


def _go_float_str(v: float) -> str:
    from ..engine.pattern import _go_format_float_e
    return _go_format_float_e(v)


def _sprint(v: Any) -> str:
    """Go fmt.Sprint for scalars (operators.py:_sprint)."""
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, float):
        if v == int(v) and abs(v) < 1e21:
            return str(int(v))
        return repr(v)
    return str(v)


class Lanes:
    """numpy lane arrays for one slot or gather at a given shape, sized to
    exactly the lanes (and head byte width) its comparisons read."""

    def __init__(self, shape: Tuple[int, ...], needs: LaneNeeds):
        self.needs = needs
        self.tag = np.zeros(shape, np.int8)
        z64 = lambda: np.zeros(shape, np.int64)  # noqa: E731
        zb = lambda: np.zeros(shape, bool)       # noqa: E731
        self.milli = z64() if needs.milli else None
        self.milli_ok = zb() if needs.milli else None
        self.nanos = z64() if needs.nanos else None
        self.nanos_ok = zb() if needs.nanos else None
        # the string-parse flags ride with the numeric bundle that gates
        # on them (eq_int/str_is_qty read milli; str_is_dur reads nanos)
        self.str_is_int = zb() if needs.milli else None
        self.str_is_float = zb() if needs.milli else None
        self.str_is_qty = zb() if needs.milli else None
        self.str_is_dur = zb() if needs.nanos else None
        self.lit_zero = zb() if needs.lit_zero else None
        if needs.length or needs.head or needs.tail:
            self.str_len = np.zeros(shape, np.int32)
        else:
            self.str_len = None
        if needs.head:
            # round the head window up for alignment / fewer pack groups
            w = min(STR_LEN, (needs.head + 7) & ~7)
            self.str_head = np.zeros(shape + (w,), np.uint8)
        else:
            self.str_head = None
        self.str_tail = np.zeros(shape + (TAIL_LEN,), np.uint8) \
            if needs.tail else None
        self.has_wild = zb() if needs.wild else None

    _LANE_NAMES = ('tag', 'milli', 'milli_ok', 'nanos', 'nanos_ok',
                   'str_is_int', 'str_is_float', 'str_is_qty', 'str_is_dur',
                   'lit_zero', 'str_len', 'str_head', 'str_tail', 'has_wild')

    def tensors(self, prefix: str) -> Dict[str, np.ndarray]:
        out = {}
        for name in self._LANE_NAMES:
            v = getattr(self, name)
            if v is not None:
                out[f'{prefix}_{name}'] = v
        return out

    def clear(self) -> None:
        """Zero every lane in place (arena reuse between chunks)."""
        for name in self._LANE_NAMES:
            v = getattr(self, name)
            if v is not None:
                v.fill(0)

    def encode_column(self, idx, values: list, palette: '_Palette') -> None:
        """Columnar encode: dictionary-encode ``values`` through
        ``palette`` (one scalar :meth:`encode` per DISTINCT value, ever)
        and scatter the palette rows into the lanes with one vectorized
        assignment per lane.  ``idx`` is ``None`` for a full leading-
        rows column (rows ``0..len(values)``) or a tuple of equal-length
        index arrays for element-scoped columns."""
        if not values:
            return
        with palette.lock:
            codes = palette.codes_for(values)
            src = palette.lanes
            m = len(values)
            for name in self._LANE_NAMES:
                dst = getattr(self, name)
                if dst is None:
                    continue
                s = getattr(src, name)
                if idx is None:
                    dst[:m] = s[codes]
                else:
                    dst[idx] = s[codes]

    # -- value encoding ------------------------------------------------------

    def encode(self, idx, value: Any, string_form: Optional[str] = None,
               sprint_form: bool = False) -> None:
        """Encode one scalar value at ``idx``.

        ``sprint_form`` selects the operators' Go string form (gathers)
        over the pattern walk's float formatting (slots).
        """
        if value is _MISSING:
            self.tag[idx] = TAG_MISSING
            return
        if value is None:
            self.tag[idx] = TAG_NULL
            if self.milli is not None:
                self.milli_ok[idx] = True
            if self.nanos is not None:
                self.nanos_ok[idx] = True
            return
        if isinstance(value, bool):
            self.tag[idx] = TAG_BOOL
            if self.milli is not None:
                self.milli[idx] = 1000 if value else 0
                self.milli_ok[idx] = True
            if self.str_len is not None:
                self._encode_str(idx, 'true' if value else 'false')
            return
        if isinstance(value, int):
            self.tag[idx] = TAG_INT
            if self.milli is not None and abs(value) <= _INT64_MAX // 1000:
                self.milli[idx] = value * 1000
                self.milli_ok[idx] = True
            if self.nanos is not None and value == 0:
                # _number_to_string(0) == '0' parses as Go duration 0
                self.nanos_ok[idx] = True
            if self.str_len is not None:
                self._encode_str(idx, str(value))
            if self.str_is_int is not None:
                self.str_is_int[idx] = True
                self.str_is_float[idx] = True
            return
        if isinstance(value, float):
            self.tag[idx] = TAG_FLOAT
            if self.milli is not None and math.isfinite(value):
                frac = Fraction(str(value)) * 1000
                if frac.denominator == 1 and abs(frac.numerator) <= _INT64_MAX:
                    self.milli[idx] = int(frac)
                    self.milli_ok[idx] = True
            if self.str_len is not None:
                self._encode_str(
                    idx, _sprint(value) if sprint_form
                    else _go_float_str(value))
            if self.str_is_float is not None:
                self.str_is_float[idx] = True
            return
        if isinstance(value, str):
            self.tag[idx] = TAG_STRING
            if self.str_len is not None:
                self._encode_str(idx, value)
            if self.lit_zero is not None and value == '0':
                self.lit_zero[idx] = True
            if self.str_is_int is not None:
                try:
                    int(value, 10)
                    self.str_is_int[idx] = True
                    self.str_is_float[idx] = True
                except ValueError:
                    try:
                        float(value)
                        self.str_is_float[idx] = True
                    except ValueError:
                        pass
            if self.has_wild is not None:
                self.has_wild[idx] = ('*' in value) or ('?' in value)
            if self.milli is not None:
                try:
                    q = Quantity.parse(value)
                except ValueError:
                    # int()-parseable strings the quantity grammar rejects
                    # (' 5', '5_0') still feed eq_int via the milli lane
                    try:
                        iv = int(value, 10)
                    except ValueError:
                        pass
                    else:
                        if abs(iv) <= _INT64_MAX // 1000:
                            self.milli[idx] = iv * 1000
                            self.milli_ok[idx] = True
                else:
                    if self.str_is_qty is not None:
                        self.str_is_qty[idx] = True
                    m = q.value * 1000
                    if m.denominator == 1 and abs(m.numerator) <= _INT64_MAX:
                        self.milli[idx] = int(m)
                        self.milli_ok[idx] = True
            if self.nanos is not None:
                try:
                    ns = parse_duration(value)
                except ValueError:
                    pass
                else:
                    if self.str_is_dur is not None:
                        self.str_is_dur[idx] = True
                    # str_is_dur without nanos_ok = parsed but out of the
                    # int64 lane → undecidable on device
                    if abs(ns) <= _INT64_MAX:
                        self.nanos[idx] = ns
                        self.nanos_ok[idx] = True
            return
        if isinstance(value, dict):
            self.tag[idx] = TAG_MAP
            return
        if isinstance(value, list):
            self.tag[idx] = TAG_ARRAY
            return
        self.tag[idx] = TAG_MISSING

    def _encode_str(self, idx, s: str) -> None:
        b = s.encode('utf-8')
        self.str_len[idx] = len(b)
        if self.str_head is not None:
            w = self.str_head.shape[-1]
            head = b[:w]
            self.str_head[idx][:len(head)] = np.frombuffer(head, np.uint8)
        if self.str_tail is not None:
            tail = b[-TAIL_LEN:]
            self.str_tail[idx][TAIL_LEN - len(tail):] = \
                np.frombuffer(tail, np.uint8)


# ---------------------------------------------------------------------------
# columnar dictionary encoding: one scalar encode per DISTINCT value

#: singleton palette keys for the classes whose encoding ignores the
#: value (encode() writes only the type tag for these)
_KEY_MAP = ('__map__',)
_KEY_ARR = ('__array__',)
_KEY_OTHER = ('__other__',)
_KEY_NONE = ('__null__',)
_KEY_MISSING = ('__missing__',)


class _Palette:
    """Dictionary encoder for one lane column (slot or gather).

    Values in a policy-scan batch repeat massively — image names,
    booleans, quantity strings, label values — so the palette runs the
    scalar :meth:`Lanes.encode` once per distinct value and remembers
    the encoded lane row; subsequent chunks pay one dict lookup per
    value instead of a dozen numpy scalar writes.  Palettes persist
    across chunks on the :class:`LaneArena`, so a steady-state stream
    encodes almost entirely through vectorized gathers."""

    __slots__ = ('lanes', 'needs', 'sprint', 'codes', 'cap', 'lock')

    #: distinct-value bound: a column exceeding it (adversarial
    #: high-cardinality values) resets rather than growing unbounded
    MAX_ENTRIES = 65536

    def __init__(self, needs: LaneNeeds, sprint: bool):
        self.needs = needs
        self.sprint = sprint
        self.cap = 64
        self.lanes = Lanes((self.cap,), needs)
        self.codes: Dict[tuple, int] = {}
        self.lock = __import__('threading').Lock()

    def _grow(self) -> None:
        new_cap = self.cap * 2
        new = Lanes((new_cap,), self.needs)
        for name in Lanes._LANE_NAMES:
            src = getattr(self.lanes, name)
            if src is not None:
                getattr(new, name)[:self.cap] = src
        self.lanes = new
        self.cap = new_cap

    def _key(self, value: Any) -> tuple:
        # mirrors the isinstance ladder of Lanes.encode exactly: two
        # values share a palette row only when encode() cannot tell
        # them apart
        if value is _MISSING:
            return _KEY_MISSING
        if value is None:
            return _KEY_NONE
        if isinstance(value, bool):
            return (bool, value)
        if isinstance(value, int):
            return (int, value)
        if isinstance(value, float):
            # repr distinguishes -0.0 from 0.0 (their Go string forms
            # differ) and collapses every NaN onto one row
            return (float, repr(value))
        if isinstance(value, str):
            return (str, value)
        if isinstance(value, dict):
            return _KEY_MAP
        if isinstance(value, list):
            return _KEY_ARR
        return _KEY_OTHER

    def code(self, value: Any) -> int:
        key = self._key(value)
        c = self.codes.get(key)
        if c is None:
            if len(self.codes) >= self.MAX_ENTRIES:
                self.codes.clear()
                self.lanes.clear()
            c = len(self.codes)
            if c >= self.cap:
                self._grow()
            self.lanes.encode(c, value, sprint_form=self.sprint)
            self.codes[key] = c
        return c

    def codes_for(self, values: list) -> np.ndarray:
        return np.fromiter(map(self.code, values), np.intp,
                           count=len(values))


class LaneArena:
    """Bounded pool of reusable encode buffers plus the cross-chunk
    palettes for one compiled policy set.

    The streaming scan pipeline holds a small fixed number of chunks in
    flight; the arena recycles their lane tensors (zeroed in place)
    instead of allocating ~100MB of numpy arrays per chunk, which is
    what kept the 1M-resource path allocating monotonically.  A batch
    is released back only after its device inputs are freed (d2h
    complete), so a zero-copy host-to-device path can never observe a
    recycled buffer."""

    def __init__(self, max_pool: int = 4):
        #: buffers kept per shape key; 0 = palettes only (forked encode
        #: workers pickle tensors after return, so recycling there could
        #: zero a buffer mid-serialization)
        self.max_pool = max_pool
        self._lock = __import__('threading').Lock()
        self._free: Dict[tuple, List['Batch']] = {}
        self._palettes: Dict[tuple, _Palette] = {}

    def palette(self, key: tuple, needs: LaneNeeds,
                sprint: bool) -> _Palette:
        with self._lock:
            pal = self._palettes.get(key)
            if pal is None:
                pal = self._palettes[key] = _Palette(needs, sprint)
            return pal

    def acquire(self, key: tuple) -> Optional['Batch']:
        with self._lock:
            pool = self._free.get(key)
            if pool:
                return pool.pop()
        return None

    def release(self, batch: 'Batch') -> None:
        key = getattr(batch, 'arena_key', None)
        if key is None:
            return
        with self._lock:
            pool = self._free.setdefault(key, [])
            if len(pool) < self.max_pool:
                pool.append(batch)


# ---------------------------------------------------------------------------
# need analysis: which lanes each slot/gather requires (mirrors the exact
# read-set of ops/eval.py for each leaf op / condition check)

def _blen(s: str) -> int:
    # floor 1: ops that compare against '' still read the str_head lane
    # (eval.py eq_const), so the window must exist even for empty
    # constants
    return min(max(len(s.encode('utf-8')), 1), STR_LEN)


def _leaf_needs(op: str, operand: Any) -> LaneNeeds:
    n = LaneNeeds()
    if op in ('eq_bool', 'eq_int', 'eq_float', 'cmp_qty',
              'is_true', 'is_false', 'is_zero_num'):
        n.milli = True
    if op == 'truthy':
        n.milli = True
        n.length = True
    if op == 'eq_null':
        n.milli = True
        n.length = True
    if op == 'cmp_dur':
        n.nanos = True
    if op in ('eq_str', 'prefix'):
        n.head = _blen(operand)
        n.length = True
    if op == 'suffix':
        n.tail = True
        n.length = True
    if op in ('min_len', 'nonempty'):
        n.length = True
    if op == 'wildcard':
        n.head = STR_LEN
        n.length = True
    return n


_IN_FAMILY = ('in', 'anyin', 'allin', 'notin', 'anynotin', 'allnotin')


def _cond_needs(check) -> LaneNeeds:
    """Gather lanes read by one condition check (ops/eval.py cond_tf)."""
    from ..engine import pattern as leaf_pattern
    n = LaneNeeds()
    op = check.op
    if op in ('equal', 'equals', 'notequal', 'notequals'):
        if check.list_value:
            for cv in check.values:
                if isinstance(cv, str):
                    n.head = max(n.head, _blen(cv))
                    n.length = True
                elif isinstance(cv, (bool, int, float)):
                    n.milli = True
        else:
            v = check.values[0]
            if isinstance(v, bool):
                n.milli = True
            elif isinstance(v, (int, float)):
                n.milli = True
                n.nanos = True
                n.lit_zero = True
            elif isinstance(v, str):
                n.milli = True
                n.nanos = True
                n.lit_zero = True
                n.length = True
                n.head = max(n.head, _blen(v))
                n.add_pattern(v)
    elif op in _IN_FAMILY:
        if check.list_value:
            n.wild = True
            n.length = True
            for cv in check.values:
                vs = cv if isinstance(cv, str) else _sprint(cv)
                n.add_pattern(vs)
                n.head = max(n.head, _blen(vs))
        else:
            v = check.values[0]
            if isinstance(v, str):
                n.length = True
                n.head = max(n.head, _blen(v))
                n.add_pattern(v)
                if leaf_pattern.get_operator_from_string_pattern(v) == \
                        leaf_pattern.OP_IN_RANGE:
                    n.milli = True
                    n.nanos = True
                else:
                    # list keys run _both_dir_member over the parsed
                    # JSON elements (or [v] itself): wildcard matching in
                    # both directions needs has_wild plus the per-element
                    # pattern windows (eval.py _in_family_tf)
                    n.wild = True
                    import json as _json
                    try:
                        arr = _json.loads(v)
                    except ValueError:
                        arr = None
                    elems = [x for x in arr if isinstance(x, str)] \
                        if isinstance(arr, list) else [v]
                    for x in elems:
                        n.head = max(n.head, _blen(x))
                        n.add_pattern(x)
    else:  # numeric comparisons
        n.milli = True
        n.nanos = True
        n.lit_zero = True
    return n


def _cond_b_needs(check) -> LaneNeeds:
    """Value-gather lanes read by a mode-B check (const key vs gather
    value; ops/eval.py _cond_b_tf)."""
    n = LaneNeeds()
    key = check.key_const
    op = check.op
    if op in ('equal', 'equals', 'notequal', 'notequals'):
        if isinstance(key, bool):
            n.milli = True
        elif isinstance(key, (int, float)):
            n.milli = True
        elif isinstance(key, str):
            n.milli = True
            n.nanos = True
            n.lit_zero = True
            n.length = True
            n.wild = True
            n.head = max(n.head, _blen(key))
    else:  # in-family with scalar const key
        ks = key if isinstance(key, str) else _sprint(key)
        n.length = True
        n.wild = True
        # the scalar-value suspicion scan marks values longer than the
        # window as undecidable (host re-run), so a narrow head suffices
        n.head = max(16, _blen(ks))
        n.add_pattern(ks)
    return n


def _analyze_needs(cps: CompiledPolicySet):
    slot_needs: Dict[Slot, LaneNeeds] = {s: LaneNeeds() for s in cps.slots}
    gather_needs: Dict[GatherSlot, LaneNeeds] = \
        {g: LaneNeeds() for g in cps.gathers}
    elem_needs: Dict = {g: LaneNeeds() for g in cps.elem_gathers}
    array_paths: set = set()

    def visit_bool(expr):
        if expr is None:
            return
        if expr.kind == 'leaf':
            leaf = expr.leaf
            if leaf.op == 'true':
                return
            n = slot_needs.setdefault(leaf.slot, LaneNeeds())
            n.merge(_leaf_needs(leaf.op, leaf.operand))
            return
        if expr.kind == 'cond':
            check = expr.cond
            if check.value_gather is not None:
                n = elem_needs.setdefault(check.value_gather, LaneNeeds())
                n.merge(_cond_b_needs(check))
                return
            from .ir import ElemGather
            table = elem_needs if isinstance(check.gather, ElemGather) \
                else gather_needs
            n = table.setdefault(check.gather, LaneNeeds())
            n.merge(_cond_needs(check))
            return
        if expr.kind in ('any_elem', 'all_elem') and expr.slot is not None:
            array_paths.add(expr.slot.path)
        for c in expr.children:
            visit_bool(c)

    def visit_status(node: StatusExpr):
        if node is None:
            return
        visit_bool(node.expr)
        if node.kind == 'foreach':
            for entry in node.operand or ():
                if entry.precond is not None:
                    visit_bool(entry.precond)
                visit_bool(entry.deny)
        if node.kind in ('forall', 'exists', 'scalars') and \
                node.slot is not None:
            array_paths.add(node.slot.path)
        if node.sub is not None:
            visit_status(node.sub)
        for c in node.children:
            visit_status(c)

    for prog in cps.programs:
        visit_status(prog.status)
        # trackfail guards reduce element-scoped presence tests over the
        # containers along the slot path — those need count/overflow too
        def visit_guards(node: StatusExpr):
            if node is None:
                return
            if node.kind == 'trackfail' and node.expr is not None:
                def leaf_paths(e):
                    if e.kind == 'leaf' and e.leaf.slot.elem:
                        path = e.leaf.slot.path
                        for i, p in enumerate(path):
                            if p == '*':
                                array_paths.add(path[:i])
                    for c in e.children:
                        leaf_paths(c)
                leaf_paths(node.expr)
            if node.sub is not None:
                visit_guards(node.sub)
            for c in node.children:
                visit_guards(c)
        visit_guards(prog.status)
    # deterministic order shared by the encoder and the evaluator
    return slot_needs, gather_needs, elem_needs, sorted(array_paths)


# ---------------------------------------------------------------------------

def _walk(doc: Any, path: Tuple[str, ...]):
    cur = doc
    for key in path:
        if isinstance(cur, dict):
            if key.startswith('\x00'):
                # wildcard pattern-key segment (compile.WILD_KEY_MARK):
                # descend into the FIRST key matching the pattern, in
                # document order — mirrors ExpandInMetadata's
                # first-match rewrite (validate_pattern.py:202)
                pat = key[4:]
                for rk in cur:
                    if _wild_match(pat, str(rk)):
                        cur = cur[rk]
                        break
                else:
                    return _MISSING
                continue
            if key not in cur:
                return _MISSING
            cur = cur[key]
        else:
            return _MISSING
    return cur


class Batch:
    def __init__(self, n: int, row_count: Optional[int] = None):
        self.n = n
        #: live rows; rows [row_count, n) are canonical-capacity padding
        self.row_count = n if row_count is None else row_count
        #: set when the batch came from a LaneArena pool (recycle key)
        self.arena_key: Optional[tuple] = None
        self.slot_lanes: Dict[Slot, Lanes] = {}
        self.array_meta: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
        self.gather_lanes: Dict[GatherSlot, Lanes] = {}
        self.gather_meta: Dict[GatherSlot, Dict[str, np.ndarray]] = {}
        self.elem_lanes: Dict[Any, Lanes] = {}
        self.elem_meta: Dict[Any, Dict[str, np.ndarray]] = {}

    def clear(self) -> None:
        """Zero every tensor in place for arena reuse."""
        for lanes in self.slot_lanes.values():
            lanes.clear()
        for lanes in self.gather_lanes.values():
            lanes.clear()
        for lanes in self.elem_lanes.values():
            lanes.clear()
        for meta in self.array_meta.values():
            for arr in meta.values():
                arr.fill(0)
        for meta in self.gather_meta.values():
            for arr in meta.values():
                arr.fill(0)
        for meta in self.elem_meta.values():
            for arr in meta.values():
                arr.fill(0)

    def tensors(self) -> Dict[str, np.ndarray]:
        # the row-validity lane rides with every batch: the ragged
        # evaluator masks the capacity-padding tail rows inside the
        # jitted program (cross-row reductions — the mesh verdict
        # summary, the compact fail-detail selection — must never read
        # them), so one compiled capacity serves every occupancy
        out: Dict[str, np.ndarray] = {
            '__rowvalid__':
                (np.arange(self.n) < self.row_count).astype(np.int8)}
        for i, (slot, lanes) in enumerate(self.slot_lanes.items()):
            out.update(lanes.tensors(f's{i}'))
        for j, (path, meta) in enumerate(self.array_meta.items()):
            out[f'a{j}_count'] = meta['count']
            out[f'a{j}_overflow'] = meta['overflow']
            out[f'a{j}_tag'] = meta['tag']
        for k, (g, lanes) in enumerate(self.gather_lanes.items()):
            out.update(lanes.tensors(f'g{k}'))
            meta = self.gather_meta[g]
            out[f'g{k}_kind'] = meta['kind']
            out[f'g{k}_count'] = meta['count']
            out[f'g{k}_overflow'] = meta['overflow']
            out[f'g{k}_notfound'] = meta['notfound']
        for k, (g, lanes) in enumerate(self.elem_lanes.items()):
            out.update(lanes.tensors(f'e{k}'))
            meta = self.elem_meta[g]
            out[f'e{k}_kind'] = meta['kind']
            out[f'e{k}_count'] = meta['count']
            out[f'e{k}_overflow'] = meta['overflow']
            out[f'e{k}_notfound'] = meta['notfound']
        return out


def _pow2_clamp(v: int, lo: int, hi: int) -> int:
    v = max(v, 1)
    return max(lo, min(hi, 1 << (v - 1).bit_length()))


def _container_paths(cps: CompiledPolicySet, array_paths) -> List[Tuple]:
    """All '*'-container prefixes referenced by slots or array nodes."""
    out = set()
    for slot in cps.slots:
        for i, p in enumerate(slot.path):
            if p == '*':
                out.add(slot.path[:i])
    for path in array_paths:
        for i, p in enumerate(path):
            if p == '*':
                out.add(path[:i])
        out.add(path)
    return sorted(out)


def _measure_elems(resources: List[dict], containers: List[Tuple]) -> int:
    """Longest list under any container path (for the element width)."""
    longest = 1
    for doc in resources:
        for path in containers:
            if '*' in path:
                star = path.index('*')
                outer = _walk(doc, path[:star])
                if not isinstance(outer, list):
                    continue
                rest = path[star + 1:]
                for elem in outer[:MAX_ELEMS]:
                    v = _walk(elem, rest) if isinstance(elem, dict) else None
                    if isinstance(v, list):
                        longest = max(longest, len(v))
            else:
                v = _walk(doc, path)
                if isinstance(v, list):
                    longest = max(longest, len(v))
    return longest


def _has_null_dict_value(v) -> bool:
    """True when RFC-7386 merging would change ``v`` — i.e. some dict
    reachable through dicts has a None value (merge_patch does not
    descend into lists)."""
    if isinstance(v, dict):
        for x in v.values():
            if x is None or _has_null_dict_value(x):
                return True
    return False


def encode_batch(resources: List[dict], cps: CompiledPolicySet,
                 padded_n: int = 0,
                 contexts: Optional[List[dict]] = None,
                 arena: Optional[LaneArena] = None) -> Batch:
    """``contexts`` overrides the per-resource gather context (admission
    scans thread operation/userInfo/oldObject through; defaults to the
    background-scan context {'request': {'object': doc}}).

    ``padded_n`` is a *capacity*: rows [len(resources), padded_n) stay
    all-TAG_MISSING and are marked invalid on the ``__rowvalid__`` lane
    (callers draw it from the canonical shape table —
    ``compiler/shapes.py`` — so XLA only ever sees those shapes).

    ``arena`` recycles lane tensors across chunks and keeps the
    cross-chunk value palettes (columnar dictionary encoding); without
    one, an ephemeral arena serves this call only.  Encoding is
    column-major throughout: per-slot value columns are extracted with
    one dict-walk pass, dictionary-encoded, and scattered into the
    preallocated lanes — no per-row intermediate dicts or per-cell
    numpy writes on the hot path."""
    n = max(len(resources), padded_n)
    n_rows = len(resources)
    slot_needs, gather_needs, elem_needs, array_paths = _needs_cached(cps)
    pooled = arena is not None
    if arena is None:
        arena = LaneArena()

    # element width: sized to the longest observed list (pow-2 clamped) —
    # real batches rarely approach MAX_ELEMS, and the element axis
    # multiplies every element-scoped lane's bytes
    containers = _container_paths(cps, array_paths)
    elems = _pow2_clamp(_measure_elems(resources, containers), 4, MAX_ELEMS)

    # gather projections are evaluated against the same RFC-7386
    # merge-patched context the host Context builds (null-valued map keys
    # stripped; engine/context.py:36 merge_patch) — a variable resolving
    # to an explicit null must raise NotFound exactly like the host.
    # Background scans reuse ONE shared context dict across rows (its
    # inner request.object is repointed per row), so the hot path builds
    # no per-row context dicts.
    from ..engine.context import merge_patch

    def _merged(doc: dict) -> dict:
        # merge_patch only rewrites dicts (lists pass by reference), so
        # a doc with no null dict values merges to an equal structure —
        # skip the rebuild, which otherwise dominates context setup
        return merge_patch({}, doc) if _has_null_dict_value(doc) else doc

    searchers = [(g, _gather_searcher(g)) for g in cps.gathers]
    gather_results: Dict[GatherSlot, list] = \
        {g: [None] * n_rows for g in cps.gathers}
    bases: Optional[List[dict]] = None
    if searchers or cps.elem_gathers:
        if contexts is not None:
            bases = [_merged(c) for c in contexts]
        else:
            shared_inner: Dict[str, Any] = {'object': None}
            shared_ctx = {'request': shared_inner}
        for r in range(n_rows):
            if bases is not None:
                ctx = bases[r]
            else:
                shared_inner['object'] = _merged(resources[r])
                ctx = shared_ctx
            for g, searcher in searchers:
                gather_results[g][r] = _run_gather_ctx(searcher, ctx)
    longest_g = 1
    for results in gather_results.values():
        for marker, value in results:
            if marker == 'list':
                longest_g = max(longest_g, len(value))
    gwidth = _pow2_clamp(longest_g, 4, MAX_GATHER)

    # foreach element gathers: evaluate each expr per element of its list
    # (reusing the list gather's results) under the element context the
    # host injects (engine/context.py:109 add_element)
    elem_results: Dict[Any, List[List[Tuple[str, Any]]]] = {}
    longest_eg = 1
    # background scans reuse one shared base context across rows here
    # too (its inner request.object repoints per row)
    eshared_inner: Dict[str, Any] = {'object': None}
    eshared_ctx = {'request': eshared_inner}
    for eg in cps.elem_gathers:
        searcher = _gather_searcher(GatherSlot(eg.expr))
        lres = gather_results.get(GatherSlot(eg.list_expr))
        per_resource: List[List[Tuple[str, Any]]] = []
        for r in range(n_rows):
            marker, value = lres[r]
            if marker == 'list':
                elements = value
            elif marker == 'scalar':
                elements = [value]
            else:
                per_resource.append([])
                continue
            if bases is not None:
                base = bases[r]
            else:
                eshared_inner['object'] = _merged(resources[r])
                base = eshared_ctx
            row: List[Tuple[str, Any]] = []
            for fe, elem in enumerate(elements[:gwidth]):
                if elem is None:
                    row.append(('null', None))
                    continue
                # element context merges over the base like the host's
                # add_element (context.py:109) — nulls stripped again;
                # the merge only rewrites the element subtree, so build
                # the top level directly and strip just the element
                # ktpu: noqa[KTPU205] -- merge_patch needs a fresh
                # accumulator; only elements carrying explicit nulls
                # (rare) take this branch
                stripped = merge_patch({}, elem) \
                    if _has_null_dict_value(elem) else elem
                # ktpu: noqa[KTPU205] -- the per-element context IS the
                # engine's add_element semantics (one injected context
                # per foreach element); foreach gathers are off the
                # streaming fast path
                ctx = {**base,
                       'element': stripped, 'element0': stripped,
                       'elementIndex': fe, 'elementIndex0': fe}
                m2, v2 = _run_gather_ctx(searcher, ctx)
                if m2 == 'list':
                    longest_eg = max(longest_eg, len(v2))
                row.append((m2, v2))
            per_resource.append(row)
        elem_results[eg] = per_resource
    egwidth = _pow2_clamp(longest_eg, 4, MAX_GATHER)

    key = (n, elems, gwidth, egwidth)
    batch = arena.acquire(key) if pooled else None
    if batch is None:
        batch = _build_batch(cps, n, elems, gwidth, egwidth, slot_needs,
                             gather_needs, elem_needs, array_paths)
        if pooled:
            batch.arena_key = key
    else:
        batch.clear()
    batch.row_count = n_rows
    batch.elems = elems
    batch.gather_width = gwidth
    batch.elem_gather_width = egwidth

    plan0, groups, metas = _slot_plan_cached(cps)

    # array metadata channels (count/overflow/tag), column-wise
    for full, prefix, rest in metas:
        meta = batch.array_meta[full]
        if rest is None:
            vals = [_walk(doc, prefix) for doc in resources]
            _set_array_meta_column(meta, None, vals, elems)
        else:
            r_idx: List[int] = []
            e_idx: List[int] = []
            vals = []
            for r, doc in enumerate(resources):
                container = _walk(doc, prefix)
                if not isinstance(container, list):
                    continue
                for e, elem in enumerate(container[:elems]):
                    r_idx.append(r)
                    e_idx.append(e)
                    vals.append(_walk(elem, rest)
                                if isinstance(elem, dict) else _MISSING)
            if vals:
                _set_array_meta_column(
                    meta, (np.asarray(r_idx, np.intp),
                           np.asarray(e_idx, np.intp)), vals, elems)

    # scalar slots: one value column per slot
    for path, slot in plan0:
        lanes = batch.slot_lanes[slot]
        vals = [_walk(doc, path) for doc in resources]
        lanes.encode_column(None, vals,
                            arena.palette(('s', slot), lanes.needs, False))

    # element slots: each container (and each element) is visited once
    # for all the slots under it; values land in per-slot columns
    for prefix, g in groups.items():
        d1, d2 = g['d1'], g['d2']
        cols1 = [([], [], []) for _ in d1]
        # ktpu: noqa[KTPU205] -- one accumulator dict per container
        # GROUP (a handful per policy set), not per row
        cols2 = {mk: [([], [], [], []) for _ in members]
                 for mk, members in d2.items()}
        for r, doc in enumerate(resources):
            container = _walk(doc, prefix)
            if not isinstance(container, list):
                continue  # lanes stay TAG_MISSING; array guards handle it
            for e, elem in enumerate(container[:elems]):
                is_map = isinstance(elem, dict)
                for si, (rest1, _slot) in enumerate(d1):
                    rr, ee, vv = cols1[si]
                    rr.append(r)
                    ee.append(e)
                    if not rest1:
                        vv.append(elem)
                    else:
                        vv.append(_walk(elem, rest1)
                                  if is_map else _MISSING)
                for mk, members in d2.items():
                    inner = _walk(elem, mk) if is_map else _MISSING
                    if not isinstance(inner, list):
                        continue
                    mcols = cols2[mk]
                    for e2, elem2 in enumerate(inner[:elems]):
                        inner_map = isinstance(elem2, dict)
                        for sj, (rest2, _slot2) in enumerate(members):
                            rr, ee, e2l, vv = mcols[sj]
                            rr.append(r)
                            ee.append(e)
                            e2l.append(e2)
                            if not rest2:
                                vv.append(elem2)
                            else:
                                vv.append(_walk(elem2, rest2)
                                          if inner_map else _MISSING)
        for si, (rest1, slot) in enumerate(d1):
            rr, ee, vv = cols1[si]
            if vv:
                lanes = batch.slot_lanes[slot]
                lanes.encode_column(
                    (np.asarray(rr, np.intp), np.asarray(ee, np.intp)),
                    vv, arena.palette(('s', slot), lanes.needs, False))
        for mk, members in d2.items():
            for sj, (rest2, slot2) in enumerate(members):
                rr, ee, e2l, vv = cols2[mk][sj]
                if vv:
                    lanes = batch.slot_lanes[slot2]
                    lanes.encode_column(
                        (np.asarray(rr, np.intp), np.asarray(ee, np.intp),
                         np.asarray(e2l, np.intp)),
                        vv, arena.palette(('s', slot2), lanes.needs,
                                          False))

    for g in cps.gathers:
        lanes, meta = batch.gather_lanes[g], batch.gather_meta[g]
        _fill_gather_column(gather_results[g], lanes, meta, gwidth,
                            arena.palette(('g', g), lanes.needs, True))
    for eg in cps.elem_gathers:
        lanes, meta = batch.elem_lanes[eg], batch.elem_meta[eg]
        _fill_elem_gather_column(
            elem_results[eg], lanes, meta, egwidth,
            arena.palette(('e', eg), lanes.needs, True))
    return batch


def _build_batch(cps: CompiledPolicySet, n: int, elems: int, gwidth: int,
                 egwidth: int, slot_needs, gather_needs, elem_needs,
                 array_paths) -> Batch:
    """Allocate the full lane tensor set for one batch shape (reused
    across chunks via the LaneArena)."""
    batch = Batch(n)
    for path in array_paths:
        depth = sum(1 for p in path if p == '*')
        shape = (n,) + (elems,) * depth
        # ktpu: noqa[KTPU205] -- per-SLOT lane allocation (runs once per
        # batch shape, then recycles through the arena), not per row
        batch.array_meta[path] = {
            'count': np.zeros(shape, np.int32),
            'overflow': np.zeros(shape, bool),
            'tag': np.zeros(shape, np.int8),
        }
    for slot in cps.slots:
        shape = (n,) + (elems,) * slot.depth
        batch.slot_lanes[slot] = Lanes(shape, slot_needs[slot])
    for g in cps.gathers:
        batch.gather_lanes[g] = Lanes((n, gwidth), gather_needs[g])
        # ktpu: noqa[KTPU205] -- per-GATHER metadata allocation (arena-
        # recycled), not per row
        batch.gather_meta[g] = {
            'kind': np.zeros(n, np.int8),
            'count': np.zeros(n, np.int32),
            'overflow': np.zeros(n, bool),
            'notfound': np.zeros(n, bool),
        }
    for eg in cps.elem_gathers:
        batch.elem_lanes[eg] = Lanes((n, gwidth, egwidth), elem_needs[eg])
        # ktpu: noqa[KTPU205] -- per-GATHER metadata allocation (arena-
        # recycled), not per row
        batch.elem_meta[eg] = {
            'kind': np.zeros((n, gwidth), np.int8),
            'count': np.zeros((n, gwidth), np.int32),
            'overflow': np.zeros((n, gwidth), bool),
            'notfound': np.zeros((n, gwidth), bool),
        }
    return batch


def _needs_cached(cps: CompiledPolicySet):
    cached = getattr(cps, '_needs_cache', None)
    if cached is None:
        cached = _analyze_needs(cps)
        cps._needs_cache = cached
    return cached


def _slot_plan_cached(cps: CompiledPolicySet):
    """Precomputed walk plan (batch-independent, cached on the cps):
    scalar slots as flat (path, slot) pairs; element slots grouped by
    container prefix so each array (and each element) is visited once
    for all the slots under it; array-meta paths split into
    (full path, prefix, rest)."""
    cached = getattr(cps, '_slot_plan_cache', None)
    if cached is not None:
        return cached
    plan0 = []
    groups: Dict[Tuple[str, ...], dict] = {}
    for slot in cps.slots:
        d = slot.depth
        if d == 0:
            plan0.append((slot.path, slot))
            continue
        star1 = slot.path.index('*')
        prefix, rest1 = slot.path[:star1], slot.path[star1 + 1:]
        # ktpu: noqa[KTPU205] -- walk-plan construction, cached on the
        # cps: runs once per policy set, never per row
        g = groups.setdefault(prefix, {'d1': [], 'd2': {}})
        if d == 1:
            g['d1'].append((rest1, slot))
        else:
            star2 = rest1.index('*')
            g['d2'].setdefault(rest1[:star2], []).append(
                (rest1[star2 + 1:], slot))
    _needs = _needs_cached(cps)
    metas = []
    for path in _needs[3]:
        if '*' in path:
            star1 = path.index('*')
            metas.append((path, path[:star1], path[star1 + 1:]))
        else:
            metas.append((path, path, None))
    cached = (plan0, groups, metas)
    cps._slot_plan_cache = cached
    return cached


def _set_array_meta_column(meta, idx, values: list, elems: int) -> None:
    """Vectorized array-metadata fill for one column of walked values."""
    m = len(values)
    tag = np.zeros(m, np.int8)
    count = np.zeros(m, np.int32)
    ovf = np.zeros(m, bool)
    for i, value in enumerate(values):
        if value is _MISSING:
            tag[i] = TAG_MISSING
        elif isinstance(value, list):
            tag[i] = TAG_ARRAY
            count[i] = min(len(value), elems)
            ovf[i] = len(value) > elems
        elif value is None:
            tag[i] = TAG_NULL
        elif isinstance(value, dict):
            tag[i] = TAG_MAP
        else:
            tag[i] = TAG_STRING  # non-array scalar: guards only
    if idx is None:
        meta['tag'][:m] = tag
        meta['count'][:m] = count
        meta['overflow'][:m] = ovf
    else:
        meta['tag'][idx] = tag
        meta['count'][idx] = count
        meta['overflow'][idx] = ovf


def _gather_searcher(g: GatherSlot):
    if g.expr.startswith('__pss:'):
        from .pss_compile import virtual_searcher
        return virtual_searcher(g.expr)
    from ..engine.jmespath import compile as jp_compile
    compiled = jp_compile(g.expr)
    return compiled


def _run_gather(searcher, doc: dict):
    """Evaluate one gather projection; returns a (marker, value) pair."""
    return _run_gather_ctx(searcher, {'request': {'object': doc}})


def _run_gather_ctx(searcher, ctx: dict):
    from ..engine.jmespath import NotFoundError
    try:
        result = searcher.search(ctx)
    except NotFoundError:
        # missing path → the host's deterministic substitution-error ERROR
        # (engine.py:388; synthesized on device via STATUS_VAR_ERR)
        return 'notfound', None
    except Exception:  # noqa: BLE001 - interpreter error → host decides
        return 'raised', None
    if result is None:
        return 'null', None
    if isinstance(result, list):
        return 'list', result
    return 'scalar', result


def _fill_gather_column(results: list, lanes: Lanes, meta, gwidth: int,
                        palette: _Palette) -> None:
    """Columnar fill of one gather's whole result column: metadata
    channels batch into single vectorized writes, element values flow
    through the palette encoder."""
    r_idx: List[int] = []
    e_idx: List[int] = []
    vals: list = []
    nf: List[int] = []
    ovf: List[int] = []
    kind1: List[int] = []
    kind2: List[int] = []
    counts: List[int] = []
    for r, (marker, value) in enumerate(results):
        if marker == 'notfound':
            nf.append(r)
            continue
        if marker == 'raised':
            ovf.append(r)
            continue
        if marker == 'null':
            continue
        if marker == 'list':
            kind2.append(r)
            counts.append(min(len(value), gwidth))
            if len(value) > gwidth:
                ovf.append(r)
            for e, v in enumerate(value[:gwidth]):
                r_idx.append(r)
                e_idx.append(e)
                vals.append(v)
            continue
        kind1.append(r)
        r_idx.append(r)
        e_idx.append(0)
        vals.append(value)
    if nf:
        meta['notfound'][np.asarray(nf, np.intp)] = True
    if ovf:
        meta['overflow'][np.asarray(ovf, np.intp)] = True
    if kind1:
        k1 = np.asarray(kind1, np.intp)
        meta['kind'][k1] = 1
        meta['count'][k1] = 1
    if kind2:
        k2 = np.asarray(kind2, np.intp)
        meta['kind'][k2] = 2
        meta['count'][k2] = np.asarray(counts, np.int32)
    if vals:
        lanes.encode_column(
            (np.asarray(r_idx, np.intp), np.asarray(e_idx, np.intp)),
            vals, palette)


def _fill_elem_gather_column(rows: list, lanes: Lanes, meta, egwidth: int,
                             palette: _Palette) -> None:
    """Columnar fill for a per-foreach-element gather: same channels as
    :func:`_fill_gather_column` with a (row, foreach-element) leading
    index."""
    r_idx: List[int] = []
    f_idx: List[int] = []
    e_idx: List[int] = []
    vals: list = []
    nf: List[Tuple[int, int]] = []
    ovf: List[Tuple[int, int]] = []
    kind1: List[Tuple[int, int]] = []
    kind2: List[Tuple[int, int]] = []
    counts: List[int] = []
    for r, row in enumerate(rows):
        for fe, (marker, value) in enumerate(row):
            if marker == 'null':
                continue  # null foreach elements are skipped entirely
            if marker == 'notfound':
                nf.append((r, fe))
                continue
            if marker == 'raised':
                ovf.append((r, fe))
                continue
            if marker == 'list':
                kind2.append((r, fe))
                counts.append(min(len(value), egwidth))
                if len(value) > egwidth:
                    ovf.append((r, fe))
                for e, v in enumerate(value[:egwidth]):
                    r_idx.append(r)
                    f_idx.append(fe)
                    e_idx.append(e)
                    vals.append(v)
                continue
            kind1.append((r, fe))
            r_idx.append(r)
            f_idx.append(fe)
            e_idx.append(0)
            vals.append(value)

    def _ix(pairs):
        a = np.asarray(pairs, np.intp).reshape(-1, 2)
        return a[:, 0], a[:, 1]

    if nf:
        meta['notfound'][_ix(nf)] = True
    if ovf:
        meta['overflow'][_ix(ovf)] = True
    if kind1:
        k1 = _ix(kind1)
        meta['kind'][k1] = 1
        meta['count'][k1] = 1
    if kind2:
        k2 = _ix(kind2)
        meta['kind'][k2] = 2
        meta['count'][k2] = np.asarray(counts, np.int32)
    if vals:
        lanes.encode_column(
            (np.asarray(r_idx, np.intp), np.asarray(f_idx, np.intp),
             np.asarray(e_idx, np.intp)),
            vals, palette)
