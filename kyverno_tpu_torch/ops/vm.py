"""Lowering of the status programs to K1v bytecode (``csrc/k1_vm.cuh``).

K1v evaluates every unique status tree of a policy set over a batch in
one launch: one thread per (row, tree) runs the tree's instruction
stream against the packed ``[R, W]`` lane buffers of ``pack_batch``.
This module turns each tree into that stream.  It mirrors the eager
walk of ``ops/eval.py`` (``leaf_op_tf``, ``string_term_tf``,
``cond_tf`` and ``eval_status``) function by function, so the two can
be read side by side: where the walk builds a ``[R, ...]`` boolean
tensor, the lowering builds a node that the kernel evaluates per row.

Values.  Every value on the kernel's stack is a Kleene pair in two bits
(bit 0 known-true, bit 1 known-false).  A plain boolean is the known
pair ``(v, !v)``; Kleene AND/OR/NOT on known pairs are boolean, so the
walk's boolean algebra and its ``_K`` algebra share one representation.
``pair(t, f)`` builds ``_K(t, f)`` from two booleans; ``tof``/``fof``/
``uof`` read ``.t``/``.f``/``.unknown()`` back as booleans.

Element axes become loops.  Where the walk reduces an ``[R, E]`` or
``[R, G]`` tensor over its last axis, the node is a loop over that
element index (levels 0 and 1 for the two slot element axes, level 2
for a gather's elements) whose body is reduced into a Kleene
accumulator.  A lane is read at the indices of the levels it has, so a
slot shallower than its context broadcasts by construction.

Status trees (PASS/FAIL/SKIP/HOST/SKIP_PRECOND/VAR_ERR, detail, fail
detail) run on a second stack of ``(s, d, fd)`` triples; ``forall`` and
``exists`` are status loops whose accumulator keeps the first failing
element, the undecidable elements before it and element 0's fail
detail, exactly as the walk's ``argmax``/``gather`` do.

Lowering is per (evaluator, pack layout): lanes resolve to (buffer,
column, element stride) of the layout, loop widths to its element and
gather widths.  ``route_trees`` decides at build time, from the IR,
which trees the kernel takes; ``lower`` binds the kernel's trees to one
layout.
"""

from __future__ import annotations

import itertools
import json as _json
from fractions import Fraction
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..compiler.ir import (TAG_ARRAY, TAG_BOOL, TAG_FLOAT, TAG_INT, TAG_MAP,
                           TAG_MISSING, TAG_NULL, TAG_STRING, TAIL_LEN,
                           BoolExpr, CondCheck, ElemGather, Leaf, StatusExpr,
                           classify_wildcard)
from ..compiler.ir import (STATUS_FAIL, STATUS_PASS, STATUS_SKIP,
                           STATUS_SKIP_PRECOND)
from ..engine import pattern as leaf_pattern
from ..engine.operators import _sprint
from ..utils.duration import parse_duration
from ..utils.quantity import Quantity

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1

# --- the kernel's fixed limits (k1_vm.cuh K1VM_*) ---------------------------
KSTACK = 32         # Kleene stack entries
SSTACK = 16         # status stack entries
LOCALS = 16         # let-bound Kleene locals
FRAMES = 4          # nested loops
MAX_PATTERN = 256   # glob pattern bytes (as K1c)
MAX_WINDOW = 64     # str_head bytes (the glob DP's 64-bit masks)

# --- opcodes (k1_vm.cuh enum K1vmOp; the order is the ABI) ------------------
OPS = ('K', 'TAG', 'LB', 'CI', 'ABSLE', 'F64', 'F64DUR', 'BYTES', 'GLOB',
       'IDXLT', 'AND', 'OR', 'NOT', 'PAIR', 'TOF', 'FOF', 'UOF', 'TU',
       'BLOCK', 'MASK', 'FIXF', 'BOR', 'BLOCKT', 'BLOCKF', 'STORE', 'LOAD',
       'LOOP', 'ENDLOOP', 'SCONST', 'SFROMK', 'SVARERR', 'SFAILGUARD',
       'STRACKFAIL', 'SSEQ', 'SANY', 'SEQUALITY', 'SCOND', 'SLOOP',
       'SENDLOOP', 'SFORALL', 'SEXISTS', 'SSCALARS', 'END')
OP = {name: i for i, name in enumerate(OPS)}
#: comparison codes (k1_vm.cuh k1vm_cmp)
CMP = {'>': 0, '>=': 1, '<': 2, '<=': 3, '==': 4, '!=': 5}
#: loop reductions: Kleene AND, Kleene OR, bitwise OR of both bits
RED_AND, RED_OR, RED_BOR = 0, 1, 2
#: packed buffers in the order the kernel takes them, with their dtypes
BUFFERS = (('pk_uint8', 'uint8'), ('pk_int8', 'int8'), ('pk_bool', 'bool'),
           ('pk_int32', 'int32'), ('pk_int64', 'int64'))
_BUF_INDEX = {name: i for i, (name, _dt) in enumerate(BUFFERS)}
#: int32 words per instruction and per lane-table entry
INSN_WORDS = 6
LANE_WORDS = 8

_BYTE_LANES = frozenset({'str_head', 'str_tail'})
_CONV = (TAG_STRING, TAG_INT, TAG_FLOAT, TAG_BOOL)


def _tagmask(tags) -> int:
    m = 0
    for tg in tags:
        m |= 1 << tg
    return m


# ---------------------------------------------------------------------------
# nodes

class X:
    """A node of a lowered expression: a Kleene pair per row (and per
    element of the enclosing loops)."""

    __slots__ = ('op', 'args')

    def __init__(self, op: str, *args):
        self.op = op
        self.args = args

    def __and__(self, other: 'X') -> 'X':
        return X('AND', self, other)

    def __or__(self, other: 'X') -> 'X':
        return X('OR', self, other)

    def __invert__(self) -> 'X':
        return X('NOT', self)


KT = X('K', 1)      # known true  (t=1, f=0)
KF = X('K', 2)      # known false (t=0, f=1)
KU = X('K', 0)      # unknown     (t=0, f=0)


def pair(t: X, f: X) -> X:
    """``_K(t, f)`` of two booleans."""
    return X('PAIR', t, f)


def tof(k: X) -> X:
    return X('TOF', k)


def fof(k: X) -> X:
    return X('FOF', k)


def uof(k: X) -> X:
    return X('UOF', k)


def tu(t: X, u: X) -> X:
    """``_K(t, ~t & ~u)``."""
    return X('TU', t, u)


def block(k: X, r: X) -> X:
    """``_K(k.t & ~r, k.f & ~r)``."""
    return X('BLOCK', k, r)


def mask(k: X, m: X) -> X:
    """``_K(k.t & m, k.f & m)``."""
    return X('MASK', k, m)


def fixf(k: X) -> X:
    """``_K(k.t, k.f & ~k.t)``."""
    return X('FIXF', k)


def bor(a: X, b: X) -> X:
    """``_K(a.t | b.t, a.f | b.f)``."""
    return X('BOR', a, b)


def blockt(k: X, x: X) -> X:
    return X('BLOCKT', k, x)


def blockf(k: X, x: X) -> X:
    return X('BLOCKF', k, x)


_VAR_IDS = itertools.count()


def let(value: X, body) -> X:
    """Evaluate ``value`` once and hand ``body`` a node that reads it."""
    vid = next(_VAR_IDS)
    return X('LET', vid, value, body(X('VAR', vid)))


def k_all(parts: Sequence[X]) -> X:
    out = parts[0]
    for p in parts[1:]:
        out = out & p
    return out


def k_any(parts: Sequence[X]) -> X:
    out = parts[0]
    for p in parts[1:]:
        out = out | p
    return out


class LoweringError(ValueError):
    """A tree outside the kernel's vocabulary or limits."""


# ---------------------------------------------------------------------------
# lane views over the layout

class Layout:
    """A pack layout (``pack_batch``) as the lowering reads it."""

    def __init__(self, layout: Dict[str, Tuple[str, int, int, Tuple[int, ...]]]):
        self.layout = layout
        # element width of the batch: the eager walk's dims['E'] probe
        self.E = next((tail[0] for name, (_g, _o, _w, tail)
                       in sorted(layout.items())
                       if name.endswith('_tag') and len(tail) >= 1
                       and name[0] in 'sa'), 0)

    def has(self, name: str) -> bool:
        return name in self.layout

    def entry(self, name: str):
        if name not in self.layout:
            raise LoweringError(f'lane {name} not in the layout')
        return self.layout[name]


class View:
    """Lanes of one slot, array node or gather, read at the indices of
    the enclosing loops (the eager ``_View``).  ``levels`` are the loop
    levels of the lane's element axes (slots and arrays: 0, 1; a gather:
    2); ``fixed`` pins a gather's element index (``_View(t, p, i)``)."""

    def __init__(self, lw: 'Lowering', prefix: str, levels: Tuple[int, ...],
                 fixed: Optional[int] = None):
        self.lw = lw
        self.p = prefix
        self.levels = levels
        self.fixed = fixed

    def at(self, i: int) -> 'View':
        return View(self.lw, self.p, self.levels, i)

    def has(self, name: str) -> bool:
        return self.lw.L.has(f'{self.p}_{name}')

    def ref(self, name: str, start: int = 0) -> int:
        full = f'{self.p}_{name}'
        buf, off, _width, tail = self.lw.L.entry(full)
        self.lw.read.add((full, self.fixed))
        byte = name in _BYTE_LANES
        stride = tail[-1] if byte else 1
        dims = tail[:-1] if byte else tail
        coef = [0, 0, 0, 0]
        if self.fixed is not None:
            if len(dims) != 1:
                raise LoweringError(f'{full}: fixed index on {tail}')
            coef[3] = self.fixed
        else:
            if len(dims) > len(self.levels):
                raise LoweringError(f'{full}: {len(dims)} element axes '
                                    f'in a view of {len(self.levels)}')
            mult = 1
            for lvl, n in reversed(list(zip(self.levels, dims))):
                coef[lvl] = mult
                mult *= n
        return self.lw.lane(buf, off + start, stride, coef)

    def width(self, name: str) -> int:
        return self.lw.L.entry(f'{self.p}_{name}')[3][-1]

    # predicates ----------------------------------------------------------

    def is_tag(self, *tags) -> X:
        return X('TAG', self.ref('tag'), _tagmask(tags))

    def b(self, name: str) -> X:
        return X('LB', self.ref(name))

    def cmp(self, name: str, cmp: str, value: int) -> X:
        if value is None:
            raise LoweringError('comparison against None')
        value = int(value)
        if not _I64_MIN <= value <= _I64_MAX:
            raise LoweringError(f'constant {value} outside int64')
        return X('CI', self.ref(name), CMP[cmp], value)

    def abs_le(self, name: str, value: int) -> X:
        return X('ABSLE', self.ref(name), int(value))

    def f64(self, name: str, div: float, cmp: str, value: float) -> X:
        """``(lane.to(float64) / div) cmp value``."""
        return X('F64', self.ref(name), CMP[cmp], float(value), float(div))

    def f64dur(self, cmp: str, value: float) -> X:
        """``trunc((milli.to(float64) / 1000.0) * 1e9) / 1e9 cmp value``."""
        return X('F64DUR', self.ref('milli'), CMP[cmp], float(value))

    def bytes_eq(self, name: str, start: int, const: bytes) -> X:
        return X('BYTES', self.ref(name, start), bytes(const))

    @property
    def tag_missing(self) -> X:
        return self.is_tag(TAG_MISSING)

    @property
    def convertible(self) -> X:
        return self.is_tag(*_CONV)

    @property
    def numish(self) -> X:
        return self.is_tag(TAG_INT, TAG_FLOAT)

    @property
    def nullish(self) -> X:
        return self.is_tag(TAG_NULL, TAG_MISSING)

    @property
    def arrayish(self) -> X:
        return self.is_tag(TAG_ARRAY)

    @property
    def milli_ok(self) -> X:
        return self.b('milli_ok') | self.tag_missing

    @property
    def nanos_ok(self) -> X:
        return self.b('nanos_ok') | self.tag_missing

    @property
    def dur_leaf(self) -> X:
        return ((self.is_tag(TAG_STRING) & self.b('str_is_dur')) |
                (self.is_tag(TAG_INT) & self.b('nanos_ok')) |
                self.nullish)

    # string equality / prefix / suffix against a constant ---------------

    def eq_const(self, s: str) -> X:
        b = s.encode('utf-8')
        conv = self.convertible
        w = self.width('str_head')
        if len(b) <= w:
            hit = (conv & self.cmp('str_len', '==', len(b)) &
                   self.bytes_eq('str_head', 0, b.ljust(w, b'\0')))
            return tu(hit, self.arrayish)
        maybe = conv & self.cmp('str_len', '==', len(b)) & \
            self.bytes_eq('str_head', 0, b[:w])
        return pair(KF, ~maybe & ~self.arrayish)

    def prefix_const(self, s: str) -> X:
        b = s.encode('utf-8')
        conv = self.convertible
        w = self.width('str_head')
        if len(b) <= w:
            hit = conv & self.cmp('str_len', '>=', len(b)) & \
                self.bytes_eq('str_head', 0, b)
            return tu(hit, self.arrayish)
        maybe = conv & self.cmp('str_len', '>=', len(b)) & \
            self.bytes_eq('str_head', 0, b[:w])
        return pair(KF, ~maybe & ~self.arrayish)

    def suffix_const(self, s: str) -> X:
        b = s.encode('utf-8')
        if len(b) > TAIL_LEN:
            raise LoweringError(f'suffix of {len(b)} bytes > {TAIL_LEN}')
        conv = self.convertible
        hit = conv & self.cmp('str_len', '>=', len(b)) & \
            self.bytes_eq('str_tail', TAIL_LEN - len(b), b)
        return tu(hit, self.arrayish)

    def wildcard_const(self, pattern: str) -> X:
        b = pattern.encode('utf-8')
        # a pattern past MAX_PATTERN is a named limit (``_limits``)
        if self.width('str_head') > MAX_WINDOW:
            raise LoweringError('str_head wider than 64 bytes')
        return X('GLOB', self.ref('str_head'), self.ref('str_len'),
                 self.ref('tag'), b)

    def match_const_pattern(self, s: str) -> X:
        kind, parts = classify_wildcard(s)
        if kind == 'eq':
            return self.eq_const(s)
        if kind == 'any':
            return tu(self.convertible, self.arrayish)
        if kind == 'nonempty':
            t = (self.is_tag(TAG_INT, TAG_FLOAT, TAG_BOOL) |
                 (self.is_tag(TAG_STRING) & self.cmp('str_len', '>', 0)))
            return tu(t, self.arrayish)
        if kind == 'prefix':
            return self.prefix_const(parts[0])
        if kind == 'suffix':
            return self.suffix_const(parts[0])
        if kind == 'prefix_suffix':
            min_len = (len(parts[0].encode('utf-8')) +
                       len(parts[1].encode('utf-8')))
            conv_len = tu(self.convertible &
                          self.cmp('str_len', '>=', min_len), self.arrayish)
            return (self.prefix_const(parts[0]) &
                    self.suffix_const(parts[1]) & conv_len)
        return self.wildcard_const(s)


# ---------------------------------------------------------------------------
# leaf (pattern) ops — eval.leaf_op_tf

def leaf_op(v: View, op: str, operand: Any) -> X:
    arr = v.arrayish
    if op == 'true':
        return KT
    if op == 'absent':
        return v.is_tag(TAG_MISSING)
    if op == 'present':
        return ~v.is_tag(TAG_MISSING)
    if op == 'star':
        return ~v.nullish
    if op == 'is_map':
        return v.is_tag(TAG_MAP)
    if op == 'is_array':
        return v.is_tag(TAG_ARRAY)
    if op in ('any_str', 'convertible'):
        return tu(v.convertible, arr)
    if op == 'nonempty':
        t = (v.is_tag(TAG_INT, TAG_FLOAT, TAG_BOOL) |
             (v.is_tag(TAG_STRING) & v.cmp('str_len', '>', 0)))
        return tu(t, arr)
    if op == 'eq_bool':
        nz = v.cmp('milli', '!=', 0)
        t = v.is_tag(TAG_BOOL) & (nz if bool(operand) else ~nz)
        return tu(t, arr)
    if op == 'eq_null':
        t = (v.nullish |
             (v.is_tag(TAG_BOOL, TAG_INT, TAG_FLOAT) & v.milli_ok &
              v.cmp('milli', '==', 0)) |
             (v.is_tag(TAG_STRING) & v.cmp('str_len', '==', 0)))
        return tu(t, arr)
    if op in ('eq_int', 'eq_float'):
        target = (int(operand) * 1000 if op == 'eq_int'
                  else int(Fraction(str(operand)) * 1000))
        flag = 'str_is_int' if op == 'eq_int' else 'str_is_float'
        cand = v.numish | (v.is_tag(TAG_STRING) & v.b(flag))
        mok = v.b('milli_ok')
        t = cand & mok & v.cmp('milli', '==', target)
        u = cand & ~mok
        return pair(t, ~t & ~u & ~arr)
    if op == 'cmp_qty':
        cmp, target = operand
        cand = (v.numish | v.nullish |
                (v.is_tag(TAG_STRING) & v.b('str_is_qty')))
        mok = v.milli_ok
        t = cand & mok & v.cmp('milli', cmp, target)
        u = cand & ~mok
        return pair(t, ~t & ~u & ~arr)
    if op == 'cmp_dur':
        cmp, target = operand
        t = v.dur_leaf & v.nanos_ok & v.cmp('nanos', cmp, target)
        u = v.is_tag(TAG_STRING) & v.b('str_is_dur') & ~v.b('nanos_ok')
        return pair(t, ~t & ~u & ~arr)
    if op == 'eq_str':
        return v.eq_const(operand)
    if op == 'prefix':
        return v.prefix_const(operand)
    if op == 'suffix':
        return v.suffix_const(operand)
    if op == 'min_len':
        t = v.convertible & v.cmp('str_len', '>=', int(operand))
        return tu(t, arr)
    if op == 'wildcard':
        return v.wildcard_const(operand)
    if op == 'truthy':
        mok = v.b('milli_ok')
        num = v.is_tag(TAG_BOOL, TAG_INT, TAG_FLOAT)
        t = (num & (v.cmp('milli', '!=', 0) | ~mok)) | \
            (v.is_tag(TAG_STRING) & v.cmp('str_len', '>', 0))
        f = v.nullish | (num & mok & v.cmp('milli', '==', 0)) | \
            (v.is_tag(TAG_STRING) & v.cmp('str_len', '==', 0))
        return pair(t, f)
    if op == 'is_true':
        return v.is_tag(TAG_BOOL) & v.cmp('milli', '!=', 0)
    if op == 'is_false':
        return v.is_tag(TAG_BOOL) & v.cmp('milli', '==', 0)
    if op == 'is_zero_num':
        return (v.is_tag(TAG_BOOL, TAG_INT, TAG_FLOAT) & v.b('milli_ok') &
                v.cmp('milli', '==', 0))
    raise LoweringError(f'unknown leaf op {op!r}')


# ---------------------------------------------------------------------------
# string terms — eval.string_term_tf / string_pattern_tf

def string_term(v: View, term: str) -> X:
    op = leaf_pattern.get_operator_from_string_pattern(term)
    if op == leaf_pattern.OP_IN_RANGE:
        m = leaf_pattern.IN_RANGE_RE.match(term)
        return (string_term(v, f'>= {m.group(1)}') &
                string_term(v, f'<= {m.group(2)}'))
    if op == leaf_pattern.OP_NOT_IN_RANGE:
        m = leaf_pattern.NOT_IN_RANGE_RE.match(term)
        return (string_term(v, f'< {m.group(1)}') |
                string_term(v, f'> {m.group(2)}'))
    operand = term[len(op):].strip(' ') if op else term
    cmp = {leaf_pattern.OP_MORE: '>', leaf_pattern.OP_MORE_EQUAL: '>=',
           leaf_pattern.OP_LESS: '<', leaf_pattern.OP_LESS_EQUAL: '<=',
           leaf_pattern.OP_EQUAL: '==',
           leaf_pattern.OP_NOT_EQUAL: '!='}[op or leaf_pattern.OP_EQUAL]
    from .eval import _frac_thresholds
    alts: List[X] = []
    try:
        nanos = parse_duration(operand)
        alts.append(leaf_op(v, 'cmp_dur', (cmp, nanos)))
    except (ValueError, TypeError):
        pass
    try:
        q = Quantity.parse(operand)
        m = q.value * 1000
        if m.denominator == 1 and abs(m.numerator) <= _I64_MAX:
            alts.append(leaf_op(v, 'cmp_qty', (cmp, int(m))))
        else:
            cand = (v.numish | v.nullish |
                    (v.is_tag(TAG_STRING) & v.b('str_is_qty')))
            decided = cand & v.milli_ok
            if cmp in ('==', '!='):
                hit = decided if cmp == '!=' else KF
                alts.append(pair(hit, (decided & ~hit) |
                                 (~cand & ~v.arrayish)))
            else:
                c2, thr = _frac_thresholds(cmp, m)
                alts.append(leaf_op(v, 'cmp_qty', (c2, thr)))
    except ValueError:
        pass
    if cmp in ('==', '!='):
        s = v.match_const_pattern(operand)
        if cmp == '!=':
            s = tu(v.convertible, v.arrayish) & ~s
        alts.append(s)
    if not alts:
        return KF
    return k_any(alts)


def string_pattern(v: View, pattern: str) -> X:
    parts = [v.eq_const(pattern)]
    for condition in pattern.split('|'):
        parts.append(k_all([string_term(v, t.strip(' '))
                            for t in condition.strip(' ').split('&')]))
    return k_any(parts)


# ---------------------------------------------------------------------------
# conditions — eval.cond_tf and its helpers (mode A)

def _scalar_eq_const(sv: View, value: Any) -> X:
    if isinstance(value, bool):
        nz = sv.cmp('milli', '!=', 0)
        return sv.is_tag(TAG_BOOL) & (nz if value else ~nz)
    if isinstance(value, (int, float)):
        target = Fraction(str(value)) * 1000
        mok = sv.b('milli_ok')
        if target.denominator == 1 and abs(target) <= _I64_MAX:
            num_t = sv.numish & mok & sv.cmp('milli', '==', int(target))
        else:
            num_t = KF
        num_u = sv.numish & ~mok
        dur_key = (sv.is_tag(TAG_STRING) & sv.b('str_is_dur') &
                   ~sv.b('lit_zero'))
        vd = int(value * 1e9)
        if abs(vd) <= _I64_MAX:
            dur_t = dur_key & sv.b('nanos_ok') & sv.cmp('nanos', '==', vd)
        else:
            dur_t = KF
        dur_u = dur_key & ~sv.b('nanos_ok')
        return tu(num_t | dur_t, num_u | dur_u)
    if isinstance(value, str):
        return _scalar_eq_str_const(sv, value)
    return KF


def _scalar_eq_str_const(sv: View, value: str) -> X:
    try:
        fv = float(value)
        mok = sv.b('milli_ok') & sv.abs_le('milli', 1 << 53)
        num_t = sv.numish & mok & sv.f64('milli', 1000.0, '==', float(fv))
        num_u = sv.numish & ~mok
    except ValueError:
        num_t = KF
        num_u = KF
    is_str = sv.is_tag(TAG_STRING)
    dur_key = is_str & sv.b('str_is_dur') & ~sv.b('lit_zero')
    try:
        vnanos: Optional[int] = (parse_duration(value)
                                 if value != '0' else None)
    except (ValueError, TypeError):
        vnanos = None
    if vnanos is not None:
        dur_t = dur_key & sv.b('nanos_ok') & sv.cmp('nanos', '==', vnanos)
        dur_decided = dur_key
        dur_u = dur_key & ~sv.b('nanos_ok')
    else:
        dur_t = KF
        dur_decided = KF
        dur_u = KF
    qty_key = is_str & sv.b('str_is_qty') & ~dur_decided
    try:
        vq = Quantity.parse(value)
        vm = vq.value * 1000
        if vm.denominator == 1 and abs(vm.numerator) <= _I64_MAX:
            qty_t = qty_key & sv.b('milli_ok') & sv.cmp('milli', '==', int(vm))
        else:
            qty_t = KF
        qty_u = qty_key & ~sv.b('milli_ok')
    except ValueError:
        qty_t = KF
        qty_u = KF
    wild_key = is_str & ~dur_decided & ~qty_key
    return let(sv.match_const_pattern(value), lambda wk: tu(
        num_t | dur_t | qty_t | (wild_key & tof(wk)),
        num_u | dur_u | qty_u | (wild_key & uof(wk))))


def _list_eq_const(ev: View, count: X, overflow: X,
                   values: Tuple[Any, ...]) -> X:
    """``count`` is the walk's ``count == len(values)`` test."""
    gwidth = ev.width('tag')
    if len(values) > gwidth:
        return pair(KF, ~overflow)
    mismatch = ~count | overflow
    acc = KT
    for i, cv in enumerate(values):
        el = ev.at(i)
        if cv is None:
            ek = el.is_tag(TAG_NULL)
        elif isinstance(cv, (bool, int, float)):
            target = Fraction(str(cv if not isinstance(cv, bool)
                                  else (1 if cv else 0))) * 1000
            numish = el.is_tag(TAG_BOOL, TAG_INT, TAG_FLOAT)
            mok = el.b('milli_ok')
            if target.denominator == 1 and abs(target) <= _I64_MAX:
                et = numish & mok & el.cmp('milli', '==', int(target))
            else:
                et = KF
            ek = tu(et, numish & ~mok)
        elif isinstance(cv, str):
            ek = el.is_tag(TAG_STRING) & el.eq_const(cv)
        else:
            ek = KU
        acc = acc & ek
    return fixf(~mismatch & acc)


def _both_dir_member(view: View, values: Tuple[Any, ...]) -> X:
    hw = view.b('has_wild') if view.has('has_wild') else None
    parts: List[X] = []
    for cv in values:
        vs = cv if isinstance(cv, str) else _sprint(cv)
        m1 = view.match_const_pattern(vs)
        if hw is None:
            parts.append(m1)
        elif '*' in vs or '?' in vs:
            parts.append(m1 | block(view.eq_const(vs), hw))
        else:
            parts.append(let(m1, lambda m, hw=hw: m | block(m, hw)))
    return k_any(parts)


def _try_json_str_list(value: str) -> Optional[List[str]]:
    try:
        arr = _json.loads(value)
    except ValueError:
        return None
    if isinstance(arr, list) and all(isinstance(x, str) for x in arr):
        return arr
    return None


def _arr_member(view: View, value: str) -> X:
    arr = _try_json_str_list(value)
    if arr is None:
        arr = [value]
    return k_any([view.eq_const(x) for x in arr])


def _scalar_str_member(view: View, value: str) -> X:
    m = view.match_const_pattern(value)
    if leaf_pattern.get_operator_from_string_pattern(value) == \
            leaf_pattern.OP_IN_RANGE:
        return m | string_pattern(view, value)
    return m | _arr_member(view, value)


def _quantify(lw: 'Lowering', quant: str, em: X, valid: X,
              overflow: X, width: int) -> X:
    """The walk's ``_quantify`` as one loop over the gather's elements:
    one Kleene value carries (lt, lf)."""
    if quant == 'any':
        return blockf(lw.loop(2, width, RED_OR, valid & em), overflow)
    if quant == 'all':
        return blockt(lw.loop(2, width, RED_AND, ~valid | em), overflow)
    if quant == 'any_not':
        return blockf(lw.loop(2, width, RED_OR, valid & ~em), overflow)
    if quant == 'all_not':
        return blockt(lw.loop(2, width, RED_AND, ~valid | ~em), overflow)
    raise LoweringError(quant)


def _in_family(lw: 'Lowering', prefix: str, check: CondCheck) -> X:
    op = check.op
    meta = lw.row_view(prefix)
    kind_is = lambda k: meta.cmp('kind', '==', k)   # noqa: E731
    overflow = meta.b('overflow')
    negate = op in ('anynotin', 'allnotin')
    if not check.list_value and not isinstance(check.values[0], str):
        return KF
    sv = lw.gather_view(prefix).at(0)
    ev = lw.gather_view(prefix)
    scalar = kind_is(1)
    scalar_ok = sv.is_tag(TAG_STRING, TAG_INT, TAG_FLOAT)
    if check.list_value:
        member = _both_dir_member(sv, check.values)
    else:
        member = _scalar_str_member(sv, check.values[0])
    if negate:
        member = ~member
    scal = mask(scalar_ok & member, scalar)

    gwidth = ev.width('tag')
    valid = X('IDXLT', meta.ref('count'), 2)
    shortcut = None
    if check.list_value:
        em = _both_dir_member(ev, check.values)
        quant = {'anyin': 'any', 'allin': 'all',
                 'anynotin': 'any_not', 'allnotin': 'all_not'}[op]
    else:
        value = check.values[0]
        is_range = leaf_pattern.get_operator_from_string_pattern(value) == \
            leaf_pattern.OP_IN_RANGE
        shortcut = meta.cmp('count', '==', 1) & tof(sv.eq_const(value))
        if is_range:
            if op == 'anynotin':
                em = string_pattern(ev, value.replace('-', '!-', 1))
                quant = 'any'
            elif op == 'allnotin':
                em = string_pattern(ev, value)
                quant = 'all_not'
            else:
                em = string_pattern(ev, value)
                quant = {'anyin': 'any', 'allin': 'all'}[op]
        else:
            arr = _try_json_str_list(value)
            em = _both_dir_member(ev, tuple(arr if arr is not None
                                            else [value]))
            quant = {'anyin': 'any', 'allin': 'all',
                     'anynotin': 'any_not', 'allnotin': 'all_not'}[op]
    q = _quantify(lw, quant, em, valid, overflow, gwidth)
    if shortcut is not None:
        q = (q & ~shortcut) if negate else (q | shortcut)
    lst = mask(q, kind_is(2))
    return fixf(bor(bor(scal, lst), pair(KF, kind_is(0))))


def _numeric(lw: 'Lowering', prefix: str, check: CondCheck) -> X:
    from .eval import _frac_thresholds, _is_semverish, _op_duration
    op = check.op
    meta = lw.row_view(prefix)
    sv = lw.gather_view(prefix).at(0)
    value = check.values[0]
    cmp = {'greaterthan': '>', 'greaterthanorequals': '>=',
           'lessthan': '<', 'lessthanorequals': '<='}[op]
    scalar = meta.cmp('kind', '==', 1)
    f53 = 1 << 53

    def mok():
        return sv.b('milli_ok') & sv.abs_le('milli', f53)

    def cmp_float(valid, target_f):
        ok = mok()
        return (valid & ok & sv.f64('milli', 1000.0, cmp, float(target_f)),
                valid & ~ok)

    def cmp_duration_pair(valid, vd: int):
        ok = mok()
        return (valid & ok & sv.f64dur(cmp, float(vd / 1e9)), valid & ~ok)

    vd: Optional[int] = None
    vf: Optional[float] = None
    vq = None
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        vf = float(value)
    if isinstance(value, str):
        vd = _op_duration(value)
        try:
            vq = Quantity.parse(value)
        except ValueError:
            vq = None
        if vd is None:
            try:
                vf = float(value)
            except ValueError:
                vf = None

    num_key = sv.numish
    if isinstance(value, bool):
        num_t, num_u = KF, KF
    elif isinstance(value, (int, float)):
        num_t, num_u = cmp_float(num_key, vf)
    elif isinstance(value, str) and vd is not None:
        num_t, num_u = cmp_duration_pair(num_key, vd)
    elif isinstance(value, str) and vf is not None:
        num_t, num_u = cmp_float(num_key, vf)
    else:
        num_t, num_u = KF, KF

    is_str = sv.is_tag(TAG_STRING)
    dur_key = is_str & sv.b('str_is_dur') & ~sv.b('lit_zero')
    if isinstance(value, str):
        pair_vd = vd
    elif isinstance(value, (int, float)) and not isinstance(value, bool):
        pair_vd = int(value * 1e9)
    else:
        pair_vd = None
    if pair_vd is not None:
        nok = sv.b('nanos_ok') & sv.abs_le('nanos', f53)
        dur_t = dur_key & nok & sv.f64('nanos', 1e9, cmp,
                                       float(pair_vd / 1e9))
        dur_u = dur_key & ~nok
        dur_decided = dur_key
    else:
        dur_t, dur_u = KF, KF
        dur_decided = KF
    qty_key = is_str & sv.b('str_is_qty') & ~dur_decided
    if isinstance(value, str) and vq is not None:
        c2, thr = _frac_thresholds(cmp, vq.value * 1000)
        qty_t = qty_key & sv.b('milli_ok') & sv.cmp('milli', c2, thr)
        qty_u = qty_key & ~sv.b('milli_ok')
        qty_decided = qty_key
    else:
        qty_t, qty_u = KF, KF
        qty_decided = KF
    float_key = (is_str & sv.b('str_is_float') & ~dur_decided &
                 ~qty_decided)
    if isinstance(value, bool):
        f_t, f_u = KF, KF
    elif isinstance(value, (int, float)):
        f_t, f_u = cmp_float(float_key, float(value))
    elif isinstance(value, str) and vd is not None:
        f_t, f_u = cmp_duration_pair(float_key, vd)
    elif isinstance(value, str) and vf is not None:
        f_t, f_u = cmp_float(float_key, vf)
    else:
        f_t, f_u = KF, KF
    semver_const = isinstance(value, str) and _is_semverish(value)
    rest = is_str & ~dur_decided & ~qty_decided & ~float_key
    semver_u = rest if semver_const else KF
    return tu(scalar & (num_t | dur_t | qty_t | f_t),
              scalar & (num_u | dur_u | qty_u | f_u | semver_u))


def cond(lw: 'Lowering', prefix: str, check: CondCheck) -> X:
    op = check.op
    meta = lw.row_view(prefix)
    kind_is = lambda k: meta.cmp('kind', '==', k)   # noqa: E731
    overflow = meta.b('overflow')
    raised = (kind_is(0) & overflow) | meta.b('notfound')
    if op in ('equal', 'equals', 'notequal', 'notequals'):
        scalar = kind_is(1)
        if check.list_value:
            eq_scal = KF
            eq_list = _list_eq_const(lw.gather_view(prefix),
                                     meta.cmp('count', '==',
                                              len(check.values)),
                                     overflow, check.values)
        else:
            eq_scal = _scalar_eq_const(lw.gather_view(prefix).at(0),
                                       check.values[0])
            eq_list = KF
        lst = kind_is(2)
        res = let(eq_scal, lambda s: let(eq_list, lambda li: tu(
            (scalar & tof(s)) | (lst & tof(li)),
            (scalar & uof(s)) | (lst & uof(li)))))
        if op in ('notequal', 'notequals'):
            res = ~res
        return block(res, raised)
    if op in ('in', 'anyin', 'allin', 'notin', 'anynotin', 'allnotin'):
        return block(_in_family(lw, prefix, check), raised)
    if op in ('greaterthan', 'greaterthanorequals', 'lessthan',
              'lessthanorequals'):
        return block(_numeric(lw, prefix, check), raised)
    raise LoweringError(f'condition op {op!r} not supported on device')


# ---------------------------------------------------------------------------
# status trees — eval.eval_expr / eval_status

class Lowering:
    """Lowers status trees against one layout into node trees, and the
    node trees into instructions and pools."""

    def __init__(self, info: 'TreeInfo', layout: Layout, tables=None):
        self.info = info
        self.L = layout
        #: the lane table (shared by every tree of one program), and the
        #: lanes read, as (name, fixed gather index or None)
        self.lanes, self.lane_rows, self.read = tables or ({}, [], set())

    # lanes -----------------------------------------------------------------

    def lane(self, buf: str, off: int, stride: int, coef) -> int:
        if buf not in _BUF_INDEX:
            raise LoweringError(f'unknown packed buffer {buf}')
        key = (_BUF_INDEX[buf], off, stride) + tuple(coef)
        hit = self.lanes.get(key)
        if hit is None:
            hit = self.lanes[key] = len(self.lane_rows)
            self.lane_rows.append(key + (0,))
        return hit

    def slot_view(self, slot) -> View:
        return View(self, self.info.slot_prefix[slot],
                    tuple(range(slot.depth)))

    def array_view(self, path) -> View:
        depth = sum(1 for p in path if p == '*')
        return View(self, self.info.array_prefix[path], tuple(range(depth)))

    def gather_view(self, prefix: str) -> View:
        return View(self, prefix, (2,))

    def row_view(self, prefix: str) -> View:
        return View(self, prefix, ())

    def loop(self, level: int, width: int, red: int, body: X) -> X:
        return X('LOOP', level, width, red, body)

    # boolean expressions ---------------------------------------------------

    def leaf(self, leaf: Leaf, depth: int) -> X:
        if leaf.op == 'true':
            return KT
        out = leaf_op(self.slot_view(leaf.slot), leaf.op, leaf.operand)
        sd = leaf.slot.depth
        if sd > depth:
            path = leaf.slot.path
            for lvl in range(sd, depth, -1):
                ap = self.info.array_prefix.get(_nth_star_prefix(path, lvl))
                if ap is None:
                    out = KU
                    continue
                meta = View(self, ap, tuple(range(lvl - 1)))
                valid = X('IDXLT', meta.ref('count'), lvl - 1)
                out = blockt(self.loop(lvl - 1, self.L.E, RED_AND,
                                       ~valid | out), meta.b('overflow'))
        return out

    def expr(self, expr: BoolExpr, depth: int) -> X:
        if expr.kind == 'leaf':
            return self.leaf(expr.leaf, depth)
        if expr.kind == 'cond':
            check = expr.cond
            if check.value_gather is not None or \
                    isinstance(check.gather, ElemGather):
                raise LoweringError('element-gather condition')
            return cond(self, self.info.gather_prefix[check.gather], check)
        if expr.kind in ('any_elem', 'all_elem'):
            sub = self.expr(expr.children[0], depth + 1)
            meta = self.array_view(expr.slot.path)
            if len(meta.levels) != depth:
                raise LoweringError('quantifier array at another depth')
            valid = X('IDXLT', meta.ref('count'), depth)
            ovf = meta.b('overflow')
            known_arr = meta.is_tag(TAG_ARRAY, TAG_MISSING, TAG_NULL)
            if expr.kind == 'any_elem':
                q = blockf(self.loop(depth, self.L.E, RED_OR, valid & sub),
                           ovf)
            else:
                q = blockt(self.loop(depth, self.L.E, RED_AND, ~valid | sub),
                           ovf)
            return mask(q, known_arr)
        parts = [self.expr(c, depth) for c in expr.children]
        if expr.kind == 'and':
            return k_all(parts)
        if expr.kind == 'or':
            return k_any(parts)
        if expr.kind == 'not':
            return ~parts[0]
        raise LoweringError(expr.kind)

    # status trees ----------------------------------------------------------

    @staticmethod
    def site_fd(node: StatusExpr) -> int:
        return -1 if node.fail_site is None else node.fail_site << 16

    def status(self, node: StatusExpr, depth: int, aux: List[int]) -> X:
        kind = node.kind
        if kind == 'const':
            return X('SCONST', int(node.operand))
        if kind == 'leaf':
            return X('SFROMK', self.expr(node.expr, depth), STATUS_PASS,
                     STATUS_FAIL, self.site_fd(node))
        if kind in ('precond', 'deny'):
            k = self.expr(node.expr, depth)
            s = X('SFROMK', k, STATUS_PASS, STATUS_SKIP_PRECOND, -1) \
                if kind == 'precond' else X('SFROMK', k, STATUS_FAIL,
                                            STATUS_PASS, 0)
            for gather, msg_idx in (node.operand or ()):
                nf = self.row_view(self.info.gather_prefix[gather])
                s = X('SVARERR', s, nf.ref('notfound'), int(msg_idx))
            return s
        if kind == 'failguard':
            return X('SFAILGUARD', self.status(node.sub, depth, aux),
                     self.expr(node.expr, depth))
        if kind == 'seq':
            out = self.status(node.children[0], depth, aux)
            for c in node.children[1:]:
                out = X('SSEQ', out, self.status(c, depth, aux))
            return out
        if kind == 'any':
            children = [self.status(c, depth, aux) for c in node.children]
            if depth != 0:
                raise LoweringError('anyPattern below the top level')
            col = aux[0]
            aux[0] += len(children)
            return X('SANY', tuple(children), col)
        if kind in ('cond', 'global', 'equality', 'negation'):
            view = self.slot_view(node.slot)
            if node.slot.depth > depth:
                raise LoweringError('anchor slot deeper than its node')
            present = ~view.is_tag(TAG_MISSING)
            if kind == 'negation':
                return X('SFROMK', present, STATUS_FAIL, STATUS_PASS,
                         self.site_fd(node))
            sub = self.status(node.sub, depth, aux)
            if kind == 'equality':
                return X('SEQUALITY', sub, present)
            return X('SCOND', sub, present,
                     STATUS_SKIP if kind == 'cond' else STATUS_PASS)
        if kind in ('forall', 'exists', 'scalars'):
            meta = self.array_view(node.slot.path)
            if len(meta.levels) != depth:
                raise LoweringError('array node at another depth')
            valid = X('IDXLT', meta.ref('count'), depth)
            tag, ovf = meta.ref('tag'), meta.ref('overflow')
            if kind == 'scalars':
                k = self.expr(node.expr, depth + 1)
                body = let(k, lambda kk: pair(valid & fof(kk),
                                              valid & uof(kk)))
                return X('SSCALARS', self.loop(depth, self.L.E, RED_BOR,
                                               body), tag, ovf,
                         self.site_fd(node))
            sub = self.status(node.sub, depth + 1, aux)
            loop = X('SLOOP', depth, self.L.E, sub, valid)
            if kind == 'exists':
                return X('SEXISTS', loop, tag, ovf, self.site_fd(node))
            return X('SFORALL', loop, tag, ovf, self.site_fd(node))
        if kind == 'trackfail':
            return X('STRACKFAIL', self.status(node.sub, depth, aux),
                     self.expr(node.expr, depth))
        raise LoweringError(f'status kind {kind!r}')


def _nth_star_prefix(path: Tuple[str, ...], lvl: int) -> Tuple[str, ...]:
    seen = 0
    for i, p in enumerate(path):
        if p == '*':
            seen += 1
            if seen == lvl:
                return path[:i]
    raise AssertionError('bad star level')


# ---------------------------------------------------------------------------
# code generation

class _Gen:
    """Node trees → instructions, with the stack, local and loop depths
    they need and the constant pools."""

    def __init__(self):
        self.code: List[List[int]] = []
        self.i64: List[int] = []
        self.f64: List[float] = []
        self.bytes = bytearray()
        self._i64: Dict[int, int] = {}
        self._f64: Dict[bytes, int] = {}
        self._bytes: Dict[bytes, int] = {}
        self.k = self.s = self.frames = self.locals = 0
        self.max_k = self.max_s = self.max_frames = self.max_locals = 0
        self.max_pattern = 0
        self.var_slot: Dict[int, int] = {}
        #: instructions one row executes (loop bodies times their widths)
        self.dyn = 0
        self._mult = 1

    def i64_index(self, v: int) -> int:
        hit = self._i64.get(v)
        if hit is None:
            hit = self._i64[v] = len(self.i64)
            self.i64.append(v)
        return hit

    def f64_index(self, v: float) -> int:
        key = np.float64(v).tobytes()
        hit = self._f64.get(key)
        if hit is None:
            hit = self._f64[key] = len(self.f64)
            self.f64.append(v)
        return hit

    def bytes_index(self, b: bytes) -> int:
        hit = self._bytes.get(b)
        if hit is None:
            hit = self._bytes[b] = len(self.bytes)
            self.bytes += b
        return hit

    def put(self, op: str, *args: int) -> int:
        words = [OP[op]] + [int(a) for a in args]
        words += [0] * (INSN_WORDS - len(words))
        self.code.append(words)
        self.dyn += self._mult
        return len(self.code) - 1

    def push_k(self, n: int = 1):
        self.k += n
        self.max_k = max(self.max_k, self.k)

    def push_s(self, n: int = 1):
        self.s += n
        self.max_s = max(self.max_s, self.s)

    # Kleene nodes ----------------------------------------------------------

    def kleene(self, x: X) -> None:
        op, a = x.op, x.args
        if op == 'K':
            self.put('K', a[0])
            self.push_k()
        elif op == 'TAG':
            self.put('TAG', a[0], a[1])
            self.push_k()
        elif op == 'LB':
            self.put('LB', a[0])
            self.push_k()
        elif op == 'CI':
            self.put('CI', a[0], a[1], self.i64_index(a[2]))
            self.push_k()
        elif op == 'ABSLE':
            self.put('ABSLE', a[0], 0, self.i64_index(a[1]))
            self.push_k()
        elif op == 'F64':
            self.put('F64', a[0], a[1], self.f64_index(a[2]),
                     self.f64_index(a[3]))
            self.push_k()
        elif op == 'F64DUR':
            self.put('F64DUR', a[0], a[1], self.f64_index(a[2]))
            self.push_k()
        elif op == 'BYTES':
            self.put('BYTES', a[0], 0, self.bytes_index(a[1]), len(a[1]))
            self.push_k()
        elif op == 'GLOB':
            self.max_pattern = max(self.max_pattern, len(a[3]))
            self.put('GLOB', a[0], a[1], a[2], self.bytes_index(a[3]),
                     len(a[3]))
            self.push_k()
        elif op == 'IDXLT':
            self.put('IDXLT', a[0], a[1])
            self.push_k()
        elif op in ('NOT', 'TOF', 'FOF', 'UOF', 'FIXF'):
            self.kleene(a[0])
            self.put(op)
        elif op in ('AND', 'OR', 'PAIR', 'TU', 'BLOCK', 'MASK', 'BOR',
                    'BLOCKT', 'BLOCKF'):
            self.kleene(a[0])
            self.kleene(a[1])
            self.put(op)
            self.k -= 1
        elif op == 'LET':
            vid, value, body = a
            self.kleene(value)
            slot = self.locals
            self.locals += 1
            self.max_locals = max(self.max_locals, self.locals)
            self.var_slot[vid] = slot
            self.put('STORE', slot)
            self.k -= 1
            self.kleene(body)
            self.locals -= 1
            del self.var_slot[vid]
        elif op == 'VAR':
            self.put('LOAD', self.var_slot[a[0]])
            self.push_k()
        elif op == 'LOOP':
            level, width, red, body = a
            start = self.put('LOOP', level, width, red, 0)
            mult = self._mult
            self._frame(+1, width)
            self.kleene(body)
            self.put('ENDLOOP', start + 1)
            self.k -= 1
            self._frame(-1)
            self._mult = mult
            self.code[start][4] = len(self.code)
            self.push_k()
        else:
            raise LoweringError(f'not a Kleene node: {op}')

    def _frame(self, d: int, width: int = 1) -> None:
        """Enter (d = 1) or leave (d = -1) a loop; entering multiplies
        the executed-instruction count by its width (the caller restores
        it on leaving)."""
        self.frames += d
        self.max_frames = max(self.max_frames, self.frames)
        if d > 0:
            self._mult *= max(width, 0)

    # status nodes ----------------------------------------------------------

    def status(self, x: X) -> None:
        op, a = x.op, x.args
        if op == 'SCONST':
            self.put('SCONST', a[0])
            self.push_s()
        elif op == 'SFROMK':
            self.kleene(a[0])
            self.put('SFROMK', a[1], a[2], a[3])
            self.k -= 1
            self.push_s()
        elif op == 'SVARERR':
            self.status(a[0])
            self.put('SVARERR', a[1], a[2])
        elif op in ('SFAILGUARD', 'STRACKFAIL', 'SEQUALITY'):
            self.status(a[0])
            self.kleene(a[1])
            self.put(op)
            self.k -= 1
        elif op == 'SCOND':
            self.status(a[0])
            self.kleene(a[1])
            self.put('SCOND', a[2])
            self.k -= 1
        elif op == 'SSEQ':
            self.status(a[0])
            self.status(a[1])
            self.put('SSEQ')
            self.s -= 1
        elif op == 'SANY':
            children, col = a
            for c in children:
                self.status(c)
            self.put('SANY', len(children), col)
            self.s -= len(children)
            self.push_s()
        elif op == 'SSCALARS':
            self.kleene(a[0])
            self.put('SSCALARS', a[1], a[2], a[3])
            self.k -= 1
            self.push_s()
        elif op in ('SFORALL', 'SEXISTS'):
            level, width, sub, valid = a[0].args
            start = self.put('SLOOP', level, width, 0, 0)
            mult = self._mult
            self._frame(+1, width)
            self.status(sub)
            self.kleene(valid)
            self.put('SENDLOOP', start + 1)
            self.s -= 1
            self.k -= 1
            self._frame(-1)
            self._mult = mult
            self.code[start][4] = len(self.code)
            self.push_s()
            self.put(op, a[1], a[2], a[3])
        else:
            raise LoweringError(f'not a status node: {op}')

    def tree(self, x: X, col: int) -> int:
        start = len(self.code)
        self.status(x)
        self.put('END', col)
        self.s -= 1
        assert self.k == 0 and self.s == 0 and self.frames == 0
        return start


# ---------------------------------------------------------------------------
# routing (build time) and lowering (per layout)

class TreeInfo:
    """What the lowering needs of an evaluator: the prefixes of its
    slots, arrays and gathers, its unique trees and their aux columns."""

    def __init__(self, cps, uniq_trees, uniq_aux_base, n_uniq: int,
                 n_cols_u: int):
        from ..compiler.encode import _needs_cached
        self.slot_prefix = {slot: f's{i}' for i, slot in enumerate(cps.slots)}
        self.gather_prefix = {g: f'g{k}' for k, g in enumerate(cps.gathers)}
        _, _, _, array_paths = _needs_cached(cps)
        self.array_prefix = {path: f'a{j}'
                             for j, path in enumerate(array_paths)}
        self.trees = list(uniq_trees)
        self.aux_base = list(uniq_aux_base)
        self.n_uniq = n_uniq
        self.n_cols_u = n_cols_u


def _has_foreach(node: StatusExpr) -> bool:
    if node.kind == 'foreach':
        return True
    return any(_has_foreach(c) for c in node.children) or \
        (node.sub is not None and _has_foreach(node.sub))


class Program:
    """K1v's bytecode for one (evaluator, layout): the instruction
    stream, lane table, pools and per-tree entry points, as numpy
    arrays; ``device_tables`` keeps them on each device once."""

    def __init__(self, gen: _Gen, lanes: List[Tuple[int, ...]],
                 trees: List[Tuple[int, int]], vm_cols: List[int],
                 n_uniq: int, n_cols_u: int):
        self.code = np.asarray(gen.code, np.int32).reshape(-1, INSN_WORDS)
        self.lanes = np.asarray(lanes, np.int32).reshape(-1, LANE_WORDS)
        self.i64 = np.asarray(gen.i64 or [0], np.int64)
        self.f64 = np.asarray(gen.f64 or [0.0], np.float64)
        self.bytes = np.frombuffer(bytes(gen.bytes) or b'\0',
                                   np.uint8).copy()
        #: per kernel tree: (first instruction, unique column)
        self.trees = np.asarray(trees, np.int32).reshape(-1, 2)
        self.vm_cols = list(vm_cols)
        self.n_uniq = n_uniq
        self.n_cols_u = n_cols_u
        self.depths = {'kstack': gen.max_k, 'sstack': gen.max_s,
                       'frames': gen.max_frames, 'locals': gen.max_locals}
        #: bytes of the packed lanes the bytecode reads, per row, and the
        #: layout it was lowered against (set by ``lower``)
        self.row_bytes = 0
        self.layout = None
        #: instructions one row executes over all the program's trees
        self.row_insns = gen.dyn
        self._dev: Dict[Any, Dict[str, Any]] = {}

    def device_tables(self, device) -> Dict[str, Any]:
        import torch
        hit = self._dev.get(device)
        if hit is None:
            hit = {name: torch.from_numpy(getattr(self, name)).to(device)
                   for name in ('code', 'lanes', 'i64', 'f64', 'bytes',
                                'trees')}
            self._dev[device] = hit
        return hit


def _limits(gen: _Gen) -> Optional[str]:
    for name, got, limit in (('Kleene stack', gen.max_k, KSTACK),
                             ('status stack', gen.max_s, SSTACK),
                             ('loop nesting', gen.max_frames, FRAMES),
                             ('locals', gen.max_locals, LOCALS),
                             ('glob pattern bytes', gen.max_pattern,
                              MAX_PATTERN)):
        if got > limit:
            return f'{name} {got} > {limit}'
    return None


def _lower_trees(info: TreeInfo, layout: Layout, trees: Sequence[int]):
    """Lower unique trees ``trees`` into one instruction stream with one
    lane table: (gen, (lanes, lane rows, lanes read), [(entry pc, u)])."""
    gen = _Gen()
    tables = ({}, [], set())
    entries: List[Tuple[int, int]] = []
    for u in trees:
        lw = Lowering(info, layout, tables)
        node = lw.status(info.trees[u], 0, [info.n_uniq + info.aux_base[u]])
        entries.append((gen.tree(node, u), u))
    return gen, tables, entries


def route_trees(info: TreeInfo, probe_layout: Dict) -> Dict[int, Tuple[str, str]]:
    """``{unique tree: ('vm' | 'eager', reason)}``, decided once per
    evaluator from the IR: ``foreach`` trees (the only source of
    element gathers and mode-B conditions) and trees past one of the
    kernel's fixed limits (``_limits``) stay on the eager walk.  The
    limits are read from a trial lowering against ``probe_layout`` (the
    policy set's lanes at the encoder's smallest widths); stack and loop
    depths and pattern lengths do not depend on the widths.  Any other
    tree the lowering cannot take raises ``LoweringError``."""
    layout = Layout(probe_layout)
    routes: Dict[int, Tuple[str, str]] = {}
    for u, tree in enumerate(info.trees):
        if _has_foreach(tree):
            routes[u] = ('eager', 'foreach')
            continue
        gen, _tables, _entries = _lower_trees(info, layout, [u])
        over = _limits(gen)
        routes[u] = ('eager', over) if over else ('vm', 'lowered')
    return routes


_ESIZE = {'uint8': 1, 'int8': 1, 'bool': 1, 'int32': 4, 'int64': 8}


def _row_bytes(layout: Dict, read) -> int:
    """Bytes per row of the lanes in ``read``: a whole lane, or one
    element of a gather lane read at a fixed index."""
    total = 0
    for name, fixed in read:
        buf, _off, width, tail = layout[name]
        esize = _ESIZE[buf[len('pk_'):]]
        total += (width // tail[0] if fixed is not None else width) * esize
    return total


def lower(info: TreeInfo, vm_trees: Sequence[int], layout: Dict) -> Program:
    """K1v's program for the trees ``vm_trees`` against ``layout``."""
    gen, tables, entries = _lower_trees(info, Layout(layout), vm_trees)
    over = _limits(gen)
    if over:
        raise LoweringError(f'K1v limit exceeded at this layout: {over}')
    prog = Program(gen, tables[1], entries, list(vm_trees), info.n_uniq,
                   info.n_cols_u)
    prog.row_bytes = _row_bytes(layout, tables[2])
    prog.layout = layout
    return prog
