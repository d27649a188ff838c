"""Lowering of the status programs to K1v bytecode (``csrc/k1_vm.cuh``).

K1v evaluates every unique status tree of a policy set over a batch in
one launch: one thread per (row, part of a tree) runs the part's
instruction stream against the packed ``[R, W]`` lane buffers of
``pack_batch``.  This module turns each tree into that stream.  It mirrors the eager
walk of ``ops/eval.py`` (``leaf_op_tf``, ``string_term_tf``,
``cond_tf``, ``_cond_b_tf``, ``eval_status`` and ``_adm_match_graph``)
function by function, so the two can be read side by side: where the
walk builds a ``[R, ...]`` boolean tensor, the lowering builds a node
that the kernel evaluates per row.

Values.  Every value on the kernel's stack is a Kleene pair in two bits
(bit 0 known-true, bit 1 known-false).  A plain boolean is the known
pair ``(v, !v)``; Kleene AND/OR/NOT on known pairs are boolean, so the
walk's boolean algebra and its ``_K`` algebra share one representation.
``pair(t, f)`` builds ``_K(t, f)`` from two booleans; ``tof``/``fof``/
``uof`` read ``.t``/``.f``/``.unknown()`` back as booleans.

Element axes become loops.  Where the walk reduces an ``[R, E]`` or
``[R, G]`` tensor over its last axis, the node is a loop over that
element index (levels 0 and 1 for the two slot element axes, level 2
for a gather's elements, level 3 for a ``foreach`` list element) whose
body is reduced into a Kleene accumulator.  A lane is read at the
indices of the levels it has, so a slot shallower than its context
broadcasts by construction: a per-foreach-element gather
(``e{k}_*``, ``[R, FE, EG]``) is read at levels (3, 2), its metadata
(``[R, FE]``) at level 3.

Status trees (PASS/FAIL/SKIP/HOST/SKIP_PRECOND/VAR_ERR, detail, fail
detail) run on a second stack of ``(s, d, fd)`` triples; ``forall`` and
``exists`` are status loops whose accumulator keeps the first failing
element, the undecidable elements before it and element 0's fail
detail, exactly as the walk's ``argmax``/``gather`` do.  A ``foreach``
node folds one loop over its list per entry into a status accumulator
(``SFEBEGIN``/``SFEENTRY``/``SFEEND``).

The per-row admission match (K1i) is one more entry per eligible
program of the policy set's admission table: a boolean over the
``__adm*`` lanes whose ``AEND`` writes the program's int8 admission
column.

Parts.  A tree whose root is a ``seq`` of several children is cut into
parts, runs of consecutive children (``_split``, bounded by
``PART_INSNS``), that run on warps of one block in parallel; each ends
in ``PEND``, and the kernel folds a tree's parts in child order as
``SSEQ`` does.  Parts are packed into groups of ``GROUP_WARPS``
(``_pack``), one block per (row tile, group), and each group's
instructions and lanes are laid out contiguously so that its block can
stage them in shared memory (``Program``).

Loops that stop at the count.  A loop whose elements at or past the
row's count provably add the reduction's identity is marked with that
count's lane and runs only up to it (``Lowering.count_lane`` states the
rule); any other loop runs its full width.

Lowering is per (evaluator, pack layout): lanes resolve to (buffer,
column, element stride) of the layout, loop widths to its element and
gather widths.  ``route_trees`` decides at build time, from the IR,
which trees the kernel takes: every tree, unless it is past one of the
kernel's named limits (``_limits``).  ``lower`` binds the kernel's
trees and the admission entries to one layout.
"""

from __future__ import annotations

import itertools
import json as _json
from fractions import Fraction
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..compiler.admission import LANE_NAMES as ADM_LANES
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
from .kernels import glob_program

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1

# --- the kernel's fixed limits (k1_vm.cuh K1VM_*) ---------------------------
KSTACK = 32         # Kleene stack entries
SSTACK = 16         # status stack entries
LOCALS = 16         # let-bound Kleene locals
FRAMES = 4          # nested loops
LEVELS = 4          # loop index levels (slot elements 0-1, gather 2, foreach 3)
MAX_PATTERN = 256   # glob pattern bytes (as K1c)
MAX_WINDOW = 64     # str_head bytes (the glob DP's 64-bit masks)

# --- opcodes (k1_vm.cuh enum K1vmOp; the order is the ABI) ------------------
OPS = ('K', 'TAG', 'LB', 'CI', 'ABSLE', 'F64', 'F64DUR', 'BYTES', 'GLOB',
       'IDXLT', 'AND', 'OR', 'NOT', 'PAIR', 'TOF', 'FOF', 'UOF', 'TU',
       'BLOCK', 'MASK', 'FIXF', 'BOR', 'BLOCKT', 'BLOCKF', 'STORE', 'LOAD',
       'LOOP', 'ENDLOOP', 'SCONST', 'SFROMK', 'SVARERR', 'SFAILGUARD',
       'STRACKFAIL', 'SSEQ', 'SANY', 'SEQUALITY', 'SCOND', 'SLOOP',
       'SENDLOOP', 'SFORALL', 'SEXISTS', 'SSCALARS', 'PEND', 'SUSP',
       'IDXLAST', 'PACK2', 'IDIN', 'SFEBEGIN', 'SFEENTRY', 'SFEEND', 'AEND')
OP = {name: i for i, name in enumerate(OPS)}
#: comparison codes (k1_vm.cuh k1vm_cmp)
CMP = {'>': 0, '>=': 1, '<': 2, '<=': 3, '==': 4, '!=': 5}
#: loop reductions: Kleene AND, Kleene OR, bitwise OR of both bits
RED_AND, RED_OR, RED_BOR = 0, 1, 2
#: packed buffers in the order the kernel takes them, with their dtypes
BUFFERS = (('pk_uint8', 'uint8'), ('pk_int8', 'int8'), ('pk_bool', 'bool'),
           ('pk_int32', 'int32'), ('pk_int64', 'int64'))
_BUF_INDEX = {name: i for i, (name, _dt) in enumerate(BUFFERS)}
#: int32 words per instruction and per lane-table entry; a lane is
#: (buffer, column, stride, c0, c1, c2, constant, c3): element
#: c0*i0 + c1*i1 + c2*i2 + c3*i3 + constant of the loop indices
INSN_WORDS = 6
LANE_WORDS = 8
#: the foreach list element's loop level
FE_LEVEL = 3
#: instruction words that hold a lane-table index, per opcode (LOOP's and
#: SLOOP's word 5 only when it is not -1)
LANE_WORDS_OF = {
    'TAG': (1,), 'LB': (1,), 'CI': (1,), 'ABSLE': (1,), 'F64': (1,),
    'F64DUR': (1,), 'BYTES': (1,), 'GLOB': (1, 2, 3), 'IDXLT': (1,),
    'IDXLAST': (1,), 'SUSP': (1, 2), 'IDIN': (1,), 'SVARERR': (1,),
    'SSCALARS': (1, 2), 'SFORALL': (1, 2), 'SEXISTS': (1, 2),
    'LOOP': (5,), 'SLOOP': (5,)}

# --- the launch (k1_vm.cu) ---------------------------------------------------
#: rows of a block: one warp's lanes
TILE_ROWS = 32
#: warps of a block, and so the most parts of one tree (a tree's parts
#: fold in its block's shared memory)
GROUP_WARPS = 8
#: a ``seq`` root's children are cut into parts of consecutive children
#: whose instructions per row (``_Gen.dyn``, at the layout's widths) stay
#: within this, a child past it alone; where that gives more than
#: GROUP_WARPS parts, the least bound that gives GROUP_WARPS
PART_INSNS = 1024
#: instructions of a group, unless one tree alone has more: what a block
#: stages stays near this (24 bytes each, and their lanes)
GROUP_INSNS = 2048
#: the most bytes of tables (instructions, lanes, constant pools) a block
#: copies into shared memory; a group past it reads them from device
#: memory (the kernel's global mode)
STAGE_BYTES = 96 * 1024
#: bytes of one part's slot: a K1vmStatus
SLOT_BYTES = 8

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
# loops that stop at the row's count

#: the reductions' identities: known-true for AND, known-false for OR,
#: no bit for a bitwise OR
_IDENTITY = {RED_AND: 1, RED_OR: 2, RED_BOR: 0}


def _kand(x: int, y: int) -> int:
    return ((x & y) & 1) | ((x | y) & 2)


def _kor(x: int, y: int) -> int:
    return ((x | y) & 1) | ((x & y) & 2)


def _known(v) -> int:
    return 1 if v else 2


_UNARY = {'NOT': lambda v: ((v & 1) << 1) | ((v >> 1) & 1),
          'TOF': lambda v: _known(v & 1), 'FOF': lambda v: _known(v & 2),
          'UOF': lambda v: _known((v & 3) == 0),
          'FIXF': lambda v: 1 if v & 1 else v}


def _past(x: X, lane: int, level: int, env: Dict[int, Optional[int]]
          ) -> Optional[int]:
    """The two bits node ``x`` holds at every element whose index at
    ``level`` is at or past the count in lane ``lane``, where
    ``IDXLT(lane, level)`` is known-false, if they follow from the node
    alone (k1_vm.cuh's semantics of each opcode, evaluated on what is
    known); None if they do not.  A nested loop is not looked into."""
    op, a = x.op, x.args
    if op == 'IDXLT':
        return 2 if (a[0], a[1]) == (lane, level) else None
    if op == 'K':
        return a[0]
    if op == 'VAR':
        return env.get(a[0])
    if op == 'LET':
        inner = dict(env)
        inner[a[0]] = _past(a[1], lane, level, env)
        return _past(a[2], lane, level, inner)
    if op in _UNARY:
        v = _past(a[0], lane, level, env)
        return None if v is None else _UNARY[op](v)
    if op not in ('AND', 'OR', 'PAIR', 'TU', 'BLOCK', 'MASK', 'BOR',
                  'BLOCKT', 'BLOCKF', 'PACK2'):
        return None
    p = _past(a[0], lane, level, env)
    q = _past(a[1], lane, level, env)
    if op == 'AND' and 2 in (p, q):
        return 2
    if op == 'OR' and 1 in (p, q):
        return 1
    if op == 'TU' and p is not None and p & 1:
        return 1
    if op in ('BLOCK', 'MASK', 'BLOCKT', 'BLOCKF') and q is not None:
        hit = bool(q & 1) if op != 'MASK' else not q & 1
        if not hit:
            return p
        if op in ('BLOCK', 'MASK'):
            return 0
        return None if p is None else p & (2 if op == 'BLOCKT' else 1)
    if p is None or q is None:
        return None
    if op == 'AND':
        return _kand(p, q)
    if op == 'OR':
        return _kor(p, q)
    if op == 'PAIR':
        return (p & 1) | ((q & 1) << 1)
    if op == 'TU':
        return 2 if not q & 1 else 0
    if op == 'BOR':
        return p | q
    if op == 'PACK2':
        return (p & 3) | ((q & 3) << 2)
    return None


def _idxlt_lanes(x: X, level: int, out: List[int]) -> List[int]:
    """The count lanes of the ``IDXLT`` nodes at ``level`` in ``x``,
    outside nested loops, in order of first appearance."""
    if x.op == 'IDXLT':
        if x.args[1] == level and x.args[0] not in out:
            out.append(x.args[0])
    elif x.op not in ('LOOP', 'SLOOP'):
        for arg in x.args:
            if isinstance(arg, X):
                _idxlt_lanes(arg, level, out)
    return out


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
    2; a per-foreach-element gather: 3, 2); ``fixed`` pins the last
    element axis, a gather's element index (``_View(t, p, i)``)."""

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
        coef = [0] * LEVELS
        const = 0
        if self.fixed is not None and len(dims) != len(self.levels):
            raise LoweringError(f'{full}: fixed index on {tail}')
        if len(dims) > len(self.levels):
            raise LoweringError(f'{full}: {len(dims)} element axes '
                                f'in a view of {len(self.levels)}')
        mult = 1
        axes = list(zip(self.levels, dims))
        for k in range(len(axes) - 1, -1, -1):
            lvl, n = axes[k]
            if self.fixed is not None and k == len(axes) - 1:
                const = self.fixed * mult
            else:
                coef[lvl] = mult
            mult *= n
        return self.lw.lane(buf, off + start, stride, coef, const)

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

    def f64dur(self, cmp: str, value: float, nanos: bool = False) -> X:
        """``trunc((milli.to(float64) / 1000.0) * 1e9) / 1e9 cmp value``;
        with ``nanos``, the truncated product itself against ``value``."""
        return X('F64DUR', self.ref('milli'), CMP[cmp], float(value),
                 int(nanos))

    def bytes_eq(self, name: str, start: int, const: bytes) -> X:
        return X('BYTES', self.ref(name, start), bytes(const))

    def suspicious(self) -> X:
        """The eager ``_suspicious_scalar``: a '-' in the value, a '['
        after only whitespace, a wildcard, or a value past the window."""
        susp = X('SUSP', self.ref('str_head'), self.ref('str_len'))
        if self.has('has_wild'):
            susp = susp | self.b('has_wild')
        return susp

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
# conditions — eval._cond_b_tf and _b_equals (mode B: a constant key
# against a per-foreach-element gathered value)

def _b_equals(sv: View, key: Any, scalar: X) -> X:
    """operators._equal(const_key, gathered_value)."""
    if isinstance(key, bool):
        nz = sv.cmp('milli', '!=', 0)
        tv = scalar & sv.is_tag(TAG_BOOL) & (nz if key else ~nz)
        return pair(tv, ~tv)
    f53 = 1 << 53
    if isinstance(key, (int, float)):
        kf = Fraction(str(key)) * 1000
        if kf.denominator == 1 and abs(kf) <= _I64_MAX:
            num_t = sv.numish & sv.b('milli_ok') & \
                sv.cmp('milli', '==', int(kf))
        else:
            num_t = KF
        mok53 = sv.b('milli_ok') & sv.abs_le('milli', f53)
        is_flt = sv.is_tag(TAG_STRING) & sv.b('str_is_float')
        str_t = is_flt & mok53 & sv.f64('milli', 1000.0, '==', float(key))
        str_u = is_flt & ~mok53
        num_u = sv.numish & ~sv.b('milli_ok')
        return tu(scalar & (num_t | str_t), scalar & (num_u | str_u))
    if isinstance(key, str):
        is_str = sv.is_tag(TAG_STRING)
        try:
            kd = parse_duration(key) if key != '0' else None
        except (ValueError, TypeError):
            kd = None
        if kd is not None:
            v_dur = is_str & sv.b('str_is_dur') & ~sv.b('lit_zero')
            if abs(kd) <= _I64_MAX:
                dur_t = v_dur & sv.b('nanos_ok') & sv.cmp('nanos', '==', kd)
                dur_u = v_dur & ~sv.b('nanos_ok')
                mok53 = sv.b('milli_ok') & sv.abs_le('milli', f53)
                num_t = sv.numish & mok53 & \
                    sv.f64dur('==', float(kd), nanos=True)
                num_u = sv.numish & ~mok53
            else:
                dur_t = num_t = KF
                dur_u = v_dur
                num_u = sv.numish
            rest = is_str & ~v_dur
        else:
            dur_t = dur_u = num_t = num_u = KF
            rest = is_str
        try:
            kq = Quantity.parse(key)
        except ValueError:
            kq = None
        wild_zone = None
        if kq is not None:
            m = kq.value * 1000
            if m.denominator == 1 and abs(m.numerator) <= _I64_MAX:
                qty_t = rest & sv.b('str_is_qty') & sv.b('milli_ok') & \
                    sv.cmp('milli', '==', int(m))
            else:
                qty_t = KF
            qty_u = rest & sv.b('str_is_qty') & ~sv.b('milli_ok')
        else:
            qty_t = qty_u = KF
            wild_zone = rest
        if wild_zone is None:
            return tu(scalar & (dur_t | num_t | qty_t),
                      scalar & (dur_u | num_u | qty_u))
        # wildcard: match(value_as_pattern, K), equality unless wild
        hw = sv.b('has_wild') if sv.has('has_wild') else KF
        return let(sv.eq_const(key), lambda w_eq: tu(
            scalar & (dur_t | num_t | qty_t | (wild_zone & tof(w_eq))),
            scalar & (dur_u | num_u | qty_u |
                      (wild_zone & ~tof(w_eq) & hw))))
    # None / list / dict const keys: _equal is False for gathered scalars
    return pair(KF, KT)


def cond_b(lw: 'Lowering', prefix: str, check: CondCheck) -> X:
    """Mode-B checks: constant key vs gathered value (foreach conditions
    like ``key: ALL, value: {{element...drop[]}}``)."""
    op = check.op
    key = check.key_const
    meta = lw.row_view(prefix)
    kind_is = lambda k: meta.cmp('kind', '==', k)   # noqa: E731
    overflow = meta.b('overflow')
    sv = lw.gather_view(prefix).at(0)
    ev = lw.gather_view(prefix)
    if op in ('equal', 'equals', 'notequal', 'notequals'):
        res = _b_equals(sv, key, kind_is(1))
        if op in ('notequal', 'notequals'):
            res = ~res
    elif key is None or isinstance(key, bool):
        # host: key not str/num/list → False for every variant
        res = pair(KF, KT)
    else:
        # anyin / allin / anynotin / allnotin with a scalar const key
        negate = op in ('anynotin', 'allnotin')
        ks = key if isinstance(key, str) else _sprint(key)
        # value list: ∃ element matching either direction
        em = let(ev.eq_const(ks), lambda m_eq: let(
            ev.match_const_pattern(ks), lambda m_pat: pair(
                tof(m_eq) | tof(m_pat),
                fof(m_eq) & fof(m_pat) &
                (~ev.b('has_wild') if ev.has('has_wild') else KT))))
        valid = X('IDXLT', meta.ref('count'), 2)
        lst = blockf(lw.loop(2, ev.width('tag'), RED_OR,
                             let(em, lambda e: pair(valid & tof(e),
                                                    ~valid | fof(e)))),
                     overflow)
        # value scalar string: equality unless the value could be a
        # wildcard/range/JSON form at runtime
        is_str = sv.is_tag(TAG_STRING)
        scalar_str = kind_is(1) & is_str
        inv = (kind_is(1) & ~is_str) | kind_is(0)

        def result(ls, s_eq):
            r_t = (kind_is(2) & tof(ls)) | (scalar_str & is_str & tof(s_eq))
            r_f = (kind_is(2) & fof(ls)) | \
                (scalar_str & is_str & fof(s_eq) & ~sv.suspicious()) | inv
            return let(r_t, lambda rt: pair(rt, r_f & ~rt))

        res = let(lst, lambda ls: let(sv.eq_const(ks),
                                      lambda s_eq: result(ls, s_eq)))
        if negate:
            # r=None (invalid value types) stays False, not True
            res = let(res, lambda r: let(fof(r) & ~inv, lambda nt: pair(
                nt, (tof(r) | inv) & ~nt)))
    bad = meta.b('notfound') | (kind_is(0) & overflow)
    return block(res, bad)


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

    def lane(self, buf: str, off: int, stride: int, coef,
             const: int = 0) -> int:
        if buf not in _BUF_INDEX:
            raise LoweringError(f'unknown packed buffer {buf}')
        key = (_BUF_INDEX[buf], off, stride, coef[0], coef[1], coef[2],
               const, coef[3])
        hit = self.lanes.get(key)
        if hit is None:
            hit = self.lanes[key] = len(self.lane_rows)
            self.lane_rows.append(key)
        return hit

    def special(self, name: str, j: int = 0) -> int:
        """Element ``j`` of a per-row special lane (``__adm*``)."""
        buf, off, _width, _tail = self.L.entry(name)
        self.read.add((name, None))
        return self.lane(buf, off + j, 1, [0] * LEVELS)

    def slot_view(self, slot) -> View:
        return View(self, self.info.slot_prefix[slot],
                    tuple(range(slot.depth)))

    def array_view(self, path) -> View:
        depth = sum(1 for p in path if p == '*')
        return View(self, self.info.array_prefix[path], tuple(range(depth)))

    def gather_view(self, prefix: str) -> View:
        """A gather's elements: level 2, under the foreach list element
        (level 3) for a per-foreach-element gather."""
        return View(self, prefix, (FE_LEVEL, 2) if prefix[0] == 'e'
                    else (2,))

    def row_view(self, prefix: str) -> View:
        """A gather's metadata: per row, or per foreach list element."""
        return View(self, prefix, (FE_LEVEL,) if prefix[0] == 'e' else ())

    def loop(self, level: int, width: int, red: int, body: X) -> X:
        """A loop over ``level`` reducing ``body`` with ``red``, marked
        with the count lane past whose value it may stop
        (``count_lane``)."""
        return X('LOOP', level, width, red, body,
                 self.count_lane(body, level, _IDENTITY[red]))

    def count_lane(self, x: X, level: int, identity: int,
                   mask: int = 3) -> int:
        """The stop rule.  A loop over ``level`` may stop at the row's
        count in lane L when every element at or past it gives its
        reduction's identity: ``x`` evaluates there, from
        ``IDXLT(L, level)`` being known-false and from what is known of
        each opcode, to ``identity`` in the bits of ``mask`` (``_past``;
        for example ``~valid | x`` under AND, ``valid & x`` under OR,
        ``MASK(x, valid)`` and the foreach entries' ``PACK2`` of pairs
        of ``valid & ...`` under a bitwise OR).  L must not vary with
        the loop's own index.  The candidates are the loop's own
        ``IDXLT`` nodes, outside nested loops, so a deeper level's count
        never stops an outer loop.  Returns L, or -1 where no candidate
        is proved: the loop then runs its full width."""
        coef = 3 + level if level < 3 else 7
        for lane in _idxlt_lanes(x, level, []):
            if self.lane_rows[lane][coef]:
                continue
            got = _past(x, lane, level, {})
            if got is not None and got & mask == identity:
                return lane
        return -1

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
            if check.value_gather is not None:
                return cond_b(self, self.info.elem_prefix[check.value_gather],
                              check)
            prefix = self.info.elem_prefix[check.gather] \
                if isinstance(check.gather, ElemGather) \
                else self.info.gather_prefix[check.gather]
            return cond(self, prefix, check)
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
            # SENDLOOP folds only valid elements (bit 0 of ``valid``),
            # and element 0's fail detail, which the loop always runs
            loop = X('SLOOP', depth, self.L.E, sub, valid,
                     self.count_lane(valid, depth, 0, mask=1))
            if kind == 'exists':
                return X('SEXISTS', loop, tag, ovf, self.site_fd(node))
            return X('SFORALL', loop, tag, ovf, self.site_fd(node))
        if kind == 'trackfail':
            return X('STRACKFAIL', self.status(node.sub, depth, aux),
                     self.expr(node.expr, depth))
        if kind == 'foreach':
            if depth != 0:
                raise LoweringError('foreach below the top level')
            return X('SFOREACH', tuple(self.foreach_entry(e)
                                       for e in node.operand))
        raise LoweringError(f'status kind {kind!r}')

    def foreach_entry(self, entry) -> Tuple[X, X, X]:
        """One entry of a ``foreach`` node (the eager ``eval_status``
        'foreach' branch): whether its list query resolved (``active``),
        its overflow, and a loop over the list's elements whose bitwise
        OR holds, per valid element, FAIL | PASS << 1 | undecidable << 2
        | (the last element errs) << 3.  Conditions are evaluated at
        depth 0; a const-folded one reads no level-3 lane and so
        broadcasts over the elements (the walk's ``at_elem``)."""
        lp = self.info.gather_prefix[entry.list_gather]
        meta = self.row_view(lp)
        elems = View(self, lp, (FE_LEVEL,))
        # null elements are skipped
        valid = X('IDXLT', meta.ref('count'), FE_LEVEL) & \
            ~elems.is_tag(TAG_NULL)
        # element variable errors (first missing var → ERROR element)
        errs = [self.row_view(self.info.elem_prefix[eg]).b('notfound')
                for eg in entry.err_gathers]
        elem_err = k_any(errs) if errs else KF
        pre = self.expr(entry.precond, 0) if entry.precond is not None \
            else KT
        deny = self.expr(entry.deny, 0)
        # an ERROR element returns only at the true last index
        last = X('IDXLAST', meta.ref('count'), FE_LEVEL)

        def body(v, e, p, d):
            ok = v & ~e
            return X('PACK2',
                     pair(ok & tof(p) & tof(d), ok & tof(p) & fof(d)),
                     pair(ok & (uof(p) | (tof(p) & uof(d))), v & e & last))

        elem = let(valid, lambda v: let(elem_err, lambda e: let(
            pre, lambda p: let(deny, lambda d: body(v, e, p, d)))))
        loop = self.loop(FE_LEVEL, elems.width('tag'), RED_BOR, elem)
        return ~meta.cmp('kind', '==', 0), meta.b('overflow'), loop


# ---------------------------------------------------------------------------
# the per-row admission match — eval._adm_match_graph (K1i)

def adm_entry(lw: Lowering, prog) -> X:
    """The admission match of one eligible program (``compiler/
    admission.py`` ``AdmProgram``): the static filter tree over the
    resource-shape atoms and the per-row user-info id lanes, as a known
    boolean (match & ~exclude)."""
    def flag(name):
        return X('LB', lw.special(name))

    def member(name, ids):
        # ∃ lane value ∈ ids (ids ≥ 0; -1 marks an absent slot)
        width = int(np.prod(lw.L.entry(name)[3], dtype=np.int64))
        return X('IDIN', lw.special(name), width, tuple(int(i) for i in ids))

    excluded = flag('__adm_excluded__')
    hasinfo = flag('__adm_hasinfo__')

    def ui_ok(f):
        # excluded users skip role gates entirely, and ride the
        # exclude-group-roles Group subjects the host matcher appends
        ok = None
        if f.has_roles:
            hit = member('__adm_roles__', f.roles) if f.roles else KF
            ok = excluded | hit
        if f.has_croles:
            hit = member('__adm_croles__', f.cluster_roles) \
                if f.cluster_roles else KF
            ok = (excluded | hit) if ok is None else ok & (excluded | hit)
        if f.has_subjects:
            hit = KF
            if f.subjects_ug:
                # User/Group names match any of groups ∪ {username}
                hit = hit | member('__adm_groups__', f.subjects_ug) | \
                    member('__adm_user__', f.subjects_ug)
            if f.subjects_sa:
                hit = hit | member('__adm_user__', f.subjects_sa)
            sub = hit | excluded
            ok = sub if ok is None else ok & sub
        return ok if ok is not None else KT

    def filter_ok(f, mode):
        res_ok = X('LB', lw.special('__admres__', f.atom))
        if mode == 'match':
            # without admission info the matcher drops user info: a
            # filter reduced to nothing is 'match cannot be empty'
            if not f.has_ui:
                return res_ok if f.has_res else KF
            without = res_ok if f.has_res else KF
            return (hasinfo & res_ok & ui_ok(f)) | (~hasinfo & without)
        # exclude mode: user info always applies; an empty filter
        # never excludes (folded to 'none' at compile time)
        if not f.has_ui and not f.has_res:
            return KF
        return res_ok & ui_ok(f) if f.has_ui else res_ok

    def combine(kind, oks):
        if kind == 'none' or not oks:
            return KF
        return k_all(oks) if kind == 'all' else k_any(oks)

    m = combine(prog.match_kind,
                [filter_ok(f, 'match') for f in prog.match_filters])
    e = combine(prog.exclude_kind,
                [filter_ok(f, 'exclude') for f in prog.exclude_filters])
    return m & ~e


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

    def i64_block(self, values: Tuple[int, ...]) -> int:
        """Start of ``values`` laid out consecutively in the int64 pool."""
        key = ('block',) + tuple(values)
        hit = self._i64.get(key)
        if hit is None:
            hit = self._i64[key] = len(self.i64)
            self.i64.extend(values)
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
            self.put('F64DUR', a[0], a[1], self.f64_index(a[2]), a[3])
            self.push_k()
        elif op == 'BYTES':
            self.put('BYTES', a[0], 0, self.bytes_index(a[1]), len(a[1]))
            self.push_k()
        elif op == 'GLOB':
            # the limit counts the pattern's own bytes; the pool holds it
            # compiled (runs, stars, the '?' flag), decided once here
            self.max_pattern = max(self.max_pattern, len(a[3]))
            prog = glob_program(a[3])
            self.put('GLOB', a[0], a[1], a[2], self.bytes_index(prog),
                     len(prog))
            self.push_k()
        elif op in ('IDXLT', 'IDXLAST', 'SUSP'):
            self.put(op, a[0], a[1])
            self.push_k()
        elif op == 'IDIN':
            self.put('IDIN', a[0], a[1], self.i64_block(a[2]), len(a[2]))
            self.push_k()
        elif op in ('NOT', 'TOF', 'FOF', 'UOF', 'FIXF'):
            self.kleene(a[0])
            self.put(op)
        elif op in ('AND', 'OR', 'PAIR', 'TU', 'BLOCK', 'MASK', 'BOR',
                    'BLOCKT', 'BLOCKF', 'PACK2'):
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
            level, width, red, body, lane = a
            start = self.put('LOOP', level, width, red, 0, lane)
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
            level, width, sub, valid, lane = a[0].args
            start = self.put('SLOOP', level, width, 0, 0, lane)
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
        elif op == 'SFOREACH':
            self.put('SFEBEGIN')
            self.push_s()
            for active, overflow, loop in a[0]:
                self.kleene(active)
                self.kleene(overflow)
                self.kleene(loop)
                self.put('SFEENTRY')
                self.k -= 3
            self.put('SFEEND')
        else:
            raise LoweringError(f'not a status node: {op}')

    def part(self, x: X) -> int:
        """A status tree or one part of it: its ``PEND`` leaves the
        triple in the part's slot, which the kernel's epilogue folds
        into the tree's column."""
        start = len(self.code)
        self.status(x)
        self.put('PEND')
        self.s -= 1
        assert self.k == 0 and self.s == 0 and self.frames == 0
        return start

    def adm(self, x: X, col: int) -> int:
        """An admission entry: a Kleene value whose ``AEND`` writes its
        known-true bit into admission column ``col``."""
        start = len(self.code)
        self.kleene(x)
        self.put('AEND', col)
        self.k -= 1
        assert self.k == 0 and self.s == 0 and self.frames == 0
        return start


# ---------------------------------------------------------------------------
# routing (build time) and lowering (per layout)

class TreeInfo:
    """What the lowering needs of an evaluator: the prefixes of its
    slots, arrays, gathers and per-foreach-element gathers, its unique
    trees and their aux columns, and its admission table (None without
    admission-dependent rules)."""

    def __init__(self, cps, uniq_trees, uniq_aux_base, n_uniq: int,
                 n_cols_u: int, adm_table=None):
        from ..compiler.encode import _needs_cached
        self.slot_prefix = {slot: f's{i}' for i, slot in enumerate(cps.slots)}
        self.gather_prefix = {g: f'g{k}' for k, g in enumerate(cps.gathers)}
        self.elem_prefix = {g: f'e{k}'
                            for k, g in enumerate(cps.elem_gathers)}
        _, _, _, array_paths = _needs_cached(cps)
        self.array_prefix = {path: f'a{j}'
                             for j, path in enumerate(array_paths)}
        self.trees = list(uniq_trees)
        self.aux_base = list(uniq_aux_base)
        self.n_uniq = n_uniq
        self.n_cols_u = n_cols_u
        self.adm_table = adm_table


def has_adm_lanes(layout: Dict) -> bool:
    return all(name in layout for name in ADM_LANES)


class Program:
    """K1v's bytecode for one (evaluator, layout) and its launch plan, as
    numpy arrays; ``device_tables`` keeps them on each device once.

    An entry is a status tree, whose parts (``_lower_trees``) each end in
    ``PEND``, or the admission match of an eligible program, whose
    ``AEND`` writes admission column ``col``.  Entries are packed into
    groups of ``GROUP_WARPS`` parts, a tree's parts in one group: the
    kernel runs a block per (tile of ``TILE_ROWS`` rows, group) and a
    warp per part.  ``warps`` holds, per (group, warp), the part's first
    instruction (-1: no part), the parts the warp folds into the tree's
    column in the epilogue (its tree's part count on the first part, 0
    otherwise) and that column.  ``groups`` holds each group's
    instruction range, its lane range and whether the block stages them
    in shared memory (``staged``), which it does when they and the
    constant pools fit ``STAGE_BYTES``."""

    def __init__(self, gen: _Gen, lanes: List[Tuple[int, ...]],
                 warps: List[Tuple[int, int, int]],
                 groups: List[Tuple[int, int, int, int]],
                 tree_parts: Dict[int, int], vm_cols: List[int],
                 n_uniq: int, n_cols_u: int, n_adm: int = 0):
        self.code = np.asarray(gen.code, np.int32).reshape(-1, INSN_WORDS)
        self.lanes = np.asarray(lanes, np.int32).reshape(-1, LANE_WORDS)
        self.i64 = np.asarray(gen.i64 or [0], np.int64)
        self.f64 = np.asarray(gen.f64 or [0.0], np.float64)
        self.bytes = np.frombuffer(bytes(gen.bytes) or b'\0',
                                   np.uint8).copy()
        self.warps = np.asarray(warps, np.int32).reshape(-1, 3)
        self.group_warps = GROUP_WARPS
        self.groups = np.asarray([g + (0,) for g in groups],
                                 np.int32).reshape(-1, 5)
        self._stage(STAGE_BYTES)
        #: parts per status tree (unique column) of the program
        self.tree_parts = dict(tree_parts)
        self.n_entries = len(tree_parts) + n_adm
        self.vm_cols = list(vm_cols)
        self.n_uniq = n_uniq
        self.n_cols_u = n_cols_u
        #: admission columns (``AdmissionTable.program_cols()`` order)
        self.n_adm = n_adm
        self.depths = {'kstack': gen.max_k, 'sstack': gen.max_s,
                       'frames': gen.max_frames, 'locals': gen.max_locals}
        #: bytes of the packed lanes the bytecode reads, per row, and the
        #: layout it was lowered against (set by ``lower``)
        self.row_bytes = 0
        self.layout = None
        #: instructions one row executes over all the program's entries
        #: with every loop at its full width (a loop that stops at the
        #: count runs fewer)
        self.row_insns = gen.dyn

    def _stage(self, budget: int) -> None:
        """Stage each group whose tables (its instructions and lanes and
        the constant pools) fit ``budget`` bytes; ``smem_bytes``, a
        block's dynamic shared memory, holds the slots and the largest
        staged group's tables (k1_vm.cu's layout)."""
        pools = 8 * len(self.i64) + 8 * len(self.f64) + len(self.bytes)
        g = self.groups
        need = pools + 4 * INSN_WORDS * (g[:, 1] - g[:, 0]) + \
            4 * LANE_WORDS * (g[:, 3] - g[:, 2])
        g[:, 4] = need <= budget
        #: groups staged in shared memory (the rest run the global mode)
        self.n_staged = int(g[:, 4].sum())
        self.smem_bytes = GROUP_WARPS * TILE_ROWS * SLOT_BYTES + int(
            need[g[:, 4] == 1].max(initial=0))
        self._dev = {}

    def restaged(self, budget: int) -> 'Program':
        """This program with its groups staged under another budget
        (0: every block reads the device tables, the kernel's global
        mode), to measure or test one mode against the other."""
        import copy
        out = copy.copy(self)
        out.groups = self.groups.copy()
        out._stage(budget)
        return out

    @property
    def n_groups(self) -> int:
        return self.groups.shape[0]

    def blocks(self, rows: int) -> int:
        """Blocks of a launch over ``rows`` rows."""
        return -(-rows // TILE_ROWS) * self.n_groups

    def device_tables(self, device) -> Dict[str, Any]:
        import torch
        hit = self._dev.get(device)
        if hit is None:
            hit = {name: torch.from_numpy(getattr(self, name)).to(device)
                   for name in ('code', 'lanes', 'i64', 'f64', 'bytes',
                                'warps', 'groups')}
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


def _dyn(x: X) -> int:
    """Instructions one row executes for status node ``x`` at full
    width."""
    gen = _Gen()
    gen.status(x)
    return gen.dyn


def _runs(dyns: Sequence[int], bound: int) -> int:
    """How many runs of consecutive items the greedy cut makes when a
    run's ``dyns`` stay within ``bound`` (an item past it alone)."""
    n, acc = 0, None
    for d in dyns:
        if acc is None or acc + d > bound:
            n, acc = n + 1, 0
        acc += d
    return n


def _split(kids: List[X]) -> List[X]:
    """The parts of a ``seq`` root with children ``kids``.  Their number
    is that of the runs of consecutive children within ``PART_INSNS``
    instructions (``_Gen.dyn``), at most ``GROUP_WARPS``; the cut into
    that many runs is the one whose largest run is least, and among
    those the most even (least sum of squares).  Each part is the SSEQ
    fold of its run."""
    dyns = [_dyn(k) for k in kids]
    n = min(_runs(dyns, PART_INSNS), GROUP_WARPS)
    pre = [0]
    for d in dyns:
        pre.append(pre[-1] + d)
    lo, hi = max(dyns), pre[-1]
    while lo < hi:                   # the least largest run of n runs
        mid = (lo + hi) // 2
        if _runs(dyns, mid) <= n:
            hi = mid
        else:
            lo = mid + 1
    # best[k][i]: (sum of squares, previous cut) of the first i children
    # in k runs of at most lo instructions each
    inf = (float('inf'), -1)
    best = [[inf] * (len(kids) + 1) for _ in range(n + 1)]
    best[0][0] = (0, -1)
    for k in range(1, n + 1):
        for i in range(1, len(kids) + 1):
            for j in range(k - 1, i):
                run = pre[i] - pre[j]
                if run <= lo and best[k - 1][j][0] + run * run < best[k][i][0]:
                    best[k][i] = (best[k - 1][j][0] + run * run, j)
    cuts, i = [], len(kids)
    for k in range(n, 0, -1):
        j = best[k][i][1]
        cuts.append((j, i))
        i = j
    parts = []
    for a, b in reversed(cuts):
        out = kids[a]
        for kid in kids[a + 1:b]:
            out = X('SSEQ', out, kid)
        parts.append(out)
    return parts


def _pack(units: Sequence[Tuple[int, int]]) -> List[List[int]]:
    """Units of (parts, instructions) packed into groups of GROUP_WARPS
    warps whose instructions stay within GROUP_INSNS (a larger unit
    alone): each unit goes to the fullest open group it fits, else opens
    a group."""
    groups: List[List[int]] = []
    free: List[int] = []
    insns: List[int] = []
    open_: List[int] = []
    for i, (n, c) in enumerate(units):
        fits = [g for g in open_ if free[g] >= n and
                insns[g] + c <= GROUP_INSNS]
        if fits:
            g = min(fits, key=lambda g: free[g])
        else:
            g = len(groups)
            groups.append([])
            free.append(GROUP_WARPS)
            insns.append(0)
            open_.append(g)
        groups[g].append(i)
        free[g] -= n
        insns[g] += c
        if not free[g]:
            open_.remove(g)
    return groups


def _remap_lanes(code: List[List[int]], lane_rows: List[Tuple[int, ...]],
                 ranges: List[Tuple[int, int]]):
    """A lane table per group, each group's lanes contiguous (a lane two
    groups read appears in both), and the instructions' lane words
    rewritten to index it: (lanes, [(lane_lo, lane_hi)])."""
    lanes: List[Tuple[int, ...]] = []
    spans = []
    for lo, hi in ranges:
        local: Dict[int, int] = {}
        base = len(lanes)
        for ins in code[lo:hi]:
            for w in LANE_WORDS_OF.get(OPS[ins[0]], ()):
                if ins[w] < 0:
                    continue
                hit = local.get(ins[w])
                if hit is None:
                    hit = local[ins[w]] = len(lanes)
                    lanes.append(lane_rows[ins[w]])
                ins[w] = hit
        spans.append((base, len(lanes)))
    return lanes, spans


def _emit(gen: _Gen, col: int, parts: List[X], is_adm: bool
          ) -> List[Tuple[int, int, int]]:
    """Generate one entry's parts into ``gen``; returns their warps'
    rows (first instruction, parts to fold, column): the first part of
    a status tree folds them all into its column, an admission entry's
    ``AEND`` writes its own."""
    if is_adm:
        return [(gen.adm(parts[0], col), 0, 0)]
    pcs = [gen.part(part) for part in parts]
    return [(pcs[0], len(parts), col)] + [(pc, 0, 0) for pc in pcs[1:]]


def _lower_trees(info: TreeInfo, layout: Layout, trees: Sequence[int],
                 adm: bool = False):
    """Lower unique trees ``trees`` (and, with ``adm``, the admission
    entries) into one instruction stream: (gen, lanes, lanes read,
    warps, groups, parts per tree).  A tree whose root is a ``seq`` of
    several children is cut into parts (``_split``), any other tree and
    each admission entry is one part; the parts are packed into groups
    (``_pack``) and generated group by group, so that each group's
    instructions, and then its lanes (``_remap_lanes``), are
    contiguous."""
    tables = ({}, [], set())
    units = []      # (column, parts, admission entry)
    for u in trees:
        lw = Lowering(info, layout, tables)
        aux = [info.n_uniq + info.aux_base[u]]
        tree = info.trees[u]
        if tree.kind == 'seq' and len(tree.children) > 1:
            parts = _split([lw.status(c, 0, aux) for c in tree.children])
        else:
            parts = [lw.status(tree, 0, aux)]
        units.append((u, parts, False))
    if adm:
        for col, prog in enumerate(info.adm_table.programs):
            lw = Lowering(info, layout, tables)
            units.append((col, [adm_entry(lw, prog)], True))
    sizes = []
    for unit in units:
        trial = _Gen()
        _emit(trial, *unit)
        sizes.append((len(unit[1]), len(trial.code)))
    gen = _Gen()
    warps: List[Tuple[int, int, int]] = []
    ranges: List[Tuple[int, int]] = []
    for members in _pack(sizes):
        lo = len(gen.code)
        for i in members:
            warps += _emit(gen, *units[i])
        warps += [(-1, 0, 0)] * (-len(warps) % GROUP_WARPS)
        ranges.append((lo, len(gen.code)))
    lanes, spans = _remap_lanes(gen.code, tables[1], ranges)
    groups = [r + sp for r, sp in zip(ranges, spans)]
    tree_parts = {col: len(parts) for col, parts, is_adm in units
                  if not is_adm}
    return gen, lanes, tables[2], warps, groups, tree_parts


def route_trees(info: TreeInfo, probe_layout: Dict) -> Dict[int, Tuple[str, str]]:
    """``{unique tree: ('vm' | 'eager', reason)}``, decided once per
    evaluator from the IR.  Routes come from the kernel's named limits
    only (``_limits``: stack depths, loop nesting, locals, glob pattern
    bytes): a tree past one of them stays on the eager walk, every
    other tree, ``foreach`` trees included, goes to K1v.  The limits
    are read from a trial lowering against ``probe_layout`` (the policy
    set's lanes at the encoder's smallest widths); stack and loop
    depths and pattern lengths do not depend on the widths.  A tree the
    lowering cannot take raises ``LoweringError``: no construct is
    routed to the eager walk."""
    layout = Layout(probe_layout)
    routes: Dict[int, Tuple[str, str]] = {}
    for u in range(len(info.trees)):
        over = _limits(_lower_trees(info, layout, [u])[0])
        routes[u] = ('eager', over) if over else ('vm', 'lowered')
    return routes


_ESIZE = {'uint8': 1, 'int8': 1, 'bool': 1, 'int32': 4, 'int64': 8}


def _row_bytes(layout: Dict, read) -> int:
    """Bytes per row of the lanes in ``read``: a whole lane, or the
    lane at one fixed index of its last element axis."""
    total = 0
    for name, fixed in read:
        buf, _off, width, tail = layout[name]
        esize = _ESIZE[buf[len('pk_'):]]
        if fixed is not None:
            last = tail[-2] if name.rsplit('_', 1)[-1] in ('head', 'tail') \
                else tail[-1]
            width //= last
        total += width * esize
    return total


def lower(info: TreeInfo, vm_trees: Sequence[int], layout: Dict) -> Program:
    """K1v's program for the trees ``vm_trees`` against ``layout``, plus
    one admission entry per eligible program when the policy set has an
    admission table and the layout carries the admission lanes."""
    adm = info.adm_table is not None and has_adm_lanes(layout)
    gen, lanes, read, warps, groups, tree_parts = _lower_trees(
        info, Layout(layout), vm_trees, adm)
    over = _limits(gen)
    if over:
        raise LoweringError(f'K1v limit exceeded at this layout: {over}')
    prog = Program(gen, lanes, warps, groups, tree_parts, list(vm_trees),
                   info.n_uniq, info.n_cols_u,
                   len(info.adm_table.programs) if adm else 0)
    prog.row_bytes = _row_bytes(layout, read)
    prog.layout = layout
    return prog
