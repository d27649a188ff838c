"""Wrappers of the hand-written CUDA kernels, and their plain versions.

The evaluator (``ops/eval.py``), the device mutate decision
(``mutate/kernel.py``) and the sharded step's histogram
(``parallel/mesh.py``) run as kernels written for Hopper (``csrc/*.cu``,
built by ``ops/_build.py``):

* K1v ``status_vm`` — every unique status tree of a policy set over a
  packed batch, and the per-row admission match (K1i) of its eligible
  programs, as one launch of a bytecode interpreter (the bytecode and
  its launch plan from ``ops/vm.py``: a block per row tile and group of
  parts, a warp per part); its plain version is the evaluator's eager
  walk and ``_adm_match_graph``;
* K1h ``fdet_select`` — the tail of ``evaluate_packed`` over K1v's
  outputs: each row's relevance (FAIL, matched, row valid, with the
  ``uniq_any`` children expanded), its first k relevant columns and
  their fail details, and its out8 row, into one allocation;
* K1c ``wildcard_match`` — the glob DP of ``_View.wildcard_const`` and
  its Kleene verdict (the eager walk's; inside K1v the same DP runs
  from ``csrc/glob_dp.cuh``, over the pattern ``glob_program``
  compiles);
* K3 ``k3_mutate`` — per (resource, rule) of a lowered mutate set: the
  edit bitmask, the status and the first-fault reason, from the lanes
  staged in one buffer into one output buffer;
* K4h ``status_histogram`` — the per-rule verdict histogram of the
  sharded scan step (``parallel/mesh.py``), before its all-reduce.

Each wrapper checks device, dtype, shape and contiguity, launches on
the current CUDA stream, raises if the launch fails, and counts its
launches in ``LAUNCHES``; none waits for the card.  A tensor on the CPU takes the plain torch
version beside it; a CUDA tensor takes the kernel or raises — there is
no fallback.  The plain versions are what the CPU tests hold against
the JAX package, and what the card's kernels are held against.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compiler.ir import (STATUS_FAIL, TAG_ARRAY, TAG_BOOL, TAG_FLOAT,
                           TAG_INT, TAG_MISSING, TAG_STRING)

#: launches per kernel since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {'k1_vm': 0, 'k1h_fdet_select': 0,
                             'k1c_wildcard': 0, 'k3_mutate': 0,
                             'k4_status_hist': 0}

#: widest byte window and longest pattern the K1c kernel takes
#: (``STR_LEN`` = 64 bounds every ``str_head`` lane)
WILDCARD_MAX_WIDTH = 64
WILDCARD_MAX_PATTERN = 256

_CONV_TAGS = (TAG_STRING, TAG_INT, TAG_FLOAT, TAG_BOOL)


#: the CUDA symbol of each hand-written kernel, by its launch counter
#: (what a profiler trace names its launches)
KERNEL_SYMBOLS: Dict[str, str] = {
    'k1_vm': 'k1_vm_kernel', 'k1c_wildcard': 'wildcard_kernel',
    'k1h_fdet_select': 'fdet_select_kernel', 'k3_mutate': 'mutate_kernel',
    'k4_status_hist': 'status_hist_kernel'}

#: K1v's groups launched since the last ``reset_launches``, by how
#: their blocks read the program's tables: copied into shared memory
#: (``staged``), or from device memory where they exceed
#: ``ops/vm.py STAGE_BYTES`` (``global``)
K1V_GROUPS: Dict[str, int] = {'staged': 0, 'global': 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for mode in K1V_GROUPS:
        K1V_GROUPS[mode] = 0


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(cond: bool, what) -> None:
    """Raise ``ValueError(what)`` unless ``cond``; ``what`` may be a
    callable that makes the message, so a call that passes formats
    nothing."""
    if not cond:
        raise ValueError(what() if callable(what) else what)


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    _check(len(devs) == 1, f'tensors on several devices: {devs}')
    dev = next(iter(devs))
    if dev.type == 'cpu':
        return True
    _check(dev.type == 'cuda', f'unsupported device {dev}')
    return False


# ---------------------------------------------------------------------------
# K1v: the status-program interpreter

def status_vm(packed: Dict[str, torch.Tensor], program
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """``(s_u int8 [R, n_uniq], d_u int8 [R, n_uniq], fdet_u int32
    [R, n_cols_u], adm int8 [R, n_adm])`` of the packed batch ``packed``
    (``pack_batch``'s ``pk_*`` buffers, ``[R, W]`` each) under
    ``program``, K1v's bytecode for one (evaluator, layout)
    (``ops/vm.py`` ``Program``).  The columns of the program's trees are
    written, those of trees routed to the eager walk are zero; ``adm``
    holds the admission match of the policy set's eligible programs
    (no column when the layout has no admission lanes)."""
    return _status_vm(packed, program, None)


def status_vm_executed(packed: Dict[str, torch.Tensor], program) -> int:
    """Instructions K1v interprets over ``packed`` (CUDA tensors): one
    launch of ``status_vm``'s kernel that also counts them.  Loops that
    stop at the count make this fewer than ``rows * program.row_insns``;
    on the card a warp runs the largest count among its rows."""
    ts = list(packed.values())
    _check(bool(ts) and not _on_cpu(*ts),
           'status_vm_executed counts the card kernel\'s instructions')
    counter = torch.zeros(1, dtype=torch.int64, device=ts[0].device)
    _status_vm(packed, program, counter)
    return int(counter.item())


def _status_vm(packed, program, counter):
    # status_vm, and with ``counter`` (an int64 CUDA tensor [1]) the
    # instructions the launch interprets added to it
    from .vm import BUFFERS
    _check(bool(packed), 'packed holds no buffer')
    ts = list(packed.values())
    rows = ts[0].shape[0]
    for t in ts:
        _check(t.dim() == 2 and t.shape[0] == rows,
               f'packed buffers must be [{rows}, W], got {tuple(t.shape)}')
    if _on_cpu(*ts):
        return program.plain(packed)
    dtypes = {'uint8': torch.uint8, 'int8': torch.int8, 'bool': torch.bool,
              'int32': torch.int32, 'int64': torch.int64}
    ptrs, widths = [], []
    for name, dt in BUFFERS:
        t = packed.get(name)
        if t is None:
            ptrs.append(None)
            widths.append(0)
            continue
        _check(t.dtype == dtypes[dt], f'{name} must be {dt}, got {t.dtype}')
        _check(t.is_contiguous(), 'status_vm takes contiguous buffers')
        ptrs.append(t.data_ptr())
        widths.append(t.shape[1])
    dev = ts[0].device
    make = torch.empty if len(program.vm_cols) == program.n_uniq \
        else torch.zeros
    s_u = make((rows, program.n_uniq), dtype=torch.int8, device=dev)
    d_u = make((rows, program.n_uniq), dtype=torch.int8, device=dev)
    fd_u = make((rows, program.n_cols_u), dtype=torch.int32, device=dev)
    adm = torch.empty((rows, program.n_adm), dtype=torch.int8, device=dev)
    if rows == 0 or program.n_groups == 0:
        return s_u, d_u, fd_u, adm
    from . import _build
    lib = _build.load('k1_vm')
    tab = program.device_tables(dev)
    with torch.cuda.device(dev):
        rc = lib.k1_vm((ctypes.c_void_p * 5)(*ptrs),
                       (ctypes.c_longlong * 5)(*widths), rows,
                       tab['code'].data_ptr(), tab['lanes'].data_ptr(),
                       tab['i64'].data_ptr(), tab['f64'].data_ptr(),
                       tab['bytes'].data_ptr(), len(program.i64),
                       len(program.f64), len(program.bytes),
                       tab['warps'].data_ptr(), tab['groups'].data_ptr(),
                       program.n_groups, program.group_warps,
                       program.smem_bytes, s_u.data_ptr(), d_u.data_ptr(),
                       fd_u.data_ptr(),
                       adm.data_ptr() if program.n_adm else None,
                       program.n_uniq, program.n_cols_u, program.n_adm,
                       counter.data_ptr() if counter is not None else None,
                       _stream(ts[0]))
    if rc != 0:
        raise RuntimeError(f'k1_vm launch failed: CUDA error {rc}')
    LAUNCHES['k1_vm'] += 1
    K1V_GROUPS['staged'] += program.n_staged
    K1V_GROUPS['global'] += program.n_groups - program.n_staged
    return s_u, d_u, fd_u, adm


# ---------------------------------------------------------------------------
# K1h: the tail of a K1 call — relevance, compact fail-detail select and
# the out8 row, into one allocation

#: a lane of a packed batch as K1h reads it in place: the ``[R, W]``
#: buffer (``pack_batch``'s ``pk_*``, one byte per element) and the
#: lane's first column
Lane = Tuple[torch.Tensor, int]

_BYTE_DTYPES = (torch.uint8, torch.int8, torch.bool)


def fdet_row_bytes(n8: int, k: int) -> Tuple[int, int]:
    """``(row bytes, out32 offset)`` of K1h's output rows: the ``n8``
    out8 bytes, zero padding to a 4-byte boundary, then ``2k`` int32."""
    off = (n8 + 3) // 4 * 4
    return off + 8 * k, off


def fdet_views(rows, n8: int, k: int):
    """``(out8 int8 [R, n8], out32 int32 [R, 2k])``: views of K1h's
    output rows (a torch tensor or its numpy copy)."""
    _nbytes, off = fdet_row_bytes(n8, k)
    if isinstance(rows, np.ndarray):
        return rows[:, :n8], rows[:, off:off + 8 * k].view(np.int32)
    if k == 0:
        # torch views no dtype change across a stride that is not a
        # multiple of the new size, as rows of 0 to 3 bytes have
        return rows[:, :n8], rows.new_empty((rows.shape[0], 0),
                                            dtype=torch.int32)
    return rows[:, :n8], rows[:, off:off + 8 * k].view(torch.int32)


def _lane_check(lane: Optional[Lane], rows: int, width: int, what: str
                ) -> None:
    if lane is None:
        return
    buf, col = lane
    _check(buf.dim() == 2 and buf.dtype in _BYTE_DTYPES and
           buf.shape[0] == rows and
           (buf.numel() <= 1 or buf.shape[1] <= 1 or buf.stride(1) == 1),
           lambda: f'{what} must lie in a [{rows}, W] byte buffer with unit '
           f'column stride, got {buf.dtype} {tuple(buf.shape)}')
    _check(0 <= col and col + width <= buf.shape[1],
           lambda: f'{what} columns [{col}, {col + width}) outside the '
           f'buffer\'s {buf.shape[1]}')


def _fdet_check(s_u, d_u, adm, fdet_u, match, rowvalid, src, k) -> None:
    _check(s_u.dim() == 2 and s_u.dtype == torch.int8,
           lambda: f's_u must be int8 [R, U], got {s_u.dtype} '
           f'{tuple(s_u.shape)}')
    r, u = s_u.shape
    _check(d_u.dtype == torch.int8 and d_u.shape == s_u.shape,
           'd_u must be int8 of the shape of s_u')
    _check(adm.dtype == torch.int8 and adm.dim() == 2 and
           adm.shape[0] == r, lambda: f'adm must be int8 [{r}, A]')
    _check(fdet_u.dtype == torch.int32 and fdet_u.dim() == 2 and
           fdet_u.shape[0] == r, lambda: f'fdet_u must be int32 [{r}, C]')
    c = fdet_u.shape[1]
    _check(src.dtype == torch.int32 and tuple(src.shape) == (c,),
           lambda: f'src must be int32 [{c}]')
    _check(0 <= k <= c, lambda: f'k={k} outside [0, {c}]')
    _lane_check(match, r, u, 'match')
    _lane_check(rowvalid, r, 1, 'rowvalid')


def fdet_select(s_u: torch.Tensor, d_u: torch.Tensor, adm: torch.Tensor,
                fdet_u: torch.Tensor, match: Lane, rowvalid: Optional[Lane],
                src: torch.Tensor, k: int) -> torch.Tensor:
    """The tail of ``evaluate_packed`` over K1v's outputs: int8 ``[R,
    RB]`` rows (``fdet_row_bytes``; ``fdet_views`` splits them), each
    the out8 row ``[s_u | d_u | adm]`` and the out32 row: the first
    ``k`` relevant columns (ascending; ``C`` past the row's count) and
    ``fdet_u`` at those columns (``fdet_u[:, C - 1]`` past the count).
    Column ``c`` of the ``C`` fail-detail columns is relevant when its
    unique tree ``u = src[c]`` FAILed, ``match`` (the ``__match__``
    lane, ``[R, U]``) holds for ``u`` and the row's ``rowvalid`` lane is
    non-zero (no ``rowvalid``: every row); ``src`` maps each
    ``uniq_any`` child column to its tree.  The two lanes are read in
    their packed buffers, with their row strides."""
    _fdet_check(s_u, d_u, adm, fdet_u, match, rowvalid, src, k)
    lanes = (match[0],) if rowvalid is None else (match[0], rowvalid[0])
    if _on_cpu(s_u, d_u, adm, fdet_u, src, *lanes):
        return fdet_select_plain(s_u, d_u, adm, fdet_u, match, rowvalid,
                                 src, k)
    _check(all(t.is_contiguous() for t in (s_u, d_u, adm, fdet_u, src)),
           'fdet_select takes contiguous K1v outputs')
    r, u = s_u.shape
    n8 = 2 * u + adm.shape[1]
    nbytes, off = fdet_row_bytes(n8, k)
    out = torch.empty((r, nbytes), dtype=torch.int8, device=s_u.device)
    if r == 0 or nbytes == 0:
        return out
    from . import _build
    lib = _build.load('k1h_fdet_select')
    mbuf, mcol = match
    rv = (None, 0) if rowvalid is None else \
        (rowvalid[0].data_ptr() + rowvalid[1], rowvalid[0].stride(0))
    with torch.cuda.device(s_u.device):
        rc = lib.k1h_fdet_select(
            s_u.data_ptr(), d_u.data_ptr(), adm.data_ptr(),
            fdet_u.data_ptr(), mbuf.data_ptr() + mcol, mbuf.stride(0),
            rv[0], rv[1], src.data_ptr(), out.data_ptr(), r, u,
            adm.shape[1], fdet_u.shape[1], k, nbytes, off, STATUS_FAIL,
            _stream(s_u))
    if rc != 0:
        raise RuntimeError(f'k1h_fdet_select launch failed: CUDA error {rc}')
    LAUNCHES['k1h_fdet_select'] += 1
    return out


def _fdet_rel(s_u, match, rowvalid, src):
    # the evaluator's relevance glue: (FAIL & matched & row valid) per
    # unique tree, then one column per fail-detail column
    buf, col = match
    rel = (s_u == STATUS_FAIL) & (buf[:, col:col + s_u.shape[1]] != 0)
    if rowvalid is not None:
        rel = rel & (rowvalid[0][:, rowvalid[1]] != 0)[:, None]
    return rel[:, src.long()]


def _fdet_rows(s_u, d_u, adm, out32) -> torch.Tensor:
    # out8 and out32 laid out as the kernel writes them
    out8 = torch.cat([s_u, d_u, adm], dim=1)
    nbytes, off = fdet_row_bytes(out8.shape[1], out32.shape[1] // 2)
    rows = torch.zeros((s_u.shape[0], nbytes), dtype=torch.int8,
                       device=s_u.device)
    rows[:, :out8.shape[1]] = out8
    rows[:, off:] = out32.contiguous().view(torch.int8)
    return rows


def fdet_select_plain(s_u: torch.Tensor, d_u: torch.Tensor,
                      adm: torch.Tensor, fdet_u: torch.Tensor, match: Lane,
                      rowvalid: Optional[Lane], src: torch.Tensor, k: int
                      ) -> torch.Tensor:
    """Plain torch version: the evaluator's relevance glue, then a
    stream compaction — a running count of relevant columns gives each
    relevant cell its output slot (slots >= k go to a spill column that
    is dropped) — and the out8 concatenation."""
    rel = _fdet_rel(s_u, match, rowvalid, src)
    r, c = rel.shape
    if k == 0:
        out32 = torch.zeros((r, 0), dtype=torch.int32, device=rel.device)
        return _fdet_rows(s_u, d_u, adm, out32)
    slot = torch.cumsum(rel.to(torch.int32), dim=1) - 1
    slot = torch.where(rel & (slot < k), slot, k)
    cols = torch.arange(c, dtype=torch.int32, device=rel.device)
    order = torch.full((r, k + 1), c, dtype=torch.int32, device=rel.device)
    order.scatter_(1, slot.long(), cols.expand(r, c))
    order = order[:, :k]
    fds = torch.gather(fdet_u, 1, torch.clamp(order, max=c - 1).long())
    return _fdet_rows(s_u, d_u, adm, torch.cat([order, fds], dim=1))


def fdet_select_library(s_u: torch.Tensor, d_u: torch.Tensor,
                        adm: torch.Tensor, fdet_u: torch.Tensor, match: Lane,
                        rowvalid: Optional[Lane], src: torch.Tensor, k: int
                        ) -> torch.Tensor:
    """The same function as the JAX evaluator formulates it, in torch:
    the relevance glue, PyTorch's sort and gather, and the
    concatenations.  A speed yardstick only: the port never calls it."""
    rel = _fdet_rel(s_u, match, rowvalid, src)
    c = rel.shape[1]
    cols = torch.arange(c, dtype=torch.int32, device=rel.device)
    keys = torch.where(rel, cols, c)
    order = torch.sort(keys, dim=1).values[:, :k]
    fds = torch.gather(fdet_u, 1, torch.clamp(order, max=c - 1).long())
    return _fdet_rows(s_u, d_u, adm, torch.cat([order, fds], dim=1))


# ---------------------------------------------------------------------------
# K1c: glob match against the byte window

#: the compiled pattern's flags byte: the pattern holds a '?'
#: (``csrc/glob_dp.cuh`` GLOB_HAS_Q), and its star token (GLOB_STAR)
GLOB_HAS_Q = 1
GLOB_STAR = 0
#: longest run token: a run's length is one byte
_GLOB_RUN_MAX = 255


def glob_program(pattern: bytes) -> bytes:
    """``pattern`` compiled for the glob DP of ``csrc/glob_dp.cuh``
    (K1c's kernel and K1v's ``GLOB``): a flags byte (``GLOB_HAS_Q``),
    then one token per run of ``'*'`` (``GLOB_STAR``: ``'**'`` matches as
    ``'*'``) and, for each run of other bytes, its length (1-255; a
    longer run is split) and the bytes, ``'?'`` among them matching any
    byte.  The DP then takes a run in one step and knows ``has_q``
    without reading the pattern per value."""
    out = bytearray([GLOB_HAS_Q if b'?' in pattern else 0])
    i, n = 0, len(pattern)
    star = ord('*')
    while i < n:
        if pattern[i] == star:
            while i < n and pattern[i] == star:
                i += 1
            out.append(GLOB_STAR)
            continue
        j = i
        while j < n and pattern[j] != star and j - i < _GLOB_RUN_MAX:
            j += 1
        out.append(j - i)
        out += pattern[i:j]
        i = j
    return bytes(out)


def wildcard_match(head: torch.Tensor, str_len: torch.Tensor,
                   tag: torch.Tensor, pattern: bytes
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kleene ``(t, f)`` of ``wildcard.match(pattern, value)`` per value:
    ``head`` uint8 ``[..., w]`` (the value's first w bytes), ``str_len``
    int32 ``[...]``, ``tag`` int8 ``[...]``."""
    _check(head.dim() >= 1 and head.dtype == torch.uint8,
           f'head must be uint8 [..., w], got {head.dtype}')
    lead = tuple(head.shape[:-1])
    _check(str_len.dtype == torch.int32 and tuple(str_len.shape) == lead,
           'str_len must be int32 of head.shape[:-1]')
    _check(tag.dtype == torch.int8 and tuple(tag.shape) == lead,
           'tag must be int8 of head.shape[:-1]')
    if _on_cpu(head, str_len, tag):
        return wildcard_plain(head, str_len, tag, pattern)
    w = head.shape[-1]
    _check(w <= WILDCARD_MAX_WIDTH, f'window {w} > {WILDCARD_MAX_WIDTH}')
    _check(len(pattern) <= WILDCARD_MAX_PATTERN,
           f'pattern of {len(pattern)} bytes > {WILDCARD_MAX_PATTERN}')
    _check(head.is_contiguous() and str_len.is_contiguous() and
           tag.is_contiguous(), 'wildcard_match takes contiguous tensors')
    t = torch.empty(lead, dtype=torch.bool, device=head.device)
    f = torch.empty(lead, dtype=torch.bool, device=head.device)
    n = str_len.numel()
    if n == 0:
        return t, f
    from . import _build
    lib = _build.load('k1c_wildcard')
    conv_bits = 0
    for tg in _CONV_TAGS:
        conv_bits |= 1 << tg
    prog = glob_program(pattern)
    with torch.cuda.device(head.device):
        rc = lib.k1c_wildcard(head.data_ptr(), str_len.data_ptr(),
                              tag.data_ptr(), t.data_ptr(), f.data_ptr(),
                              n, w, prog, len(prog), conv_bits,
                              TAG_ARRAY, _stream(head))
    if rc != 0:
        raise RuntimeError(f'k1c_wildcard launch failed: CUDA error {rc}')
    LAUNCHES['k1c_wildcard'] += 1
    return t, f


def wildcard_plain(head: torch.Tensor, str_len: torch.Tensor,
                   tag: torch.Tensor, pattern: bytes
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: the boolean DP over the w + 1 window
    positions, one step per pattern byte (kyverno_tpu/ops/eval.py
    ``_View.wildcard_const``)."""
    dev = head.device
    w = head.shape[-1]
    vlen = torch.clamp(str_len, max=w)
    # dp[j]: pattern consumed so far matches value[:j]
    shape = tuple(head.shape[:-1])
    dp = torch.zeros(shape + (w + 1,), dtype=torch.bool, device=dev)
    dp[..., 0] = True
    pos_valid = torch.arange(w, device=dev) < vlen[..., None]
    zero = torch.zeros(shape + (1,), dtype=torch.bool, device=dev)
    for ch in pattern:
        if ch == ord('*'):
            dp = torch.cumsum(dp.to(torch.int32), dim=-1) > 0
        elif ch == ord('?'):
            dp = torch.cat([zero, dp[..., :-1] & pos_valid], dim=-1)
        else:
            dp = torch.cat([zero, dp[..., :-1] & (head == ch) & pos_valid],
                           dim=-1)
    matched = torch.gather(dp, -1, vlen[..., None].long())[..., 0]
    in_window = str_len <= w
    if b'?' in pattern:
        ascii_ok = torch.all((head < 0x80) | ~pos_valid, dim=-1)
    else:
        ascii_ok = torch.ones(shape, dtype=torch.bool, device=dev)
    conv = tag == _CONV_TAGS[0]
    for tg in _CONV_TAGS[1:]:
        conv = conv | (tag == tg)
    arrayish = tag == TAG_ARRAY
    decid = in_window & ascii_ok
    t = conv & decid & matched
    f = (~arrayish) & (~conv | (decid & ~matched))
    return t, f


# ---------------------------------------------------------------------------
# K3: the device mutate decision

#: sites per rule: one bit each of the rule's 32-bit edit mask
#: (mutate/plan.py MAX_SITES)
K3_MAX_SITES = 32
#: rules per launch: a block keeps two 32-bit words per (row, rule) in
#: shared memory, at most 227 KB of it
K3_MAX_RULES = 227 * 1024 // 8

_NUM_TAGS = (TAG_BOOL, TAG_INT, TAG_FLOAT)
_NUM_TAG_BITS = sum(1 << tg for tg in _NUM_TAGS)

#: the lanes of ``mutate/encode.py`` in the order K3's staged buffer
#: holds them, with their dtypes; ``sbytes`` is ``[R, S, w]``, ``valid``
#: ``[R]``, the others ``[R, S]``
_K3_LANES = (('milli', np.int64), ('sbytes', np.uint8), ('slen', np.int32),
             ('tag', np.int8), ('istate', np.int8), ('milli_ok', np.bool_),
             ('valid', np.bool_))
_K3_TORCH = {np.int64: torch.int64, np.uint8: torch.uint8,
             np.int32: torch.int32, np.int8: torch.int8,
             np.bool_: torch.bool}
#: the site tables (``mutate/kernel.py MutateKernel.site_tensors``):
#: ``site_slot`` is ``32 * rule + bit`` of each site
_K3_SITES = (('t_is_num', torch.bool), ('t_milli', torch.int64),
             ('t_len', torch.int32), ('add_only', torch.bool),
             ('replace', torch.bool), ('site_slot', torch.int32))


class K3Layout(NamedTuple):
    """Where each lane of a K3 call lies in its staged byte buffer."""
    rows: int
    sites: int
    width: int
    offsets: Tuple[int, ...]   # byte offset of each lane of _K3_LANES
    nbytes: int


def _k3_shape(name: str, r: int, s: int, w: int) -> Tuple[int, ...]:
    return (r, s, w) if name == 'sbytes' else (r,) if name == 'valid' \
        else (r, s)


@functools.lru_cache(maxsize=64)
def k3_layout(rows: int, sites: int, width: int) -> K3Layout:
    """The staged buffer of ``rows`` x ``sites`` lanes with a
    ``width``-byte window: each lane at an offset aligned to 8 bytes,
    the window to 16, so the kernel's wide loads stay aligned."""
    off, offsets = 0, []
    for name, dt in _K3_LANES:
        align = 16 if name == 'sbytes' else 8
        off = -(-off // align) * align
        offsets.append(off)
        off += int(np.prod(_k3_shape(name, rows, sites, width))) * \
            np.dtype(dt).itemsize
    return K3Layout(rows, sites, width, tuple(offsets), off)


def k3_pack(lanes: Dict[str, np.ndarray], pin: bool = False
            ) -> Tuple[torch.Tensor, K3Layout]:
    """The lanes of one K3 call (numpy, ``mutate/encode.py``) written
    into one uint8 host buffer (pinned with ``pin``, from the caching
    host allocator) at ``k3_layout``'s offsets."""
    tag, sb = lanes['tag'], lanes['sbytes']
    _check(tag.ndim == 2 and sb.ndim == 3,
           lambda: f'tag must be [R, S] and sbytes [R, S, w], got '
           f'{tag.shape} and {sb.shape}')
    r, s = tag.shape
    layout = k3_layout(r, s, sb.shape[2])
    host = torch.empty(layout.nbytes, dtype=torch.uint8, pin_memory=pin)
    flat = host.numpy()
    for (name, dt), off in zip(_K3_LANES, layout.offsets):
        a = lanes[name]
        shape = _k3_shape(name, r, s, layout.width)
        _check(a.dtype == dt and a.shape == shape,
               lambda: f'{name} must be {np.dtype(dt)} {shape}, got {a.dtype} '
               f'{a.shape}')
        flat[off:off + a.nbytes].view(dt).reshape(shape)[...] = a
    return host, layout


def k3_unpack(buf: torch.Tensor, layout: K3Layout
              ) -> Dict[str, torch.Tensor]:
    """The lanes of a staged K3 buffer, as views of it."""
    out = {}
    for (name, dt), off in zip(_K3_LANES, layout.offsets):
        shape = _k3_shape(name, layout.rows, layout.sites, layout.width)
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        out[name] = buf[off:off + n].view(_K3_TORCH[dt]).view(shape)
    return out


def k3_outputs(out, rows: int, n_rules: int):
    """``(status int8, edits int64, reason int8)``, each ``[rows,
    n_rules]``: views of K3's output buffer (a torch tensor or its numpy
    copy), which holds edits, then status, then reason."""
    n = rows * n_rules
    i64, i8 = (np.int64, np.int8) if isinstance(out, np.ndarray) else \
        (torch.int64, torch.int8)
    return (out[8 * n:9 * n].view(i8).reshape(rows, n_rules),
            out[:8 * n].view(i64).reshape(rows, n_rules),
            out[9 * n:10 * n].view(i8).reshape(rows, n_rules))


def k3_check_bounds(bounds: Sequence[int], n_sites: int) -> None:
    """``bounds`` (``rule_start`` on the host) must rise from 0 to
    ``n_sites`` by at most ``K3_MAX_SITES`` sites a rule."""
    _check(len(bounds) >= 1 and bounds[0] == 0 and bounds[-1] == n_sites
           and all(0 <= b - a <= K3_MAX_SITES
                   for a, b in zip(bounds, bounds[1:])),
           lambda: f'rule_start must rise from 0 to {n_sites} by at most '
           f'{K3_MAX_SITES} sites per rule')


def k3_site_slot(bounds: Sequence[int]) -> np.ndarray:
    """int32 ``[S]``: ``32 * rule + bit`` of each site (site k of a rule
    is bit k of its edit mask)."""
    b = np.asarray(bounds, np.int64)
    rule = np.repeat(np.arange(len(b) - 1), np.diff(b))
    return (32 * rule + np.arange(b[-1]) - b[rule]).astype(np.int32)


def _k3_check(lanes: Tuple[torch.Tensor, K3Layout],
              sites: Dict[str, torch.Tensor],
              bounds: Optional[Sequence[int]]) -> Sequence[int]:
    """The host bounds of a K3 call, after its dtype and shape checks."""
    buf, layout = lanes
    _check(buf.dtype == torch.uint8 and buf.dim() == 1 and
           buf.numel() >= layout.nbytes and buf.is_contiguous(),
           lambda: f'the staged lanes must be a contiguous uint8 buffer of '
           f'{layout.nbytes} bytes')
    _check(layout == k3_layout(layout.rows, layout.sites, layout.width),
           'the staged lanes\' layout is not k3_layout\'s')
    s, w = layout.sites, layout.width
    for name, dt in _K3_SITES:
        t = sites[name]
        _check(t.dtype == dt and tuple(t.shape) == (s,),
               lambda: f'{name} must be {dt} [{s}], got {t.dtype} '
               f'{tuple(t.shape)}')
    tb = sites['t_bytes']
    _check(tb.dtype == torch.uint8 and tuple(tb.shape) == (s, w),
           lambda: f't_bytes must be uint8 [{s}, {w}], got {tb.dtype} '
           f'{tuple(tb.shape)}')
    rs = sites['rule_start']
    _check(rs.dtype == torch.int32 and rs.dim() == 1 and rs.numel() >= 1,
           'rule_start must be int32 [NR + 1]')
    if bounds is None:
        # the card wrapper never reads rule_start back (a host sync)
        _check(rs.device.type == 'cpu',
               'k3_mutate on the card takes the host bounds of rule_start')
        bounds = rs.tolist()
    _check(len(bounds) == rs.numel(),
           lambda: f'{len(bounds)} bounds for a rule_start of {rs.numel()}')
    k3_check_bounds(bounds, s)
    return bounds


def k3_mutate(lanes: Tuple[torch.Tensor, K3Layout],
              sites: Dict[str, torch.Tensor],
              bounds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """K3's uint8 output buffer (``k3_outputs`` splits it into status
    int8, edits int64 and reason int8, each ``[R, NR]``) of the mutate
    lanes of ``mutate/encode.py``, staged in one buffer (``k3_pack``:
    ``tag``, ``istate``, ``milli``, ``milli_ok``, ``slen`` ``[R, S]``,
    ``sbytes`` ``[R, S, w]``, ``valid`` ``[R]``), against one program's
    site tables (``t_is_num``, ``t_milli``, ``t_len``, ``add_only``,
    ``replace``, ``site_slot`` ``[S]``, ``t_bytes`` ``[S, w]``, and
    ``rule_start`` ``[NR + 1]``: rule r owns sites
    ``rule_start[r]:rule_start[r + 1]``, at most 32 of them).  On the
    card ``bounds``, ``rule_start`` on the host, is required: the
    wrapper does not wait for the card."""
    buf, layout = lanes
    bounds = _k3_check(lanes, sites, bounds)
    r, s, w, nr = layout.rows, layout.sites, layout.width, len(bounds) - 1
    ts = [sites[name] for name, _dt in _K3_SITES] + [sites['t_bytes']]
    if _on_cpu(buf, sites['rule_start'], *ts):
        return k3_mutate_plain(lanes, sites, bounds)
    _check(w >= 8 and w % 8 == 0,
           lambda: f'window {w} is not a multiple of 8')
    _check(nr <= K3_MAX_RULES, lambda: f'{nr} rules > {K3_MAX_RULES}')
    _check(all(t.is_contiguous() for t in ts),
           'k3_mutate takes contiguous site tables')
    _check(buf.data_ptr() % 16 == 0 and sites['t_bytes'].data_ptr() % 16
           == 0, 'the staged lanes and t_bytes must be 16-byte aligned')
    if r == 0 or s == 0 or nr == 0:
        return torch.zeros(r * nr * 10, dtype=torch.uint8, device=buf.device)
    out = torch.empty(r * nr * 10, dtype=torch.uint8, device=buf.device)
    from . import _build
    lib = _build.load('k3_mutate')
    with torch.cuda.device(buf.device):
        rc = lib.k3_mutate(
            buf.data_ptr(), (ctypes.c_longlong * 7)(*layout.offsets),
            sites['t_is_num'].data_ptr(), sites['t_milli'].data_ptr(),
            sites['t_len'].data_ptr(), sites['t_bytes'].data_ptr(),
            sites['add_only'].data_ptr(), sites['replace'].data_ptr(),
            sites['site_slot'].data_ptr(), out.data_ptr(), r, s, nr, w,
            _NUM_TAG_BITS, TAG_MISSING, TAG_STRING, _stream(buf))
    if rc != 0:
        raise RuntimeError(f'k3_mutate launch failed: CUDA error {rc}')
    LAUNCHES['k3_mutate'] += 1
    return out


def k3_mutate_plain(lanes: Tuple[torch.Tensor, K3Layout],
                    sites: Dict[str, torch.Tensor],
                    bounds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Plain torch version (kyverno_tpu/mutate/kernel.py
    ``MutateKernel._eval``) over the same staged buffer, with the same
    output buffer.  The JAX code reduces sites to rules with int64
    matmuls against a site-to-rule one-hot; torch has no int64 matmul
    on CUDA, so the per-rule sums here are an ``index_add_`` over the
    site axis (the bit weights are distinct powers of two, so the sum of
    a rule's weighted edits is its bitmask)."""
    from ..mutate.kernel import (MUT_FALLBACK, MUT_PASS, MUT_SKIP,
                                 RC_NON_DICT, RC_NONE, RC_REPLACE_MISSING,
                                 RC_UNDECIDABLE)
    buf, layout = lanes
    bounds = _k3_check(lanes, sites, bounds)
    r, s, nr = layout.rows, layout.sites, len(bounds) - 1
    lanes = k3_unpack(buf, layout)
    tag, istate = lanes['tag'], lanes['istate']
    dev = tag.device
    if s == 0:
        return torch.zeros(r * nr * 10, dtype=torch.uint8, device=dev)
    is_num, add_only = sites['t_is_num'], sites['add_only']
    missing = tag == TAG_MISSING
    bad = istate == 2
    present = ~missing & ~bad
    num_tag = (tag == _NUM_TAGS[0]) | (tag == _NUM_TAGS[1]) | \
        (tag == _NUM_TAGS[2])
    eq_num = is_num & present & num_tag & lanes['milli_ok'] & \
        (lanes['milli'] == sites['t_milli'])
    undec = is_num & present & num_tag & ~lanes['milli_ok'] & ~add_only
    eq_str = ~is_num & present & (tag == TAG_STRING) & \
        (lanes['slen'] == sites['t_len']) & \
        torch.all(lanes['sbytes'] == sites['t_bytes'], dim=-1)
    edit = (missing & ~bad) | (~add_only & present & ~(eq_num | eq_str))
    rep_bad = sites['replace'] & ((istate != 0) | missing)

    rule_start = sites['rule_start'].long()
    site_rule = torch.repeat_interleave(
        torch.arange(nr, device=dev), rule_start[1:] - rule_start[:-1])
    bit = torch.arange(s, device=dev) - rule_start[site_rule]

    def per_rule(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((r, nr), dtype=torch.int64, device=dev)
        return out.index_add_(1, site_rule, x)

    edits = per_rule(torch.bitwise_left_shift(edit.long(), bit))
    rep_any = per_rule(rep_bad.long()) > 0
    bad_any = per_rule(bad.long()) > 0
    undec_any = per_rule(undec.long()) > 0
    status = torch.where(rep_any | bad_any | undec_any, MUT_FALLBACK,
                         torch.where(edits != 0, MUT_PASS, MUT_SKIP))
    reason = torch.where(
        rep_any, RC_REPLACE_MISSING,
        torch.where(bad_any, RC_NON_DICT,
                    torch.where(undec_any, RC_UNDECIDABLE, RC_NONE)))
    # capacity-padding rows are SKIP with no edits and no reason
    vcol = lanes['valid'][:, None]
    status = torch.where(vcol, status, MUT_SKIP).to(torch.int8)
    edits = torch.where(vcol, edits, 0)
    reason = torch.where(vcol, reason, RC_NONE).to(torch.int8)
    return torch.cat([edits.reshape(-1).view(torch.uint8),
                      status.reshape(-1).view(torch.uint8),
                      reason.reshape(-1).view(torch.uint8)])


# ---------------------------------------------------------------------------
# K4h: the per-rule verdict histogram of the sharded scan step

#: status codes the K4h kernel takes (its shared-memory histogram's, past
#: the register counters' 8)
K4_MAX_CODES = 12288

#: per (device index, stream): K4h's zeroed uint64 workspace (a ticket,
#: then the accumulator), which each launch leaves zero again; one per
#: stream, since launches on two streams may overlap
_K4_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}
_K4_LOCK = threading.Lock()


def _k4_check(statuses: torch.Tensor, rowvalid: Optional[torch.Tensor],
              n_codes: int) -> None:
    _check(statuses.dim() == 2 and statuses.dtype == torch.int8,
           lambda: f'statuses must be a 2-D int8 tensor, got '
           f'{statuses.dtype} {tuple(statuses.shape)}')
    _check(statuses.numel() == 0 or statuses.shape[1] == 1 or
           statuses.stride(1) == 1, 'statuses must have unit column stride')
    if rowvalid is not None:
        _check(rowvalid.dtype == torch.uint8 and
               tuple(rowvalid.shape) == (statuses.shape[0],),
               lambda: f'rowvalid must be uint8 [{statuses.shape[0]}], got '
               f'{rowvalid.dtype} {tuple(rowvalid.shape)}')
    _check(1 <= n_codes <= K4_MAX_CODES,
           lambda: f'n_codes={n_codes} outside [1, {K4_MAX_CODES}]')


def _k4_workspace(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    # at least n zero uint64 words for launches on ``stream``; grown
    # (a new zeroed tensor, on that stream) when a call needs more
    key = (dev.index, stream)
    with _K4_LOCK:
        ws = _K4_WORKSPACE.get(key)
        if ws is None or ws.numel() < n:
            size = n if ws is None else max(n, 2 * ws.numel())
            ws = _K4_WORKSPACE[key] = torch.zeros(size, dtype=torch.int64,
                                                  device=dev)
    return ws


def status_histogram(statuses: torch.Tensor,
                     rowvalid: Optional[torch.Tensor], n_codes: int
                     ) -> torch.Tensor:
    """``[P, n_codes]`` int64: per program column p and code c, the rows
    of ``statuses`` (int8 ``[R, P]``, unit column stride, any row
    stride) holding c whose ``rowvalid`` (uint8 ``[R]``, any stride: a
    lane inside its packed buffer; None for no mask) is non-zero.  A
    code outside ``[0, n_codes)`` counts nowhere.  Neither tensor is
    copied: the kernel reads each as a pointer and a row stride."""
    _k4_check(statuses, rowvalid, n_codes)
    ts = (statuses,) if rowvalid is None else (statuses, rowvalid)
    if _on_cpu(*ts):
        return status_histogram_plain(statuses, rowvalid, n_codes)
    r, p = statuses.shape
    dev = statuses.device
    if r == 0 or p == 0:
        return torch.zeros((p, n_codes), dtype=torch.int64, device=dev)
    out = torch.empty((p, n_codes), dtype=torch.int64, device=dev)
    stream = _stream(statuses)
    ws = _k4_workspace(dev, stream, 1 + p * n_codes)
    from . import _build
    lib = _build.load('k4_status_hist')
    with torch.cuda.device(dev):
        rc = lib.k4_status_hist(
            statuses.data_ptr(), statuses.stride(0),
            rowvalid.data_ptr() if rowvalid is not None else None,
            rowvalid.stride(0) if rowvalid is not None else 0,
            out.data_ptr(), ws.data_ptr(), r, p, n_codes, stream)
    if rc != 0:
        raise RuntimeError(f'k4_status_hist launch failed: CUDA error {rc}')
    LAUNCHES['k4_status_hist'] += 1
    return out


def status_histogram_plain(statuses: torch.Tensor,
                           rowvalid: Optional[torch.Tensor], n_codes: int
                           ) -> torch.Tensor:
    """Plain torch version (kyverno_tpu/parallel/mesh.py
    ``build_sharded_evaluator.step``): a one-hot over the codes, masked
    by the row validity, summed over the rows.  The one-hot compares
    against ``arange(n_codes)``, so, as ``jax.nn.one_hot``, a code
    outside the range gives an all-zero row."""
    codes = torch.arange(n_codes, dtype=torch.int64, device=statuses.device)
    one_hot = (statuses.to(torch.int64)[..., None] == codes).to(torch.int64)
    if rowvalid is not None:
        one_hot = one_hot * (rowvalid != 0).to(torch.int64)[:, None, None]
    return one_hot.sum(dim=0)


def status_histogram_library(statuses: torch.Tensor,
                             rowvalid: Optional[torch.Tensor], n_codes: int
                             ) -> torch.Tensor:
    """The same function as one ``torch.bincount`` over ``p * n_codes +
    code``, weighted by the row mask with out-of-range codes masked out.
    A speed yardstick only: the port never calls it."""
    p = statuses.shape[1]
    codes = statuses.to(torch.int64)
    keep = (codes >= 0) & (codes < n_codes)
    if rowvalid is not None:
        keep = keep & (rowvalid != 0)[:, None]
    cols = torch.arange(p, dtype=torch.int64, device=statuses.device)
    idx = cols * n_codes + torch.clamp(codes, 0, n_codes - 1)
    counts = torch.bincount(idx.flatten(),
                            weights=keep.flatten().to(torch.float64),
                            minlength=p * n_codes)
    return counts.to(torch.int64).reshape(p, n_codes)
