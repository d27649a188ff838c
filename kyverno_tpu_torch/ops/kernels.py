"""Wrappers of the hand-written CUDA kernels, and their plain versions.

The evaluator (``ops/eval.py``), the device mutate decision
(``mutate/kernel.py``) and the sharded step's histogram
(``parallel/mesh.py``) run as kernels written for Hopper (``csrc/*.cu``,
built by ``ops/_build.py``):

* K1v ``status_vm`` — every unique status tree of a policy set over a
  packed batch, and the per-row admission match (K1i) of its eligible
  programs, as one launch of a bytecode interpreter (the bytecode from
  ``ops/vm.py``); its plain version is the evaluator's eager walk and
  ``_adm_match_graph``;
* K1h ``fdet_select`` — the compact fail-detail select of
  ``evaluate_packed``: the first k relevant columns of each row and
  their fail details;
* K1c ``wildcard_match`` — the glob DP of ``_View.wildcard_const`` and
  its Kleene verdict (the eager walk's; inside K1v the same DP runs
  from ``csrc/glob_dp.cuh``);
* K3 ``k3_mutate`` — per (resource, rule) of a lowered mutate set: the
  edit bitmask, the status and the first-fault reason;
* K4h ``status_histogram`` — the per-rule verdict histogram of the
  sharded scan step (``parallel/mesh.py``), before its all-reduce.

Each wrapper checks device, dtype, shape and contiguity, launches on
the current CUDA stream, raises if the launch fails, and counts its
launches in ``LAUNCHES``.  A tensor on the CPU takes the plain torch
version beside it; a CUDA tensor takes the kernel or raises — there is
no fallback.  The plain versions are what the CPU tests hold against
the JAX package, and what the card's kernels are held against.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..compiler.ir import (TAG_ARRAY, TAG_BOOL, TAG_FLOAT, TAG_INT,
                           TAG_MISSING, TAG_STRING)

#: launches per kernel since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {'k1_vm': 0, 'k1h_fdet_select': 0,
                             'k1c_wildcard': 0, 'k3_mutate': 0,
                             'k4_status_hist': 0}

#: widest byte window and longest pattern the K1c kernel takes
#: (``STR_LEN`` = 64 bounds every ``str_head`` lane)
WILDCARD_MAX_WIDTH = 64
WILDCARD_MAX_PATTERN = 256

_CONV_TAGS = (TAG_STRING, TAG_INT, TAG_FLOAT, TAG_BOOL)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


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
    n_trees = program.trees.shape[0]
    if rows == 0 or n_trees == 0:
        return s_u, d_u, fd_u, adm
    import ctypes
    from . import _build
    lib = _build.load('k1_vm')
    tab = program.device_tables(dev)
    with torch.cuda.device(dev):
        rc = lib.k1_vm((ctypes.c_void_p * 5)(*ptrs),
                       (ctypes.c_longlong * 5)(*widths), rows,
                       tab['code'].data_ptr(), tab['lanes'].data_ptr(),
                       tab['i64'].data_ptr(), tab['f64'].data_ptr(),
                       tab['bytes'].data_ptr(), tab['trees'].data_ptr(),
                       n_trees, s_u.data_ptr(), d_u.data_ptr(),
                       fd_u.data_ptr(),
                       adm.data_ptr() if program.n_adm else None,
                       program.n_uniq, program.n_cols_u, program.n_adm,
                       _stream(ts[0]))
    if rc != 0:
        raise RuntimeError(f'k1_vm launch failed: CUDA error {rc}')
    LAUNCHES['k1_vm'] += 1
    return s_u, d_u, fd_u, adm


# ---------------------------------------------------------------------------
# K1h: compact fail-detail select

def fdet_select(rel: torch.Tensor, fdet_u: torch.Tensor, k: int
                ) -> torch.Tensor:
    """``[R, 2k]`` int32: per row, the first ``k`` columns where ``rel``
    holds (ascending; ``C`` past the row's count) and then ``fdet_u`` at
    those columns (``fdet_u[:, C - 1]`` past the count)."""
    _check(rel.dim() == 2 and rel.dtype == torch.bool,
           f'rel must be a 2-D bool tensor, got {rel.dtype} {tuple(rel.shape)}')
    _check(fdet_u.dtype == torch.int32 and fdet_u.shape == rel.shape,
           'fdet_u must be int32 of the shape of rel')
    r, c = rel.shape
    _check(0 <= k <= c, f'k={k} outside [0, {c}]')
    if _on_cpu(rel, fdet_u):
        return fdet_select_plain(rel, fdet_u, k)
    _check(rel.is_contiguous() and fdet_u.is_contiguous(),
           'fdet_select takes contiguous tensors')
    out = torch.empty((r, 2 * k), dtype=torch.int32, device=rel.device)
    if r == 0 or k == 0:
        return out
    from . import _build
    lib = _build.load('k1h_fdet_select')
    with torch.cuda.device(rel.device):
        rc = lib.k1h_fdet_select(rel.data_ptr(), fdet_u.data_ptr(),
                                 out.data_ptr(), r, c, k, _stream(rel))
    if rc != 0:
        raise RuntimeError(f'k1h_fdet_select launch failed: CUDA error {rc}')
    LAUNCHES['k1h_fdet_select'] += 1
    return out


def fdet_select_plain(rel: torch.Tensor, fdet_u: torch.Tensor, k: int
                      ) -> torch.Tensor:
    """Plain torch version of the kernel's stream compaction: a running
    count of relevant columns gives each relevant cell its output slot
    (slots >= k go to a spill column that is dropped)."""
    r, c = rel.shape
    if k == 0:
        return torch.zeros((r, 0), dtype=torch.int32, device=rel.device)
    slot = torch.cumsum(rel.to(torch.int32), dim=1) - 1
    slot = torch.where(rel & (slot < k), slot, k)
    cols = torch.arange(c, dtype=torch.int32, device=rel.device)
    order = torch.full((r, k + 1), c, dtype=torch.int32, device=rel.device)
    order.scatter_(1, slot, cols.expand(r, c))
    order = order[:, :k]
    fds = torch.gather(fdet_u, 1, torch.clamp(order, max=c - 1).long())
    return torch.cat([order, fds], dim=1)


def fdet_select_library(rel: torch.Tensor, fdet_u: torch.Tensor, k: int
                        ) -> torch.Tensor:
    """The same function through PyTorch's sort and gather, as the JAX
    evaluator formulates it.  A speed yardstick only: the port never
    calls it."""
    r, c = rel.shape
    cols = torch.arange(c, dtype=torch.int32, device=rel.device)
    keys = torch.where(rel, cols, c)
    order = torch.sort(keys, dim=1).values[:, :k]
    fds = torch.gather(fdet_u, 1, torch.clamp(order, max=c - 1).long())
    return torch.cat([order, fds], dim=1)


# ---------------------------------------------------------------------------
# K1c: glob match against the byte window

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
    with torch.cuda.device(head.device):
        rc = lib.k1c_wildcard(head.data_ptr(), str_len.data_ptr(),
                              tag.data_ptr(), t.data_ptr(), f.data_ptr(),
                              n, w, pattern, len(pattern), conv_bits,
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

#: sites per rule: one warp lane each (mutate/plan.py MAX_SITES)
K3_MAX_SITES = 32

_NUM_TAGS = (TAG_BOOL, TAG_INT, TAG_FLOAT)
_NUM_TAG_BITS = sum(1 << tg for tg in _NUM_TAGS)

_K3_LANES = (('tag', torch.int8), ('istate', torch.int8),
             ('milli', torch.int64), ('milli_ok', torch.bool),
             ('slen', torch.int32))
_K3_SITES = (('t_is_num', torch.bool), ('t_milli', torch.int64),
             ('t_len', torch.int32), ('add_only', torch.bool),
             ('replace', torch.bool))


def _k3_check(lanes: Dict[str, torch.Tensor],
              sites: Dict[str, torch.Tensor]) -> Tuple[int, int, int, int]:
    """(R, S, NR, w) of a K3 call, after its dtype and shape checks."""
    tag = lanes['tag']
    _check(tag.dim() == 2, f'tag must be [R, S], got {tuple(tag.shape)}')
    r, s = tag.shape
    for name, dt in _K3_LANES:
        t = lanes[name]
        _check(t.dtype == dt and tuple(t.shape) == (r, s),
               f'{name} must be {dt} [{r}, {s}], got {t.dtype} '
               f'{tuple(t.shape)}')
    sb = lanes['sbytes']
    _check(sb.dtype == torch.uint8 and sb.dim() == 3 and
           tuple(sb.shape[:2]) == (r, s),
           f'sbytes must be uint8 [{r}, {s}, w], got {sb.dtype} '
           f'{tuple(sb.shape)}')
    w = sb.shape[2]
    valid = lanes['valid']
    _check(valid.dtype == torch.bool and tuple(valid.shape) == (r,),
           f'valid must be bool [{r}]')
    for name, dt in _K3_SITES:
        t = sites[name]
        _check(t.dtype == dt and tuple(t.shape) == (s,),
               f'{name} must be {dt} [{s}], got {t.dtype} {tuple(t.shape)}')
    tb = sites['t_bytes']
    _check(tb.dtype == torch.uint8 and tuple(tb.shape) == (s, w),
           f't_bytes must be uint8 [{s}, {w}], got {tb.dtype} '
           f'{tuple(tb.shape)}')
    rs = sites['rule_start']
    _check(rs.dtype == torch.int32 and rs.dim() == 1 and rs.numel() >= 1,
           'rule_start must be int32 [NR + 1]')
    bounds = rs.tolist()
    _check(bounds[0] == 0 and bounds[-1] == s and
           all(0 <= b - a <= K3_MAX_SITES
               for a, b in zip(bounds, bounds[1:])),
           f'rule_start must rise from 0 to {s} by at most {K3_MAX_SITES} '
           f'sites per rule')
    return r, s, rs.numel() - 1, w


def _k3_zeros(r: int, nr: int, dev) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    return (torch.zeros((r, nr), dtype=torch.int8, device=dev),
            torch.zeros((r, nr), dtype=torch.int64, device=dev),
            torch.zeros((r, nr), dtype=torch.int8, device=dev))


def k3_mutate(lanes: Dict[str, torch.Tensor], sites: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(status i8, edits i64, reason i8)``, each ``[R, NR]``, of the
    mutate lanes of ``mutate/encode.py`` (``tag``, ``istate``, ``milli``,
    ``milli_ok``, ``slen`` ``[R, S]``, ``sbytes`` ``[R, S, w]``,
    ``valid`` ``[R]``) against one program's site tables (``t_is_num``,
    ``t_milli``, ``t_len``, ``add_only``, ``replace`` ``[S]``, ``t_bytes``
    ``[S, w]``, and ``rule_start`` ``[NR + 1]``: rule r owns sites
    ``rule_start[r]:rule_start[r + 1]``, at most 32 of them)."""
    r, s, nr, w = _k3_check(lanes, sites)
    ts = [lanes[k] for k in ('tag', 'istate', 'milli', 'milli_ok', 'slen',
                             'sbytes', 'valid')] + \
        [sites[k] for k in ('t_is_num', 't_milli', 't_len', 't_bytes',
                            'add_only', 'replace', 'rule_start')]
    if _on_cpu(*ts):
        return k3_mutate_plain(lanes, sites)
    _check(all(t.is_contiguous() for t in ts),
           'k3_mutate takes contiguous tensors')
    _check(w >= 8 and w % 8 == 0, f'window {w} is not a multiple of 8')
    _check(lanes['sbytes'].data_ptr() % 8 == 0 and
           sites['t_bytes'].data_ptr() % 8 == 0,
           'sbytes and t_bytes must be 8-byte aligned')
    dev = lanes['tag'].device
    if r == 0 or s == 0 or nr == 0:
        return _k3_zeros(r, nr, dev)
    status = torch.empty((r, nr), dtype=torch.int8, device=dev)
    edits = torch.empty((r, nr), dtype=torch.int64, device=dev)
    reason = torch.empty((r, nr), dtype=torch.int8, device=dev)
    from . import _build
    lib = _build.load('k3_mutate')
    with torch.cuda.device(dev):
        rc = lib.k3_mutate(*[t.data_ptr() for t in ts], status.data_ptr(),
                           edits.data_ptr(), reason.data_ptr(), r, s, nr, w,
                           _NUM_TAG_BITS, TAG_MISSING, TAG_STRING,
                           _stream(ts[0]))
    if rc != 0:
        raise RuntimeError(f'k3_mutate launch failed: CUDA error {rc}')
    LAUNCHES['k3_mutate'] += 1
    return status, edits, reason


def k3_mutate_plain(lanes: Dict[str, torch.Tensor],
                    sites: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version (kyverno_tpu/mutate/kernel.py
    ``MutateKernel._eval``).  The JAX code reduces sites to rules with
    int64 matmuls against a site-to-rule one-hot; torch has no int64
    matmul on CUDA, so the per-rule sums here are an ``index_add_`` over
    the site axis (the bit weights are distinct powers of two, so the
    sum of a rule's weighted edits is its bitmask)."""
    from ..mutate.kernel import (MUT_FALLBACK, MUT_PASS, MUT_SKIP,
                                 RC_NON_DICT, RC_NONE, RC_REPLACE_MISSING,
                                 RC_UNDECIDABLE)
    r, s, nr, _w = _k3_check(lanes, sites)
    tag, istate = lanes['tag'], lanes['istate']
    dev = tag.device
    if s == 0:
        return _k3_zeros(r, nr, dev)
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
    return (torch.where(vcol, status, MUT_SKIP).to(torch.int8),
            torch.where(vcol, edits, 0),
            torch.where(vcol, reason, RC_NONE).to(torch.int8))


# ---------------------------------------------------------------------------
# K4h: the per-rule verdict histogram of the sharded scan step

#: status codes the K4h kernel's shared-memory histogram can hold
K4_MAX_CODES = 12288


def _k4_check(statuses: torch.Tensor, rowvalid: Optional[torch.Tensor],
              n_codes: int) -> None:
    _check(statuses.dim() == 2 and statuses.dtype == torch.int8,
           f'statuses must be a 2-D int8 tensor, got {statuses.dtype} '
           f'{tuple(statuses.shape)}')
    if rowvalid is not None:
        _check(rowvalid.dtype == torch.uint8 and
               tuple(rowvalid.shape) == (statuses.shape[0],),
               f'rowvalid must be uint8 [{statuses.shape[0]}], got '
               f'{rowvalid.dtype} {tuple(rowvalid.shape)}')
    _check(1 <= n_codes <= K4_MAX_CODES,
           f'n_codes={n_codes} outside [1, {K4_MAX_CODES}]')


def status_histogram(statuses: torch.Tensor,
                     rowvalid: Optional[torch.Tensor], n_codes: int
                     ) -> torch.Tensor:
    """``[P, n_codes]`` int64: per program column p and code c, the rows
    of ``statuses`` (int8 ``[R, P]``) holding c whose ``rowvalid``
    (uint8 ``[R]``; None for no mask) is non-zero.  A code outside
    ``[0, n_codes)`` counts nowhere."""
    _k4_check(statuses, rowvalid, n_codes)
    ts = (statuses,) if rowvalid is None else (statuses, rowvalid)
    if _on_cpu(*ts):
        return status_histogram_plain(statuses, rowvalid, n_codes)
    _check(all(t.is_contiguous() for t in ts),
           'status_histogram takes contiguous tensors')
    r, p = statuses.shape
    out = torch.zeros((p, n_codes), dtype=torch.int64,
                      device=statuses.device)
    if r == 0 or p == 0:
        return out
    from . import _build
    lib = _build.load('k4_status_hist')
    with torch.cuda.device(statuses.device):
        rc = lib.k4_status_hist(
            statuses.data_ptr(),
            rowvalid.data_ptr() if rowvalid is not None else None,
            out.data_ptr(), r, p, n_codes, _stream(statuses))
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
