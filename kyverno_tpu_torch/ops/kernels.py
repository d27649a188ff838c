"""Wrappers of the hand-written CUDA kernels, and their plain versions.

Two parts of the evaluator (``ops/eval.py``) run as kernels written for
Hopper (``csrc/*.cu``, built by ``ops/_build.py``):

* K1h ``fdet_select`` — the compact fail-detail select of
  ``evaluate_packed``: the first k relevant columns of each row and
  their fail details;
* K1c ``wildcard_match`` — the glob DP of ``_View.wildcard_const`` and
  its Kleene verdict.

Each wrapper checks device, dtype, shape and contiguity, launches on
the current CUDA stream, raises if the launch fails, and counts its
launches in ``LAUNCHES``.  A tensor on the CPU takes the plain torch
version beside it; a CUDA tensor takes the kernel or raises — there is
no fallback.  The plain versions are what the CPU tests hold against
the JAX package, and what the card's kernels are held against.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..compiler.ir import (TAG_ARRAY, TAG_BOOL, TAG_FLOAT, TAG_INT,
                           TAG_STRING)

#: launches per kernel since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {'k1h_fdet_select': 0, 'k1c_wildcard': 0}

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
