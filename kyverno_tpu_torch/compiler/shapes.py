"""Canonical batch-shape table: the few row capacities XLA ever sees.

XLA compiles one executable per distinct input shape, and every
compiled shape is a warm-up liability: a fresh process pays one
deserialize-or-compile per shape before it serves (BENCH r03-r05
measured the power-of-two bucket ladder at 49-93s of warm against ~28s
of actual scan).  This module replaces that ladder with a *canonical
capacity table* — by default just ``{KTPU_SMALL_BATCH, KTPU_SCAN_CHUNK}``
— so a policy set compiles at most two row shapes, ever:

* batches at or below the small capacity pad to it (the admission
  shape; runs on the host-local CPU backend);
* everything else pads to the chunk capacity (the bulk-scan shape;
  multi-chunk scans stream it).

The evaluator takes the row count along with the tensors (the
``__rowvalid__`` lane emitted by ``encode_batch``) and masks the tail
rows inside the jitted program, so occupancy is ragged while the
compiled shape stays fixed — the Ragged Paged Attention trick applied
to policy batches.  ``KTPU_CANONICAL_CAPS`` inserts extra capacities
(e.g. ``64,1024,16384``) for deployments whose mid-size rescans are
transfer-bound; every entry is one more executable to warm.

ktpu-lint KTPU204 flags any ``encode_batch`` / ``encode_mutate_batch``
call whose ``padded_n`` is not derived from this table, so the bucket
zoo cannot silently regrow.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def canonical_caps(chunk: Optional[int] = None,
                   small: Optional[int] = None) -> Tuple[int, ...]:
    """The ascending canonical capacity table.

    ``KTPU_CANONICAL_CAPS`` (comma-separated row counts), when set, is
    the whole table; otherwise the table is ``{small, chunk}``.
    Callers with their own chunk/small configuration (``BatchScanner``
    passes its class attributes) thread it through so a monkeypatched
    scanner and this table can never disagree."""
    raw = os.environ.get('KTPU_CANONICAL_CAPS', '')
    if raw.strip():
        try:
            caps = sorted({int(x) for x in raw.split(',') if x.strip()})
            if caps and all(c > 0 for c in caps):
                return tuple(caps)
        except ValueError:
            pass
    if chunk is None:
        chunk = _env_int('KTPU_SCAN_CHUNK', 16384)
    if small is None:
        small = _env_int('KTPU_SMALL_BATCH', 64)
    return tuple(sorted({max(small, 1), max(chunk, 1)}))


def canonical_capacity(n: int, chunk: Optional[int] = None,
                       small: Optional[int] = None,
                       caps: Optional[Sequence[int]] = None) -> int:
    """Smallest canonical capacity holding ``n`` rows (callers chunk
    batches larger than the biggest capacity, so the top entry also
    serves as the spill shape)."""
    table = tuple(caps) if caps is not None else \
        canonical_caps(chunk=chunk, small=small)
    for cap in table:
        if n <= cap:
            return cap
    return table[-1]


def small_capacity(small: Optional[int] = None) -> int:
    """The admission-serving capacity (the table's smallest entry)."""
    return canonical_caps(small=small)[0]
