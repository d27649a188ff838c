"""The benchmark's arithmetic, frozen here: the scan's window (which
chunk intervals it counts, when it closes, and its rate), and K1v's
least time (its roofline) from the cell's shapes."""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

#: one NVIDIA H100 SXM's memory rate (NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
#: its integer and float32 rate outside the tensor cores
CUDA_CORE_OPS_PER_S = 67e12


def flush_rate(flushes: List[Tuple[float, int]]) -> float:
    """Rows per second over the window's report flushes ``[(time, rows)]``,
    in the order they came: the rows of every flush after the first, over
    the time from the first flush to the last.  A stall between two
    flushes counts in full."""
    if len(flushes) < 2:
        raise ValueError('a rate needs two flushes in the window')
    span = flushes[-1][0] - flushes[0][0]
    return sum(rows for _, rows in flushes[1:]) / span


class Interval(NamedTuple):
    """A counted chunk interval of the scan's window: from the
    chunk-opening flush ``flushes[first]`` at ``start`` to the next one,
    ``flushes[first + 1]``, at ``end``, credited with the ``rows`` of the
    chunk it opened."""
    first: int
    start: float
    end: float
    rows: int


def counts(row: int, chunk: int, warm_chunks: int, pass_rows: int) -> bool:
    """Whether the interval opened by the chunk-opening flush at ``row`` of
    a pass of ``pass_rows`` rows is counted: its chunk lies at or after
    the pass's first ``warm_chunks``, and the pass has a next chunk, whose
    opening flush ends the interval."""
    return row >= warm_chunks * chunk and row + chunk < pass_rows


def steady_window(flushes: List[Tuple[float, int, int]], chunk: int,
                  warm_chunks: int, pass_rows: int
                  ) -> Tuple[List[Interval], Optional[float]]:
    """The counted intervals and the rate of a scan window, from its
    chunk-opening flushes ``[(time, row in the pass, pass)]`` in the order
    they came.

    An interval counts from one chunk-opening flush to the next of the
    same pass, where ``counts`` holds for the first, and is credited with
    that chunk's rows; a stall inside it counts in full.  The interval
    that reaches across a pass's end (the pass's last chunk and the next
    pass's cold start) is dropped, rows and time, and so are the next
    pass's first ``warm_chunks`` chunks, which repeat set-up's warm-up.
    The rate is the counted rows over the counted seconds: ``flush_rate``
    of the counted intervals laid end to end; None where none counts."""
    intervals = [
        Interval(k, t0, t1, r1 - r0)
        for k, ((t0, r0, p0), (t1, r1, p1)) in enumerate(
            zip(flushes, flushes[1:]))
        if p0 == p1 and counts(r0, chunk, warm_chunks, pass_rows)]
    if not intervals:
        return intervals, None
    laid = [(0.0, 0)]
    for iv in intervals:
        laid.append((laid[-1][0] + iv.end - iv.start, iv.rows))
    return intervals, flush_rate(laid)


def close_at(flushes: List[Tuple[float, int, int]], chunk: int,
             warm_chunks: int, pass_rows: int, seconds: float) -> float:
    """The time at which the window closes, as it stands at its latest
    chunk-opening flush: when the counted seconds reach ``seconds``,
    inside the interval that flush opens if that one counts; never
    (``inf``) before a later flush where it does not.  The interval the
    window closes in is not complete, and is not counted."""
    t, row, _ = flushes[-1]
    if not counts(row, chunk, warm_chunks, pass_rows):
        return math.inf
    intervals, _ = steady_window(flushes, chunk, warm_chunks, pass_rows)
    return t + seconds - sum(iv.end - iv.start for iv in intervals)


def k1v_bytes(rows: int, lane_bytes_per_row: float, rules: int) -> float:
    """The bytes one K1v launch over ``rows`` rows has to move: each
    row's encoded lanes read once, and per device rule its status and
    detail bytes and its int32 fail column written once.  It counts the
    encoder's lanes and the policy set's rules, not the kernel's launch
    arguments, so a redesigned kernel or pack layout reads the same
    work."""
    return rows * (lane_bytes_per_row + rules * (1 + 1 + 4))


def k1v_least_s(rows: int, lane_bytes_per_row: float, rules: int) -> float:
    """The least time of one K1v launch: the larger of its bytes over the
    memory rate and one operation per (row, rule) over the core rate;
    the bytes bound it."""
    return max(k1v_bytes(rows, lane_bytes_per_row, rules) / HBM_BYTES_PER_S,
               rows * rules / CUDA_CORE_OPS_PER_S)
