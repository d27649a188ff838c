"""The benchmark's arithmetic, frozen here: the scan's flush-to-flush
rate, and K1v's least time (its roofline) from the cell's shapes."""

from __future__ import annotations

from typing import List, Tuple

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
