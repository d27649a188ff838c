"""Shared arithmetic of the per-layer metric readers
(``metrics/<metric>.py``).  A reader that finds nothing to read returns
None, and the harness leaves its metric out of the result."""

from __future__ import annotations

from typing import Optional, Sequence


def stage_ms_per_chunk(obs: dict, stages: Sequence[str]) -> Optional[float]:
    """Host milliseconds per scan chunk that the program's pipeline
    stages ``stages`` took between the window's first and last report
    flush (``ScanCapture``; a forked worker's encode counts in full)."""
    flushes = obs.get('flushes') or []
    if len(flushes) < 2 or flushes[0][2] is None:
        return None
    first, last = flushes[0][2], flushes[-1][2]
    seconds = sum(last.get(s, 0.0) - first.get(s, 0.0) for s in stages)
    chunks = sum(rows for _, rows, _ in flushes[1:]) / obs['chunk']
    return 1e3 * seconds / chunks


def roofline_share(launches) -> Optional[float]:
    """Percent of its roofline a kernel reached over its launches
    ``[(rows, device ms, least ms)]``: the least time over the time."""
    if not launches:
        return None
    return 100.0 * sum(least for _, _, least in launches) / \
        sum(ms for _, ms, _ in launches)


def idle_share(obs: dict) -> Optional[float]:
    """Percent of the window in which the device ran nothing."""
    dev = obs.get('device')
    if not dev or not dev.get('busy_s'):
        return None
    return 100.0 * (1.0 - dev['busy_s'] / dev['window_s'])
