"""Shared arithmetic of the per-layer metric readers
(``metrics/<metric>.py``).  A reader that finds nothing to read returns
None, and the harness leaves its metric out of the result."""

from __future__ import annotations

from typing import Optional, Sequence


def stages_recorded(obs: dict, stages: Sequence[str]) -> bool:
    """Whether the program recorded every one of ``stages`` by the
    window's last chunk-opening flush (a program older than a stage
    records none of it)."""
    snaps = obs.get('stages') or []
    return bool(snaps) and snaps[-1] is not None and \
        all(s in snaps[-1] for s in stages)


def stage_ms_per_chunk(obs: dict, stages: Sequence[str]) -> Optional[float]:
    """Host milliseconds per scan chunk that the program's pipeline
    stages ``stages`` took in the window's counted intervals
    (``ScanCapture``, copied at each chunk-opening flush; a forked
    worker's encode counts in full): each interval's stage seconds,
    summed, over the counted chunks."""
    intervals = obs.get('intervals') or []
    snaps = obs.get('stages') or []
    if not intervals or not snaps or snaps[0] is None:
        return None
    seconds = sum(snaps[iv.first + 1].get(s, 0.0) - snaps[iv.first].get(s, 0.0)
                  for iv in intervals for s in stages)
    chunks = sum(iv.rows for iv in intervals) / obs['chunk']
    return 1e3 * seconds / chunks


def roofline_share(launches) -> Optional[float]:
    """Percent of its roofline a kernel reached over its launches
    ``[(rows, device ms, least ms)]``: the least time over the time."""
    if not launches:
        return None
    return 100.0 * sum(least for _, _, least in launches) / \
        sum(ms for _, ms, _ in launches)


def idle_share(obs: dict) -> Optional[float]:
    """Percent of the window's counted intervals in which the device ran
    nothing."""
    dev = obs.get('device')
    if not dev or not dev.get('busy_s'):
        return None
    return 100.0 * (1.0 - dev['busy_s'] / dev['window_s'])
