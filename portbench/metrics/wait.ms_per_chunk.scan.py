"""The scan's report loop (``compiler/scan.py`` ``scan_report_results``):
ms per chunk that it waited for the pipeline's next chunk (the ``wait``
stage)."""
from portbench.readers import stage_ms_per_chunk

STAGES = ('wait',)


def read(obs):
    flushes = obs.get('flushes') or []
    last = flushes[-1][2] if flushes else None
    if not last or any(s not in last for s in STAGES):
        # a program that records no such stage
        return None
    return stage_ms_per_chunk(obs, STAGES)
