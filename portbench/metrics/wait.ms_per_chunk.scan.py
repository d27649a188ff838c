"""The scan's report loop (``compiler/scan.py`` ``scan_report_results``):
ms per chunk that it waited for the pipeline's next chunk (the ``wait``
stage)."""
from portbench.readers import stage_ms_per_chunk, stages_recorded

STAGES = ('wait',)


def read(obs):
    if not stages_recorded(obs, STAGES):
        return None
    return stage_ms_per_chunk(obs, STAGES)
