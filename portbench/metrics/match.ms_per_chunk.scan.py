"""The match (``compiler/scan.py`` ``match_matrix``, run by the pipeline's
encode thread under the interpreter lock): host ms of the ``match``
stage per chunk."""
from portbench.readers import stage_ms_per_chunk, stages_recorded

STAGES = ('match',)


def read(obs):
    if not stages_recorded(obs, STAGES):
        return None
    return stage_ms_per_chunk(obs, STAGES)
