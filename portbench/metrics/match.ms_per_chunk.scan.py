"""The match (``compiler/scan.py`` ``match_matrix``, run by the pipeline's
encode thread under the interpreter lock): host ms of the ``match``
stage per chunk."""
from portbench.readers import stage_ms_per_chunk

STAGES = ('match',)


def read(obs):
    flushes = obs.get('flushes') or []
    last = flushes[-1][2] if flushes else None
    if not last or any(s not in last for s in STAGES):
        # a program that records no such stage
        return None
    return stage_ms_per_chunk(obs, STAGES)
