"""The host runtime: ms per chunk of garbage-collector pauses (the
program's ``gc`` stage; every thread waits while one runs)."""
from portbench.readers import stage_ms_per_chunk, stages_recorded

STAGES = ('gc',)


def read(obs):
    if not stages_recorded(obs, STAGES):
        return None
    return stage_ms_per_chunk(obs, STAGES)
