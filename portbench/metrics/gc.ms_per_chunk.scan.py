"""The host runtime: ms per chunk of garbage-collector pauses (the
program's ``gc`` stage; every thread waits while one runs)."""
from portbench.readers import stage_ms_per_chunk

STAGES = ('gc',)


def read(obs):
    flushes = obs.get('flushes') or []
    last = flushes[-1][2] if flushes else None
    if not last or any(s not in last for s in STAGES):
        # a program that records no such stage
        return None
    return stage_ms_per_chunk(obs, STAGES)
