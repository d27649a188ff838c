"""Readback and report assembly: thread CPU ms of the ``d2h`` and
``report`` stages per chunk, beside their wall ms
(``assembly.ms_per_chunk.scan``); the difference is time spent waiting
for the interpreter lock or the garbage collector."""
from portbench.readers import stage_ms_per_chunk

STAGES = ('d2h.cpu', 'report.cpu')


def read(obs):
    flushes = obs.get('flushes') or []
    last = flushes[-1][2] if flushes else None
    if not last or any(s not in last for s in STAGES):
        # a program that records no such stage
        return None
    return stage_ms_per_chunk(obs, STAGES)
