"""Readback and report assembly: thread CPU ms of the ``d2h`` and
``report`` stages per chunk, beside their wall ms
(``assembly.ms_per_chunk.scan``); the difference is time spent waiting
for the interpreter lock or the garbage collector."""
from portbench.readers import stage_ms_per_chunk, stages_recorded

STAGES = ('d2h.cpu', 'report.cpu')


def read(obs):
    if not stages_recorded(obs, STAGES):
        return None
    return stage_ms_per_chunk(obs, STAGES)
