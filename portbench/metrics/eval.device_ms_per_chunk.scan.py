"""The kernels: ms per chunk of the K1 calls on the card, from CUDA
events the program records around ``evaluate_packed`` (the ``device``
stage; none off the card)."""
from portbench.readers import stage_ms_per_chunk

STAGES = ('device',)


def read(obs):
    flushes = obs.get('flushes') or []
    last = flushes[-1][2] if flushes else None
    if not last or any(s not in last for s in STAGES):
        # a program that records no such stage
        return None
    return stage_ms_per_chunk(obs, STAGES)
