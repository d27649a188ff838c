"""The kernels: ms per chunk of the K1 calls on the card, from CUDA
events the program records around ``evaluate_packed`` (the ``device``
stage; none off the card)."""
from portbench.readers import stage_ms_per_chunk, stages_recorded

STAGES = ('device',)


def read(obs):
    if not stages_recorded(obs, STAGES):
        return None
    return stage_ms_per_chunk(obs, STAGES)
