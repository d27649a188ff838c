"""Encode (``compiler/encode.py``, in the forked workers): host ms per
16,384-row chunk between the window's first and last flush."""
from portbench.readers import stage_ms_per_chunk


def read(obs):
    return stage_ms_per_chunk(obs, ('encode',))
