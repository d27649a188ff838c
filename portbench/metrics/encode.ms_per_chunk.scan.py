"""Encode (``compiler/encode.py``, in the forked workers): host ms per
16,384-row chunk in the window's counted intervals."""
from portbench.readers import stage_ms_per_chunk


def read(obs):
    return stage_ms_per_chunk(obs, ('encode',))
