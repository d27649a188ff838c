"""K2 staging (``ops/eval.py`` ``pack_batch`` and ``shard_batch``): host ms
of the ``pack`` and ``h2d`` stages per chunk."""
from portbench.readers import stage_ms_per_chunk


def read(obs):
    return stage_ms_per_chunk(obs, ('pack', 'h2d'))
