"""Readback and report assembly (``CompactOut.host``,
``compiler/scan.py _assemble_report_window``): host ms of the ``d2h``
and ``report`` stages per chunk."""
from portbench.readers import stage_ms_per_chunk


def read(obs):
    return stage_ms_per_chunk(obs, ('d2h', 'report'))
