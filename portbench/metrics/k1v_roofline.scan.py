"""K1v (``csrc/k1_vm.cu``) on the scan's chunks: its least time
(``arith.k1v_least_s``, bound by bytes) over its CUDA-event time, in %."""
from portbench.readers import roofline_share


def read(obs):
    return roofline_share(obs.get('k1v'))
