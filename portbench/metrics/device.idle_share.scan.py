"""The device: the share of the traced window in which it ran nothing
(the profiler's device activity), in %."""
from portbench.readers import idle_share


def read(obs):
    return idle_share(obs)
