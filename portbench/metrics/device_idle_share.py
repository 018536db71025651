"""Device: share of the profiled slice with no kernel running, in %."""

from portbench import readings


def read(obs):
    return readings.device_idle_share(obs)
