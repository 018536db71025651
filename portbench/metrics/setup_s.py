"""Process start to the first measured batch (host clock)."""

from portbench import readings


def read(obs):
    return readings.setup_s(obs)
