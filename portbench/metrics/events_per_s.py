"""Events folded on the card by the window's end, a second (host clock)."""

from portbench import readings


def read(obs):
    return readings.events_per_s(obs)
