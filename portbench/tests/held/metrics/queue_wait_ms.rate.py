"""Source queue: mean chunk wait from due to pop (benchmark clocks)."""

from portbench import readings


def read(obs):
    return readings.queue_wait_ms(obs)
