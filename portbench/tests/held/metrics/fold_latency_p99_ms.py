"""p99 of chunk due time to the completion of its fold (host clock)."""

from portbench import readings


def read(obs):
    return readings.fold_latency_ms(obs, 0.99)
