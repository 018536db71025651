"""The share of the open loop's traced slice in which no kernel ran."""

from portbench import readings


def read(obs):
    return readings.device_idle_share(obs) if obs["kind"] == "open_loop" else None
