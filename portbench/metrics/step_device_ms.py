"""Step: device time of the ig:tpusketch_update ranges, a step (profiler)."""

from portbench import readings


def read(obs):
    return readings.step_device_ms(obs)
