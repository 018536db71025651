"""Sketch kernels: K2's least time over its profiled time a launch, in %."""

from portbench import readings


def read(obs):
    return readings.k2_roofline(obs)
