"""Harvest: ig_tpusketch_harvest_seconds, sum over count."""

from portbench import readings


def read(obs):
    return readings.histogram_ms(obs, "harvest")
