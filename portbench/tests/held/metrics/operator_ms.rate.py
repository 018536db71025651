"""Operator: ig_operator_enrich_seconds{operator=tpusketch}, sum over count."""

from portbench import readings


def read(obs):
    return readings.histogram_ms(obs, "enrich")
