"""Runtime: pop to batch callback less the operator's enrich, a batch."""

from portbench import readings


def read(obs):
    return readings.framework_ms(obs)
