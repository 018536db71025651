"""Step: the host's dispatch of the step a batch (tpusketch/update):
the sum of `dispatch` over the sum of `batches` in the window's harvest
records (the operator's ``last_harvest_ms``), in ms."""


def read(obs):
    rows = [h for h in obs.get("harvests", []) if "dispatch" in h and "batches" in h]
    n = sum(h["batches"] for h in rows)
    return sum(h["dispatch"] for h in rows) / n if n else None
