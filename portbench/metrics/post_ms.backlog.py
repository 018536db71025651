"""Operator: the work after the step a batch, counters, watermarks and
samples (tpusketch/post): the sum of `post` over the sum of `batches` in the window's harvest
records (the operator's ``last_harvest_ms``), in ms."""


def read(obs):
    rows = [h for h in obs.get("harvests", []) if "post" in h and "batches" in h]
    n = sum(h["batches"] for h in rows)
    return sum(h["post"] for h in rows) / n if n else None
