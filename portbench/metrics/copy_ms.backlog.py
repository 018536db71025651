"""Operator: the staging copy a batch, its fence wait included (tpusketch/copy):
the sum of `copy` over the sum of `batches` in the window's harvest
records (the operator's ``last_harvest_ms``), in ms."""


def read(obs):
    rows = [h for h in obs.get("harvests", []) if "copy" in h and "batches" in h]
    n = sum(h["batches"] for h in rows)
    return sum(h["copy"] for h in rows) / n if n else None
