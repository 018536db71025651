"""Operator: the key fold into the pinned block a batch (tpusketch/fold):
the sum of `fold` over the sum of `batches` in the window's harvest
records (the operator's ``last_harvest_ms``), in ms."""


def read(obs):
    rows = [h for h in obs.get("harvests", []) if "fold" in h and "batches" in h]
    n = sum(h["batches"] for h in rows)
    return sum(h["fold"] for h in rows) / n if n else None
