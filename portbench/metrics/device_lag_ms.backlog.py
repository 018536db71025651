"""Device: the step's fence event's completion less the host's dispatch
end, a batch: the sum of `device_lag` over the sum of `batches` in the window's harvest
records (the operator's ``last_harvest_ms``), in ms."""


def read(obs):
    rows = [h for h in obs.get("harvests", []) if "device_lag" in h and "batches" in h]
    n = sum(h["batches"] for h in rows)
    return sum(h["device_lag"] for h in rows) / n if n else None
