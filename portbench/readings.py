"""What the metric readers compute from a run's observations (the
`obs` dictionary `harness.Run` gathers). A reader under ``metrics/``
names one of these; each returns None where the run has nothing to read,
and the harness then leaves the metric out of the result."""

from __future__ import annotations

import math
import statistics

NEVER_MS = 1e9  # the latency a dropped chunk's percentile reads


def events_per_s(obs: dict) -> float | None:
    """Events of the window's batches whose fold had completed on the
    card by the window's end, over the window's seconds."""
    if obs["kind"] != "backlog" or not obs["batches"]:
        return None
    n = sum(b["n"] for b in obs["batches"] if b["done"] <= obs["t_end"])
    return n / obs["seconds"]


def fold_latency_ms(obs: dict, q: float) -> float | None:
    """The q-th quantile (nearest rank) over every chunk offered in the
    window, from its due time to the completion of the fold that took
    it; a dropped chunk counts as never completing, and where the
    quantile falls on one it reads `NEVER_MS`."""
    ch = obs.get("chunks")
    if ch is None or not len(ch["due"]):
        return None
    lat = sorted((d - u) * 1e3 for d, u in zip(ch["done"], ch["due"]))
    v = lat[max(math.ceil(q * len(lat)) - 1, 0)]
    return v if math.isfinite(v) else NEVER_MS


def summary_lag_ms(obs: dict) -> float | None:
    """Mean over the window's summaries of the time from the due time of
    the newest batch a summary covers to its arrival at the hook."""
    lag = obs["summary_lag_s"]
    return 1e3 * statistics.fmean(lag) if lag else None


def setup_s(obs: dict) -> float | None:
    v = obs["setup_s"]
    return v if math.isfinite(v) else NEVER_MS


def queue_wait_ms(obs: dict) -> float | None:
    """Mean over the window's popped chunks of the time from due to pop."""
    ch = obs.get("chunks")
    if ch is None:
        return None
    waits = [(p - d) * 1e3 for p, d in zip(ch["pop"], ch["due"]) if math.isfinite(p)]
    return statistics.fmean(waits) if waits else None


def histogram_ms(obs: dict, key: str) -> float | None:
    """Sum over count of one of the program's timing histograms, within
    the window, in ms."""
    s, n = obs["counters"].get(key, (0.0, 0))
    return 1e3 * s / n if n else None


def framework_ms(obs: dict) -> float | None:
    """Per window batch: pop's end to the batch callback, less the
    operator's own enrich time, in ms."""
    b = obs["batches"]
    s, n = obs["counters"].get("enrich", (0.0, 0))
    if not b or not n:
        return None
    span = sum(x["handled"] - x["pop_end"] for x in b)
    return 1e3 * (span - s) / len(b)


def split_ms(rows: list[dict], key: str) -> float | None:
    vals = [r[key] for r in rows if key in r]
    return statistics.fmean(vals) if vals else None


def step_device_ms(obs: dict) -> float | None:
    p = obs.get("profile") or {}
    v = p.get("update_device_ms")
    return statistics.fmean(v) if v else None


def k2_roofline(obs: dict) -> float | None:
    """K2's least time over its mean profiled time a launch, in %."""
    p = obs.get("profile") or {}
    k2 = p.get("k2_ms")
    if not k2:
        return None
    return 100.0 * obs["k2_least_ms"] / statistics.fmean(k2)


def device_idle_share(obs: dict) -> float | None:
    p = obs.get("profile") or {}
    if not p.get("kernels"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
