"""The reduction of a `torch.profiler` trace of a steady slice of the
window: device busy time (the union of kernel intervals), kernel time by
name, the device time of the operator's update ranges, K2's launches,
and the longest idle gaps named by the host range they fall in."""

from __future__ import annotations

import re

K2_KERNEL = "fused_planes_kernel"
UPDATE_RANGE = "ig:tpusketch_update"
NAME_CHARS = 160  # a device op's name in the breakdown, cut to this length


def _device_total(evt) -> float:
    attr = "device_time_total" if hasattr(type(evt), "device_time_total") else "cuda_time_total"
    return float(getattr(evt, attr, 0.0) or 0.0)


def base_name(name: str) -> str:
    """A kernel's function name without its return type, template
    arguments and parameters."""
    m = re.match(r"\s*(?:void\s+)?([A-Za-z_][\w:]*)", name)
    return m.group(1) if m else name


def _on_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def _host_label(name: str) -> bool:
    """A range the program or the benchmark names (``ig:``, ``tpusketch/``,
    ``portbench:``, ``op/``, ``run/``), not an aten op or a runtime call."""
    return name.startswith(("ig:", "tpusketch/", "portbench:", "op/", "run/"))


def reduce(events, window_s: float) -> dict:
    """Device figures of one profiled slice of `window_s` seconds, from
    the profiler's function events."""
    kernels, ranges, update = [], [], []
    for e in events:
        s, t = float(e.time_range.start), float(e.time_range.end)
        if _on_device(e):
            # the device timeline also carries the host ranges' own spans
            # (user annotations): only kernels, copies and fills are work
            if not (getattr(e, "is_user_annotation", False) or _host_label(e.name)):
                kernels.append((s, t, e.name))
        elif _host_label(e.name):
            ranges.append((s, t, e.name))
            if e.name == UPDATE_RANGE:
                update.append(_device_total(e))
    out: dict = {"window_s": window_s, "kernels": len(kernels)}
    if not kernels:
        return out
    kernels.sort()
    merged: list[list[float]] = []
    for s, t, _ in kernels:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    out["busy_s"] = sum(t - s for s, t in merged) / 1e6
    by_name: dict[str, float] = {}
    for s, t, name in kernels:
        key = name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + (t - s) / 1e6
    out["device_ops"] = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out["k2_ms"] = [(t - s) / 1e3 for s, t, name in kernels
                     if K2_KERNEL in name]
    if update:
        out["update_device_ms"] = [u / 1e3 for u in update]
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    ranges.sort(key=lambda r: r[1] - r[0])
    labelled = []
    for length, s, t in gaps[:10]:
        mid = (s + t) / 2
        name = next((r[2] for r in ranges if r[0] <= mid <= r[1]), "no host range")
        labelled.append([f"host in {name}", length / 1e6])
    out["idle_gaps"] = labelled
    return out
