"""Where the ingest step's time goes on the card.

    python -m inspektor_gadget_tpu_torch.profile_step [--seed S]

Runs `bundle_ingest_step` at chip_smoke.py's geometry (every plane on,
batch 2**17) on pre-staged device batches under ``torch.profiler`` and
prints, as one JSON line: the device time by kernel name, the device's
busy and idle share of the window, the host's time per step, and the
synthetic source's own rate filling a pinned block (the host side of the
end-to-end path). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

from .device import device_report
from .ops import sketches as S
from .sources import PinnedBufferPool, ZipfFoldedSource
from .sources.synthetic import DISTINCT, DIST, HH, LANES, VALUES, WEIGHTS

BATCH = S.PRODUCTION_BATCH
GEOM = S.PRODUCTION_GEOMETRY
STEPS = 16


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, -1.0
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def profile(steps: int, seed: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    dev = torch.device("cuda", 0)
    src = ZipfFoldedSource(seed)
    pre = [torch.from_numpy(src.generate(BATCH).view(np.int32)).to(dev) for _ in range(8)]
    bundle = S.bundle_init(**GEOM, device=dev)

    def step(i: int) -> None:
        p = pre[i % 8]
        S.bundle_ingest_step(bundle, p[HH], p[DISTINCT], p[DIST], p[WEIGHTS], values=p[VALUES])

    for i in range(4):
        step(i)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    intervals = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        dur = ev.time_range.end - ev.time_range.start
        by_name[ev.name][0] += dur
        by_name[ev.name][1] += 1
        intervals.append((ev.time_range.start, ev.time_range.end))
    busy = _busy_us(intervals)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]

    pool = PinnedBufferPool(BATCH, lanes=LANES, device=dev)
    blk = pool.get().numpy()
    src.fill(blk)
    t0 = time.perf_counter()
    for _ in range(16):
        src.fill(blk)
    host_ev_s = 16 * BATCH / (time.perf_counter() - t0)
    return {
        "steps": steps, "batch": BATCH, "window_us_per_step": window_us / steps,
        "device_busy_us_per_step": busy / steps, "device_idle_share": 1.0 - busy / window_us,
        "kernels_per_step": len(intervals) / steps,
        "device_us_per_step_by_kernel": [[name, t / steps, n / steps] for name, (t, n) in top],
        "source_fill_ev_per_s": host_ev_s,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    rep = device_report("cuda")
    out = profile(STEPS, args.seed)
    out["device"] = rep
    print(json.dumps(out))


if __name__ == "__main__":
    main()
