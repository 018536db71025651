"""Where a main path's step time goes on the card.

    python -m inspektor_gadget_tpu_torch.profile_step [--path P] [--seed S]

``--path ingest`` (the default) runs `bundle_ingest_step` at
chip_smoke.py's geometry (every plane on, batch 2**17) on pre-staged
device batches; ``--path ae|vae|seq`` runs the anomaly plane's
`harvest_tick` at chip_smoke.py's widths on 128 containers (seq through
K3, ``attn="flash"``). Under ``torch.profiler`` it prints, as one JSON
line: the device time by kernel name, the device's busy and idle share
of the window, the host's time per step, K3's device time, launches and
share of the busy time (``k3``), the same for K2 (``k2``) with the
device's buffer fills beside it (``fills``: ``torch.zeros`` kernels, K2's
output fill among them, and memsets); for ingest also the
synthetic source's own rate filling a pinned block (the host side of
the end-to-end path). Needs a CUDA device.
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
TICKS = 8
K3_KERNELS = ("flash_mma_kernel", "flash_kernel")  # K3's bf16 and f32 kernels
K2_KERNELS = ("fused_planes_kernel",)
FILL_KERNELS = ("FillFunctor", "Memset")  # torch.zeros and friends (K2's output fill among them)


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, -1.0
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _trace(step, steps: int) -> dict:
    """`step(i)` for 4 warm-up and then `steps` profiled steps -> the
    device time by kernel, busy and idle share, host time per step, and
    K3's device time, launches and share of the busy time per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

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
        # device events only; a GPU user annotation (Optimizer.step's) spans kernels
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        dur = ev.time_range.end - ev.time_range.start
        by_name[ev.name][0] += dur
        by_name[ev.name][1] += 1
        intervals.append((ev.time_range.start, ev.time_range.end))
    busy = _busy_us(intervals)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]

    def block(names) -> dict:
        """Device time, launches and share of the busy time per step of
        the kernels whose names hold one of `names`."""
        hits = [(t, n) for name, (t, n) in by_name.items() if any(k in name for k in names)]
        us = sum(t for t, _ in hits)
        return {"device_us_per_step": us / steps,
                "launches_per_step": sum(n for _, n in hits) / steps,
                "share_of_busy": us / busy if busy else 0.0}

    return {
        "steps": steps, "window_us_per_step": window_us / steps,
        "device_busy_us_per_step": busy / steps, "device_idle_share": 1.0 - busy / window_us,
        "kernels_per_step": len(intervals) / steps,
        "device_us_per_step_by_kernel": [[name, t / steps, n / steps] for name, (t, n) in top],
        "k3": block(K3_KERNELS),
        "k2": dict(block(K2_KERNELS), fills=block(FILL_KERNELS), fills_by_kernel=[
            [name, t / steps, n / steps] for name, (t, n) in by_name.items()
            if any(k in name for k in FILL_KERNELS)]),
    }


def profile(steps: int, seed: int) -> dict:
    dev = torch.device("cuda", 0)
    src = ZipfFoldedSource(seed)
    pre = [torch.from_numpy(src.generate(BATCH).view(np.int32)).to(dev) for _ in range(8)]
    bundle = S.bundle_init(**GEOM, device=dev)

    def step(i: int) -> None:
        p = pre[i % 8]
        S.bundle_ingest_step(bundle, p[HH], p[DISTINCT], p[DIST], p[WEIGHTS], values=p[VALUES])

    out = _trace(step, steps)
    pool = PinnedBufferPool(BATCH, lanes=LANES, device=dev)
    blk = pool.get().numpy()
    src.fill(blk)
    t0 = time.perf_counter()
    for _ in range(16):
        src.fill(blk)
    out.update(batch=BATCH, source_fill_ev_per_s=16 * BATCH / (time.perf_counter() - t0))
    return out


def profile_tick(family: str, steps: int, seed: int) -> dict:
    """The harvest tick of `family` at chip_smoke.py's widths on 128
    containers: a zipf token matrix (4 filler rows) for seq, a zipf
    count matrix for ae and vae."""
    from . import models as M

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    if family == "seq":
        scorer = M.seq_init(M.SeqConfig(vocab=512), seed=seed, device=dev)
        batch = (np.minimum(rng.zipf(1.2, (128, 256)), 512) - 1).astype(np.int32)
        batch[-4:] = -1
    else:
        dims = dict(input_dim=4096, hidden_dim=256, latent_dim=64)
        scorer = (M.vae_init(M.VAEConfig(**dims), seed=seed, device=dev) if family == "vae"
                  else M.ae_init(M.AEConfig(**dims), seed=seed, device=dev))
        batch = rng.zipf(1.3, (128, 4096)).clip(max=1000).astype(np.float32)
    batch = torch.from_numpy(batch).to(dev)
    out = _trace(lambda i: M.harvest_tick(scorer, batch, "flash"), steps)
    out.update(path=family, containers=128)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--path", choices=("ingest", "ae", "vae", "seq"), default="ingest")
    args = ap.parse_args()
    rep = device_report("cuda")
    out = (profile(STEPS, args.seed) if args.path == "ingest"
           else profile_tick(args.path, TICKS, args.seed))
    out["device"] = rep
    print(json.dumps(out))


if __name__ == "__main__":
    main()
