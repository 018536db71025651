"""Where a main path's step time goes on the card.

    python -m inspektor_gadget_tpu_torch.profile_step [--path P] [--seed S]

``--path ingest`` (the default) runs `bundle_ingest_step` at
chip_smoke.py's geometry (every plane on, batch 2**17) on pre-staged
device batches; ``--path ae|vae|seq`` runs the anomaly plane's
`harvest_tick` at chip_smoke.py's widths on 128 containers (seq through
K3, ``attn="flash"``); ``--path operator`` drives the tpusketch
operator as chip_smoke.py's operator phase does (`profile_operator`).
Under ``torch.profiler`` it prints, as one JSON line: the device time by kernel name, the device's busy and idle share
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
import shutil
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from .device import device_report
from .ops import sketches as S
from .sources import PinnedBufferPool, ZipfFoldedSource
from .sources.batch import EventBatch
from .sources.synthetic import DISTINCT, DIST, HH, LANES, VALUES, WEIGHTS

BATCH = S.PRODUCTION_BATCH
GEOM = S.PRODUCTION_GEOMETRY
STEPS = 16
TICKS = 8
WINDOW = dict(n_slots=8, depth=4, log2_width=12)  # the reference operator's history defaults
HARVEST_EVERY = 16          # folded batches between the operator's harvests
OP_EVENT_BATCHES = 8        # EventBatches through enrich_batch
OP_CONTAINERS = 64          # the synthetic exec source's containers (native/sources.cc:365)
OP_MNTNS0 = 4026531840      # their first mount namespace
OP_HOT = 8                  # containers of the "hot" priority class
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


def _device_events(prof) -> tuple[dict[str, list[float]], list[tuple[float, float]]]:
    """A profile's device events -> ({name: [us, count]}, their (start,
    end) intervals); a GPU user annotation (Optimizer.step's) spans
    kernels and is left out."""
    from torch.autograd import DeviceType
    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    intervals = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        by_name[ev.name][0] += ev.time_range.end - ev.time_range.start
        by_name[ev.name][1] += 1
        intervals.append((ev.time_range.start, ev.time_range.end))
    return by_name, intervals


def _trace(step, steps: int) -> dict:
    """`step(i)` for 4 warm-up and then `steps` profiled steps -> the
    device time by kernel, busy and idle share, host time per step, and
    K3's device time, launches and share of the busy time per step."""
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
    by_name, intervals = _device_events(prof)
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


def operator_config(geometry: dict) -> dict:
    """The tpusketch operator's configuration at `geometry`: two priority
    classes splitting the invertible plane's budget (the first OP_HOT
    containers, the rest), quantiles, history sealing once a harvest
    (``history_interval`` 0; the caller names the store's directory,
    ``history_dir``), the audit sample and the seq scorer; harvests only
    when asked."""
    hot = "|".join(str(OP_MNTNS0 + i) for i in range(OP_HOT))
    lb = geometry["inv_log2_buckets"]
    return dict(depth=geometry["depth"], log2_width=geometry["log2_width"],
                hll_p=geometry["hll_p"], entropy_log2_width=geometry["entropy_log2_width"],
                topk=geometry["k"], distinct_column="pid", dist_column="aux2",
                invertible=True, inv_rows=geometry["inv_rows"], inv_log2_buckets=lb,
                priority_classes=f"hot={lb - 1}:{hot},rest={lb - 1}:*",
                quantiles=True, quantile_alpha=geometry["quantile_alpha"],
                history=True, history_interval=0.0, history_log2_width=WINDOW["log2_width"],
                history_slots=WINDOW["n_slots"], audit_sample=1024, anomaly=True,
                anomaly_model="seq", harvest_interval=3600.0)


def operator_event_batches(seed: int, batch: int) -> list[EventBatch]:
    """OP_EVENT_BATCHES seeded EventBatches of up to `batch` events whose
    heavy-hitter (key_hash), distinct (pid) and distribution (aux2)
    columns differ, with mntns over OP_CONTAINERS containers, kind and a
    latency in aux1."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, OP_CONTAINERS + 1) ** 0.8
    out = []
    for i in range(OP_EVENT_BATCHES):
        n = batch - (batch // 32) * i - i
        b = EventBatch.alloc(batch, with_comm=False)
        ranks = np.minimum(rng.zipf(1.2, n), 20000).astype(np.uint64)
        b.cols["key_hash"][:n] = ranks * np.uint64(0x9E3779B97F4A7C15) + np.uint64(1)
        b.cols["pid"][:n] = rng.integers(1000, 40000, n)
        b.cols["aux2"][:n] = np.minimum(rng.zipf(1.5, n), 400) * 131 + 7
        b.cols["aux1"][:n] = rng.lognormal(11.0, 1.5, n).astype(np.uint64)  # latency ns
        b.cols["mntns"][:n] = OP_MNTNS0 + rng.choice(OP_CONTAINERS, n, p=p / p.sum())
        b.cols["kind"][:n] = rng.integers(1, 9, n)
        b.cols["ts"][:n] = 1_700_000_000_000_000_000
        b.count, b.drops = n, 17 * i
        out.append(b)
    return out


class _HostTimes:
    """Host seconds and calls of named functions: `wrap(obj, attr)` times
    ``obj.attr`` (an instance's method or a module's function, looked up
    at call time by its caller) until `restore()`."""

    def __init__(self) -> None:
        self.s: dict[str, float] = defaultdict(float)
        self.n: dict[str, int] = defaultdict(int)
        self._undo: list[tuple] = []

    def wrap(self, obj, attr: str) -> None:
        fn = getattr(obj, attr)
        label = attr.lstrip("_")

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.s[label] += time.perf_counter() - t0
                self.n[label] += 1

        self._undo.append((obj, attr, fn, attr in vars(obj)))
        setattr(obj, attr, timed)

    def restore(self) -> None:
        for obj, attr, fn, own in reversed(self._undo):
            setattr(obj, attr, fn) if own else delattr(obj, attr)
        self._undo.clear()

    def take(self, per: int) -> dict:
        """{label: [ms per `per`, calls per `per`]} since the last take."""
        out = {k: [self.s[k] * 1e3 / per, self.n[k] / per]
               for k in sorted(self.s, key=lambda k: -self.s[k])}
        self.s.clear()
        self.n.clear()
        return out


# what the operator's entry points call on the host, by the module global
# or instance attribute they call it through
_OP_GLOBALS = ("bundle_ingest_step", "wcms_ingest_step", "hll_ingest_step", "class_weights",
               "inv_update", "_to_device")
_OP_METHODS = ("ingest_folded", "enrich_batch", "harvest", "seal_window", "_staging_for",
               "_fence", "_shadow_feed", "_inv_class_absorb", "_qt_count", "_qt_value_lane",
               "_note_watermarks", "_after_batch", "_accumulate_slices",
               "_accumulate_container_dists", "_label_sample", "_padded_mntns")


def profile_operator(seed: int) -> dict:
    """The tpusketch operator at `operator_config(GEOM)` on the card, fed
    as chip_smoke.py's operator phase feeds it: folded batches from a
    NativeCapture of the synthetic exec source (vocab 2000) through
    ``folded_block`` → ``pop_folded`` → ``ingest_folded`` with a
    ``harvest()`` every HARVEST_EVERY batches, then OP_EVENT_BATCHES
    EventBatches through ``enrich_batch`` and a harvest. After a warm-up
    (HARVEST_EVERY batches, a harvest, two EventBatches: the seq scorer's
    first step and the allocator's first blocks) each feed runs twice on
    fresh instances: once with its host functions timed
    (`_HostTimes`: ms a batch and calls a batch of each, nested ones
    inside their callers), once under ``torch.profiler`` for the
    device's busy time. The idle share is 1 - busy / the timed run's
    window (the profiler slows the host, so its own window's share,
    also given, reads high); harvests are timed apart by their parts
    (``last_harvest_ms``)."""
    from torch.profiler import ProfilerActivity
    from .operators import SketchConfig, SketchContext, TpuSketchInstance
    from .operators import tpusketch as T
    from .sources.bridge import SRC_SYNTH_EXEC, drain_synthetic

    dev = torch.device("cuda", 0)

    hist_dir = Path(__file__).resolve().parents[1] / "build" / "profile_step_hist"
    shutil.rmtree(hist_dir, ignore_errors=True)

    def instance():
        clock = iter(range(1, 1 << 30))
        ctx = SketchContext(gadget="trace/exec", run_id=f"profile-{seed}", node="node-0",
                            batch_size=BATCH, history_clock=lambda: 1.7e9 + next(clock))
        return TpuSketchInstance(SketchConfig(**operator_config(GEOM), history_dir=str(hist_dir)),
                                 ctx, device=dev)

    def folded(inst, batches: int, src_seed: int) -> list[dict]:
        harvests, seen = [], [0]

        def on_batch(_blk, fb) -> None:
            inst.ingest_folded(fb)
            seen[0] += 1
            if seen[0] % HARVEST_EVERY == 0:
                inst.harvest()
                harvests.append(dict(inst.last_harvest_ms))

        got = drain_synthetic(SRC_SYNTH_EXEC, src_seed, 2000, batches * BATCH,
                              inst.folded_block, on_batch)
        torch.cuda.synchronize(dev)
        return [{"batches": seen[0], "events": got["consumed"]}] + harvests

    def events(inst, batches) -> list[dict]:
        for b in batches:
            inst.enrich_batch(b)
        inst.harvest()
        torch.cuda.synchronize(dev)
        return [{"batches": len(batches), "events": sum(b.count for b in batches)},
                dict(inst.last_harvest_ms)]

    feeds = (("folded", lambda inst, i: folded(inst, 2 * HARVEST_EVERY, seed + 100 + i)),
             ("event_batches", lambda inst, i: events(
                 inst, operator_event_batches(seed + 200 + i, BATCH))))

    def warm():
        inst = instance()
        folded(inst, HARVEST_EVERY, seed)
        events(inst, operator_event_batches(seed, BATCH)[:2])

    warm()
    out: dict = {"path": "operator", "batch": BATCH, "config": operator_config(GEOM)}
    for i, (name, feed) in enumerate(feeds):
        # the timed run
        inst, times = instance(), _HostTimes()
        for g in _OP_GLOBALS:
            times.wrap(T, g)
        for m in _OP_METHODS:
            times.wrap(inst, m)
        t0 = time.perf_counter()
        try:
            ran = feed(inst, i)
        finally:
            times.restore()
        window_s = time.perf_counter() - t0
        head, harvests = ran[0], ran[1:]
        n = head["batches"]
        harvest_s = sum(h["total"] for h in harvests) / 1e3
        rec = dict(head, window_ms=window_s * 1e3, ev_per_s=head["events"] / window_s,
                   ev_per_s_without_harvests=head["events"] / (window_s - harvest_s),
                   host_ms_per_batch=times.take(n), harvest_ms=harvests)
        # the profiled run: device busy time over the same feed
        inst = instance()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            feed(inst, i)
            prof_window_s = time.perf_counter() - t0
        by_name, intervals = _device_events(prof)
        busy_s = _busy_us(intervals) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        rec.update(device_busy_ms=busy_s * 1e3, device_idle_share=1.0 - busy_s / window_s,
                   profiled_window_ms=prof_window_s * 1e3,
                   profiled_idle_share=1.0 - busy_s / prof_window_s,
                   device_ops_per_batch=len(intervals) / n,
                   device_ms_by_kernel=[[k, t / 1e3, c] for k, (t, c) in top])
        out[name] = rec
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--path", choices=("ingest", "ae", "vae", "seq", "operator"),
                    default="ingest")
    args = ap.parse_args()
    rep = device_report("cuda")
    if args.path == "ingest":
        out = profile(STEPS, args.seed)
    elif args.path == "operator":
        out = profile_operator(args.seed)
    else:
        out = profile_tick(args.path, TICKS, args.seed)
    out["device"] = rep
    print(json.dumps(out))


if __name__ == "__main__":
    main()
