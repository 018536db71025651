"""profile/block-io — block I/O latency histogram.

Reference: pkg/gadgets/profile/block-io (biolatency.bpf.c:1-156 — log2
latency histogram accumulated in a BPF map on rq issue→complete;
RunWithResult renders an ASCII histogram).

Two windows, per-IO preferred:
  blktrace   native tracefs block events (BlkTraceSource): every request's
             issue→complete latency lands in its own log2 bucket — the
             true per-IO distribution biolatency measures
  diskstats  degraded flavour (labeled in the output): /proc/diskstats
             sampling gives a per-window average weighted by IO count

The port's copy of ``inspektor_gadget_tpu/gadgets/profile/block_io.py``.
``--quantiles true`` folds the latencies into a DDSketch on the run's
device (``ctx.device``, resolved by `device.resolve_device`: cuda
without a card raises) with `ops.quantiles.dd_update`, and reads
p50/p95/p99 there with `dd_quantile`.
"""

from __future__ import annotations

import torch

from ...device import resolve_device
from ...ops import dd_init, dd_quantile, dd_update
from ...params import ParamDesc, ParamDescs, TypeHint
from ...sources.bridge import (
    SRC_BLK_TRACE, NativeCapture, blktrace_supported, native_available,
)
from ..interface import GadgetDesc, GadgetType
from ..registry import register
from ..top.block_io import _read_diskstats

EV_BLOCK_IO = 15


def render_log2_hist(buckets: list[int], unit: str = "usecs") -> bytes:
    """ASCII histogram in the reference's (BCC) style."""
    out = [f"     {unit:<12}: count    distribution"]
    maxv = max(buckets) if buckets else 0
    for i, n in enumerate(buckets):
        if maxv == 0:
            break
        lo, hi = (0 if i == 0 else 1 << (i - 1)), (1 << i) - 1
        bar = "*" * int(40 * n / maxv) if maxv else ""
        out.append(f"{lo:>10} -> {hi:<10}: {n:<8} |{bar:<40}|")
    # trim empty tail
    while len(out) > 1 and out[-1].split("|")[1].strip() == "":
        tail_count = int(out[-1].split(":")[1].split("|")[0])
        if tail_count:
            break
        out.pop()
    return ("\n".join(out) + "\n").encode()


class ProfileBlockIo:
    def __init__(self, ctx):
        self.ctx = ctx
        p = ctx.gadget_params
        self.quantiles = (p.get("quantiles").as_bool()
                          if p and "quantiles" in p else False)
        self.window = (p.get("window").as_string()
                       if p and "window" in p else "auto")
        # the fold's device (only a quantile run folds), resolved up
        # front: cuda without a card raises here, not at the first IO
        self._device = resolve_device(ctx.device) if self.quantiles else None

    def run_with_result(self, ctx) -> bytes:
        mode = self.window
        if mode == "auto":
            mode = ("blktrace" if native_available() and blktrace_supported()
                    else "diskstats")
        if mode == "blktrace":
            if not blktrace_supported():
                raise RuntimeError(
                    "profile/block-io: tracefs block events unavailable "
                    "(mount tracefs or use --window diskstats)")
            return self._run_blktrace(ctx)
        return self._run_diskstats(ctx)

    # -- per-IO window (biolatency parity) ----------------------------------

    def _run_blktrace(self, ctx) -> bytes:
        buckets = [0] * 32
        pending: list[tuple[float, int]] = []
        sketch = None
        src = NativeCapture(SRC_BLK_TRACE, ring_pow2=16)
        with src:
            while not ctx.done:
                if ctx.sleep_or_done(0.05):
                    break
                b = src.pop()
                c = b.cols
                for i in range(b.count):
                    if int(c["kind"][i]) != EV_BLOCK_IO:
                        continue
                    lat_us = max(int(c["aux1"][i]), 1)
                    buckets[min(lat_us.bit_length(), 31)] += 1
                    if self.quantiles:
                        pending.append((lat_us / 1e6, 1))
                if len(pending) >= self._FLUSH:
                    sketch = self._fold(sketch, pending)
                    pending = []
        # release the native handle (and its 64K-slot ring) now — __exit__
        # only stops the source, keeping it registered until GC
        src.close()
        if pending:
            sketch = self._fold(sketch, pending)
        out = render_log2_hist(buckets)
        out += b"\nsource: tracefs block events (per-IO)\n"
        if sketch is not None:
            out += self._quantile_summary(sketch)
        return out

    # -- degraded flavour: windowed diskstats averages ----------------------

    def _run_diskstats(self, ctx) -> bytes:
        buckets = [0] * 32
        # pending (latency_s, weight) since the last sketch fold; flushed
        # every _FLUSH ticks so memory stays O(n_buckets), not O(runtime) —
        # DDSketch is an online structure, feed it online
        pending: list[tuple[float, int]] = []
        sketch = None
        prev = _read_diskstats()
        while not ctx.done:
            if ctx.sleep_or_done(0.05):
                break
            cur = _read_diskstats()
            for dev, now in cur.items():
                p = prev.get(dev)
                if p is None:
                    continue
                dios = (now[0] - p[0]) + (now[2] - p[2])
                dq_ms = now[5] - p[5]
                if dios > 0 and dq_ms >= 0:
                    avg_us = max(int(dq_ms * 1000 / dios), 1)
                    buckets[min(avg_us.bit_length(), 31)] += dios
                    if self.quantiles:
                        pending.append((avg_us / 1e6, dios))
            prev = cur
            if len(pending) >= self._FLUSH:
                sketch = self._fold(sketch, pending)
                pending = []
        if pending:
            sketch = self._fold(sketch, pending)
        out = render_log2_hist(buckets)
        out += (b"\nsource: diskstats sampling (windowed averages, "
                b"degraded; per-IO needs tracefs)\n")
        if sketch is not None:
            out += self._quantile_summary(sketch)
        return out

    _FLUSH = 256

    def _fold(self, sketch, pending):
        """Fold pending observations into the mergeable DDSketch — the
        cluster-aggregatable plane the reference's per-node histogram lacks
        — on the run's device; the weights go in as the update's int32
        mask, as the reference passes them."""
        dev = self._device
        vals = torch.tensor([v for v, _ in pending], dtype=torch.float32, device=dev)
        w = torch.tensor([w for _, w in pending], dtype=torch.float32, device=dev)
        return dd_update(sketch if sketch is not None
                         else dd_init(alpha=0.01, device=dev), vals, w)

    def _quantile_summary(self, sketch) -> bytes:
        qs = dd_quantile(sketch, [0.5, 0.95, 0.99]).tolist()
        p50, p95, p99 = (x * 1e6 for x in qs)
        return (f"\nlatency quantiles (usecs, ddsketch alpha=1%): "
                f"p50={p50:.0f} p95={p95:.0f} p99={p99:.0f}\n").encode()

    run = run_with_result


@register
class ProfileBlockIoDesc(GadgetDesc):
    name = "block-io"
    category = "profile"
    gadget_type = GadgetType.PROFILE
    description = "Block I/O latency log2 histogram"
    event_cls = None

    def params(self) -> ParamDescs:
        return ParamDescs([
            ParamDesc(key="quantiles", default="false",
                      type_hint=TypeHint.BOOL,
                      description="append mergeable DDSketch p50/p95/p99"),
            ParamDesc(key="window", default="auto",
                      possible_values=("auto", "blktrace", "diskstats"),
                      description="per-IO tracefs window or windowed "
                                  "diskstats averages"),
        ])

    def new_instance(self, ctx) -> ProfileBlockIo:
        return ProfileBlockIo(ctx)
