#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed S]

Builds the port's CUDA kernels from ``inspektor_gadget_tpu_torch/csrc``
(one nvcc per source, all started together), holds each against its
plain PyTorch version on the card at the main paths' shapes, then drives
the two main paths. K1 and K2 are also held, with torch.equal, on
stress inputs: one hot key in every row, weights near 2**31 that wrap,
n = 100003 and n = 33 with lanes that are rows of one (5, n) tensor (so
rows 1-4 start off 16 bytes), count-min rows of 2**18 and 2**20, HLL p
16; their launch plans (blocks, jobs, shared memory a block, blocks
resident an SM by cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
ptxas' registers and spills are logged.

The sketch-ingest path: a seeded zipf stream (vocab 5000, s 1.2) of
2**17-event batches through the pinned pool, the H2D stager and
`bundle_ingest_step` at the production sketch geometry with every plane
on (count-min 4 x 2**16, HLL p 14, entropy 2**12, top-k 128, invertible
3 x 2**12, DDSketch 2048 buckets) (K2). The same stream is also folded
by the plain composition `bundle_update` on the card, whose entropy
update is K1. Both bundles must equal, leaf by leaf, the same fold on
the CPU, where no kernel runs.

The anomaly plane: 8 harvest ticks (one optimizer step, then a score of
every container) of each scorer family at the operator's widths on 128
containers fed by a seeded zipf event stream: ae and vae on 4096-bucket
count vectors (hidden 256, latent 64), seq (vocab 512, d_model 128, 4
heads, 2 layers, window 256) on the operator's token matrix with
``attn="flash"`` (K3). The seq scores must agree with the same ticks
through ``attn="full"`` on the card and through the plain path on the
CPU, from the same weights.

The operator (phase 5c): the port's `TpuSketchInstance` at the
production geometry with every plane on (two priority classes splitting
the invertible budget, quantiles, history sealed once a harvest into a
window sink, audit sample 1024, the seq scorer), fed through its own
entry points: a NativeCapture of the synthetic exec source (vocab 2000)
popped into `folded_block()`s and ingested with `ingest_folded`, a
harvest every 16 batches, then 8 seeded EventBatches through
`enrich_batch`, then `post_gadget_run` (final harvest, window and
checkpoint). The same streams through an instance on the CPU must give
the same summaries, sealed windows and checkpoint leaves.

The launch counts are set to 0 just before each card run of a path and
read just after it.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists each kernel's launches, error and times. The
full report also goes to build/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import queue
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from inspektor_gadget_tpu_torch.profile_step import (HARVEST_EVERY, OP_CONTAINERS,
                                                     OP_EVENT_BATCHES, WINDOW, operator_config,
                                                     operator_event_batches)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor, f32 CUDA cores
SRC = "inspektor_gadget_tpu_torch/csrc/sketch_kernels.cu"
K3_SRC = "inspektor_gadget_tpu_torch/csrc/flash_attention.cu"
CONTAINERS, SILENT = 128, 4  # containers a node runs; of them, ones with under 4 events
TICKS = 8
SEQ_WINDOW = 256


def log(msg: str) -> None:
    print(msg, flush=True)


def fill_block(src, block: np.ndarray, i: int) -> None:
    """Batch i of the stream: a ragged tail every 8th batch and
    pre-aggregated slots of weight 3 every 5th."""
    from inspektor_gadget_tpu_torch.sources.synthetic import WEIGHTS
    n = block.shape[1]
    src.fill(block, valid=n - 777 * (i // 8 + 1) if i % 8 == 7 else None)
    if i % 5 == 2:
        block[WEIGHTS, ::10] *= 3


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def k3_bound(shape, dtype: torch.dtype, causal: bool) -> tuple[float, str]:
    """K3's least time on the card (ms) and what sets it: q, k, v read
    once and o written once over the memory rate, or the causal (or full)
    attention's operations over the peak rate for the inputs' type."""
    b, t, h, d = shape
    nbytes = 4 * b * t * h * d * torch.empty((), dtype=dtype).element_size()
    ops = 2 * b * h * d * t * (t + 1) if causal else 4 * b * h * d * t * t
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k3_inputs(shape, dtype: torch.dtype, gen: torch.Generator, dev: torch.device):
    """q, k, v as the seq model hands them to K3: strided views of one
    [B, T, 3, H, D] qkv tensor."""
    b, t, h, d = shape
    qkv = torch.randn(b, t, 3, h, d, generator=gen, device=dev).to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def k3_err(got: torch.Tensor, want: torch.Tensor, v: torch.Tensor, causal: bool,
           what: str) -> tuple[float, float, float]:
    """Max and mean abs error of K3 against its plain version, and the
    largest share of the tolerance used. Tolerance: 2e-4 + 2e-4·|want|
    (float32, as the JAX tests hold the reference);
    `flash_attention.k3_tolerance` (bfloat16: one rounding step of the
    output, and 2^-9 max|v| for the weights P the tensor cores take in
    bfloat16)."""
    from inspektor_gadget_tpu_torch.parallel.flash_attention import k3_tolerance
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.bfloat16:
        tol = k3_tolerance(want, v, causal)
    else:
        tol = 2e-4 + 2e-4 * w.abs()
    used = float((err / tol).max())
    require(used <= 1 and got.shape == want.shape and got.dtype == want.dtype,
            f"K3 {what}: max abs err {float(err.max())}, {used:.3g} of the tolerance")
    return float(err.max()), float(err.mean()), used


def hmma_count(lib: Path) -> int:
    """Tensor-core instructions (HMMA lines) in the SASS of a built
    library, read with the CUDA toolkit's cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True)
    return sum("HMMA" in line for line in sass.stdout.splitlines())


class ContainerStream:
    """Per-container event data as the tpusketch operator accumulates it
    (``inspektor_gadget_tpu/operators/tpusketch.py:1518-1538``): each
    container's token window (seq, last `window` tokens) and its event
    count vector over `dim` buckets (ae, vae). Events are a seeded zipf
    key stream (s 1.2, 5000 ranks, offset per container) over CONTAINERS
    containers of skewed activity; SILENT of them send one event in all,
    so they stay under the 4 tokens a seq window needs. The event rate
    (64 a container a tick) and the activity skew (1/rank^0.8) are
    assumed, not taken from a source: they set how many seq rows are
    short, not the shapes K3 and the MLPs run at."""

    def __init__(self, seed: int, vocab: int, dim: int, window: int) -> None:
        self.rng = np.random.default_rng(seed)
        self.vocab, self.dim, self.window = vocab, dim, window
        self.windows: dict[int, list[int]] = {}
        self.counts: dict[int, np.ndarray] = {}
        active = CONTAINERS - SILENT
        p = 1.0 / np.arange(1, active + 1) ** 0.8
        self.p = p / p.sum()
        self.ticks = 0

    def tick(self, events: int = CONTAINERS * 64):
        """One harvest interval of events -> (seq token matrix, its ready
        rows, ae/vae count matrix)."""
        from inspektor_gadget_tpu_torch.models import seq_window_matrix, tokens_from_keys
        ns = self.rng.choice(CONTAINERS - SILENT, events, p=self.p)
        ranks = np.minimum(self.rng.zipf(1.2, events), 5000).astype(np.uint64)
        if self.ticks == 0:
            ns = np.concatenate([ns, np.arange(CONTAINERS - SILENT, CONTAINERS)])
            ranks = np.concatenate([ranks, np.ones(SILENT, np.uint64)])
        self.ticks += 1
        keys = ranks + np.uint64(31) * ns.astype(np.uint64)
        toks = tokens_from_keys(keys, self.vocab)
        buckets = (keys % np.uint64(self.dim)).astype(np.int64)
        for c in np.unique(ns):
            sel = ns == c
            seq = self.windows.setdefault(int(c), [])
            seq.extend(int(t) for t in toks[sel])
            if len(seq) > self.window:
                del seq[:-self.window]
            vec = self.counts.setdefault(int(c), np.zeros(self.dim, np.float32))
            np.add.at(vec, buckets[sel], 1.0)
        mat, n_ready = seq_window_matrix(self.windows.values(), self.window)
        return mat, n_ready, np.stack(list(self.counts.values()))


def run_ticks(scorer, batches, attn: str = "flash", noise=None):
    """harvest_tick over `batches` -> (losses, per-tick scores as numpy,
    per-tick seconds on the host clock, ending in a synchronize). `noise`
    gives the VAE's step noise a tick (default: its own generator's)."""
    from inspektor_gadget_tpu_torch.models import harvest_tick
    losses, scores, secs = [], [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        loss, sc = harvest_tick(scorer, batch, attn, None if noise is None else noise[i])
        if scorer.device.type == "cuda":
            torch.cuda.synchronize(scorer.device)
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        scores.append(sc.float().cpu().numpy())
    return losses, scores, secs


CAPTURE_BATCHES = 32


class CaptureRun:
    """The native capture leg driven as the tpusketch operator drives it
    (``operators/tpusketch.py:1328-1430``, ``:1757-1806``): a
    NativeCapture of the synthetic exec source pops folded blocks into
    the pinned pool (``pop_folded`` with the value lane), the stager
    copies them to `device`, `bundle_ingest_step` (K2) and the two window
    steps absorb each batch under one fence, and every HARVEST_EVERY
    batches a harvest reads the digest and decodes the invertible plane
    (``inv_decode_device`` with sweeps 2 and the operator's cap, then
    ``inv_decode_finish``), then the window ring advances and the window
    HLL starts afresh. `fold_cpu` folds the same stream, rebuilt from the
    seed at the same batch boundaries, on the CPU."""

    def __init__(self, seed: int, vocab: int, batch: int, prod: dict) -> None:
        self.seed, self.vocab, self.batch, self.prod = seed, vocab, batch, prod
        self.counts: list[int] = []
        self.harvests: list[dict] = []

    def _state(self, device):
        from inspektor_gadget_tpu_torch.ops import hll_init, sketches as S, window as W
        return (S.bundle_init(**self.prod, device=device), W.wcms_init(**WINDOW, device=device),
                hll_init(self.prod["hll_p"], device=device))

    def _harvest(self, bundle, wcms, whll, device) -> tuple[dict, float, float]:
        """One harvest -> (its record in host numpy, device seconds, host seconds)."""
        from inspektor_gadget_tpu_torch.ops import sketches as S, window as W
        from inspektor_gadget_tpu_torch.ops import invertible as I
        t0 = time.perf_counter()
        digest = S.bundle_digest(bundle)
        cap = min(4096, I.inv_capacity(bundle.inv.rows, bundle.inv.log2_buckets))
        dec_dev = I.inv_decode_device(bundle.inv, sweeps=2, cap=cap)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        dec = I.inv_decode_finish(*dec_dev)
        t2 = time.perf_counter()
        rec = {"digest": digest.cpu().numpy(), "decode": dataclasses.asdict(dec),
               "buffer": [x.cpu().numpy() for x in dec_dev[1:3]], "n": int(dec_dev[3]),
               "residual": [x.cpu().numpy() for x in (dec_dev[0].count, dec_dev[0].keysum,
                                                      dec_dev[0].fpsum)],
               # copies: on the CPU .cpu() is the live state, which goes on changing
               "wcms": wcms.slots.cpu().numpy().copy(), "epoch": int(wcms.epoch),
               "whll": whll.registers.cpu().numpy().copy()}
        W.wcms_advance(wcms)
        whll.registers.zero_()
        return rec, t1 - t0, t2 - t1

    def drive(self, dev, batches: int, stats) -> dict:
        """The run on the card; returns its rates and harvest times."""
        from inspektor_gadget_tpu_torch.ops import sketches as S, window as W
        from inspektor_gadget_tpu_torch.sources import H2DStager, PinnedBufferPool
        from inspektor_gadget_tpu_torch.sources.bridge import SRC_SYNTH_EXEC, drain_synthetic
        b = self.batch
        bundle, wcms, whll = self._state(dev)
        pool = PinnedBufferPool(b, lanes=4, max_free=8, device=dev)
        stager = H2DStager(pool, depth=4, device=dev, stats=stats)
        timed = {"dev": 0.0, "host": 0.0}

        def on_batch(blk, fb) -> None:
            blk.numpy()[:, fb.count:] = 0  # the operator zeroes the pad: keys, weights, values 0
            self.counts.append(fb.count)
            k, w, v = stager.stage(blk, (blk[0], blk[1], blk[3]))
            _, fence = S.bundle_ingest_step(bundle, k, k, k, w, values=v)
            W.wcms_ingest_step(wcms, k, w)
            W.hll_ingest_step(whll, k, w)
            if dev.type == "cuda":  # one event after all three steps fences the block
                fence = torch.cuda.Event()
                fence.record(torch.cuda.current_stream(dev))
            stager.fence(fence)
            if len(self.counts) % HARVEST_EVERY == 0:
                rec, d, h = self._harvest(bundle, wcms, whll, dev)
                self.harvests.append(rec)
                timed["dev"] += d
                timed["host"] += h

        try:
            src = drain_synthetic(SRC_SYNTH_EXEC, self.seed, self.vocab, batches * b,
                                  pool.get, on_batch, release=pool.put)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            e2e_s = time.perf_counter() - src["started"]
        finally:
            stager.drain()
        require(src["drops"] == 0, f"native capture dropped {src['drops']} events")
        consumed, dev_s, host_s = src["consumed"], timed["dev"], timed["host"]
        self.final = S.bundle_to_numpy(bundle)
        self.final_window = (wcms.slots.cpu().numpy(), whll.registers.cpu().numpy())
        n_h = max(1, len(self.harvests))
        return {"events": consumed, "batches": len(self.counts), "e2e_s": e2e_s,
                "e2e_ev_per_s": consumed / e2e_s,
                "ingest_ev_per_s": consumed / (e2e_s - dev_s - host_s),
                "source_ev_per_s": batches * b / src["source_s"],
                "full_batches": sum(c == b for c in self.counts),
                "harvests": len(self.harvests), "harvest_device_ms": dev_s / n_h * 1e3,
                "harvest_host_ms": host_s / n_h * 1e3,
                "decodes": [h["decode"] | {"keys": len(h["decode"]["keys"])}
                            for h in self.harvests]}

    def stream(self) -> np.ndarray:
        """The run's folded keys, rebuilt from the seed."""
        from inspektor_gadget_tpu_torch.sources.bridge import SRC_SYNTH_EXEC, synthetic_stream
        return synthetic_stream(SRC_SYNTH_EXEC, self.seed, self.vocab, sum(self.counts))[0]

    def fold_cpu(self) -> tuple[list[dict], list[np.ndarray], tuple, np.ndarray]:
        """The same stream folded on the CPU -> (harvest records, final
        bundle leaves, final window leaves, the keys)."""
        from inspektor_gadget_tpu_torch.ops import sketches as S, window as W
        cpu = torch.device("cpu")
        keys = self.stream()
        bundle, wcms, whll = self._state(cpu)
        out, off = [], 0
        blk = np.zeros((3, self.batch), np.uint32)  # keys, weights, values (0: exec events)
        for i, c in enumerate(self.counts):
            blk[:] = 0
            blk[0, :c] = keys[off:off + c]
            blk[1, :c] = 1
            off += c
            k, w, v = (torch.from_numpy(blk[j].view(np.int32)) for j in range(3))
            S.bundle_ingest_step(bundle, k, k, k, w, values=v)
            W.wcms_ingest_step(wcms, k, w)
            W.hll_ingest_step(whll, k, w)
            if (i + 1) % HARVEST_EVERY == 0:
                out.append(self._harvest(bundle, wcms, whll, cpu)[0])
        return (out, S.bundle_to_numpy(bundle),
                (wcms.slots.numpy().copy(), whll.registers.numpy().copy()), keys)


# the card's and the CPU's seq scorer after the same steps: largest gap of
# a leaf over that leaf's largest magnitude (sound runs on an H100 read at
# most 0.0215, the embedding; the weight matrices 0.006-0.009)
SCORER_RTOL = 0.05


class OperatorRun:
    """The port's `TpuSketchInstance` driven as a gadget run drives the
    reference operator, through its own entry points. Feed (a): a
    NativeCapture of the synthetic exec source popped into the instance's
    pinned blocks (``folded_block`` → ``pop_folded(with_values=True)`` →
    ``ingest_folded``), `batches` full batches' worth at vocab `vocab`,
    with an explicit ``harvest()`` every HARVEST_EVERY batches and one at
    the end. Feed (b): OP_EVENT_BATCHES seeded `EventBatch`es whose
    heavy-hitter (key_hash), distinct (pid) and distribution (aux2)
    columns differ, with mntns, kind and a latency in aux1, through
    ``enrich_batch``, harvested after the 4th and at teardown
    (``post_gadget_run``, which also writes the checkpoint). Every
    harvest seals a window into the run's window sink. `replay` feeds
    the same streams, feed (a) rebuilt from the seed at the same batch
    boundaries, to an instance on another device."""

    def __init__(self, seed: int, vocab: int, batch: int, geometry: dict) -> None:
        self.seed, self.vocab, self.batch = seed, vocab, batch
        self.config = operator_config(geometry)
        self.counts: list[int] = []

    def _instance(self, device):
        from inspektor_gadget_tpu_torch.operators import (SketchConfig, SketchContext,
                                                          TpuSketchInstance)
        clock = iter(range(1, 1 << 30))
        rec = {"windows": [], "summaries": [], "harvest_ms": []}
        ctx = SketchContext(gadget="trace/exec", run_id=f"chip-smoke-{self.seed}", node="node-0",
                            batch_size=self.batch, history_clock=lambda: 1.7e9 + next(clock),
                            window_sink=lambda h, p: rec["windows"].append((h, p)),
                            on_sketch_summary=rec["summaries"].append)
        return TpuSketchInstance(SketchConfig(**self.config), ctx, device=device), rec

    def event_batches(self) -> list:
        return operator_event_batches(self.seed + 1, self.batch)

    def _harvest(self, inst, rec) -> None:
        inst.harvest()
        rec["harvest_ms"].append(dict(inst.last_harvest_ms))

    def _ingest(self, inst, rec, fb) -> None:
        """Feed (a)'s step: one batch, and a harvest every HARVEST_EVERY."""
        inst.ingest_folded(fb)
        self.counts.append(fb.count)
        if len(self.counts) % HARVEST_EVERY == 0:
            self._harvest(inst, rec)

    def _feed_events(self, inst, rec, batches, ckpt_dir: Path) -> None:
        from inspektor_gadget_tpu_torch.operators import set_checkpoint_dir
        for i, b in enumerate(batches):
            inst.enrich_batch(b)
            if i + 1 == OP_EVENT_BATCHES // 2:
                self._harvest(inst, rec)
        set_checkpoint_dir(ckpt_dir)
        try:
            inst.post_gadget_run()  # the final harvest and window, then the checkpoint
        finally:
            set_checkpoint_dir(None)
        rec["harvest_ms"].append(dict(inst.last_harvest_ms))

    def drive(self, dev, batches: int, ckpt_dir: Path) -> tuple[dict, dict]:
        """The run on `dev` -> (its record, its rates and harvest times)."""
        from inspektor_gadget_tpu_torch.sources.bridge import SRC_SYNTH_EXEC, drain_synthetic
        inst, rec = self._instance(dev)
        events = self.event_batches()
        src = drain_synthetic(SRC_SYNTH_EXEC, self.seed, self.vocab, batches * self.batch,
                              inst.folded_block, lambda _blk, fb: self._ingest(inst, rec, fb))
        if len(self.counts) % HARVEST_EVERY:
            self._harvest(inst, rec)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        folded_s = time.perf_counter() - src["started"]
        h_s = sum(h["total"] for h in rec["harvest_ms"]) / 1e3
        consumed = src["consumed"]
        require(src["drops"] == 0 and src["produced"] == consumed,
                f"native capture: {src['drops']} dropped, {src['produced']} made, "
                f"{consumed} ingested")
        n_ev = sum(b.count for b in events)
        t0 = time.perf_counter()
        self._feed_events(inst, rec, events, ckpt_dir)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        events_s = time.perf_counter() - t0
        rec["scorer"] = inst.scorer
        info = {"folded_events": consumed, "folded_batches": len(self.counts),
                "full_batches": sum(c == self.batch for c in self.counts),
                "folded_e2e_ev_per_s": consumed / folded_s,
                "folded_ingest_ev_per_s": consumed / max(folded_s - h_s, 1e-9),
                "event_batch_events": n_ev, "event_batch_e2e_ev_per_s": n_ev / events_s,
                "harvests": len(rec["summaries"]), "windows": len(rec["windows"]),
                "harvest_ms": rec["harvest_ms"]}
        return rec, info

    def replay(self, dev, ckpt_dir: Path) -> dict:
        """The same two feeds on `dev`, feed (a) rebuilt from the seed."""
        from inspektor_gadget_tpu_torch.sources.batch import FoldedBatch
        from inspektor_gadget_tpu_torch.sources.bridge import SRC_SYNTH_EXEC, synthetic_stream
        counts, self.counts = self.counts, []
        keys, mntns = synthetic_stream(SRC_SYNTH_EXEC, self.seed, self.vocab, sum(counts))
        self.keys = keys
        inst, rec = self._instance(dev)
        off = 0
        for c in counts:
            blk = inst.folded_block()
            arr = blk.numpy()
            arr[:4] = 0
            arr[0, :c], arr[1, :c], arr[2, :c] = keys[off:off + c], 1, mntns[off:off + c]
            off += c
            self._ingest(inst, rec, FoldedBatch(lanes=arr, count=c, has_values=True, block=blk))
        if len(self.counts) % HARVEST_EVERY:
            self._harvest(inst, rec)
        require(self.counts == counts, "replay: batch boundaries differ")
        self._feed_events(inst, rec, self.event_batches(), ckpt_dir)
        return rec


def _same(got, want, rtol: float, what: str) -> None:
    """Recursive equality: floats to `rtol`, everything else exactly."""
    if isinstance(want, dict):
        require(isinstance(got, dict) and list(got) == list(want), f"{what}: keys differ")
        for k in want:
            _same(got[k], want[k], rtol, f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        require(len(got) == len(want), f"{what}: {len(got)} != {len(want)} items")
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, rtol, f"{what}[{i}]")
    elif isinstance(want, float):
        require(bool(np.isclose(got, want, rtol=rtol, atol=1e-7)), f"{what}: {got} != {want}")
    else:
        require(got == want, f"{what}: {got!r} != {want!r}")


def compare_operator_runs(got: dict, want: dict, got_dir: Path, want_dir: Path) -> dict:
    """Hold one operator run to another: every summary field but
    `pipeline` (the HLL and entropy estimates and what derives from them
    to rtol 1e-5 and 1e-4, anomaly scores to 0.05 nats, the rest
    exactly), every sealed window's header, digest and payload arrays
    (dtype and value; the npz's zip entries carry each run's wall clock),
    and the checkpoint's bundle and class leaves exactly. The scorer's
    leaves (bf16 steps on two devices) are held leaf by leaf to
    SCORER_RTOL of the leaf's largest magnitude, its integer leaves
    exactly; the seq key bias, which moves by rounding noise, to Adam's
    step bound instead. Returns the largest gaps."""
    import io
    from inspektor_gadget_tpu_torch.models import scorer_leaf_names
    from inspektor_gadget_tpu_torch.utils.checkpoint import load_pytree
    gs, ws = got["summaries"], want["summaries"]
    require(len(gs) == len(ws) > 0, f"{len(gs)} harvests against {len(ws)}")
    worst = {"anomaly_nats": 0.0, "scorer_leaf_rel": 0.0, "scorer_leaf_rel_by_leaf": {}}
    for i, (g, w) in enumerate(zip(gs, ws)):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        for key in ("distinct", "entropy_bits"):
            _same(g.pop(key), w.pop(key), 1e-5, f"harvest {i} {key}")
        _same(g.pop("accuracy"), w.pop("accuracy"), 1e-4, f"harvest {i} accuracy")
        ga, wa = g.pop("anomaly"), w.pop("anomaly")
        require((ga is None) == (wa is None) and list(ga or {}) == list(wa or {}),
                f"harvest {i}: scored containers differ")
        if wa:
            gap = max(abs(ga[k] - wa[k]) for k in wa)
            require(gap <= 0.05, f"harvest {i}: seq scores differ by {gap} nats")
            worst["anomaly_nats"] = max(worst["anomaly_nats"], gap)
        g.pop("pipeline"), w.pop("pipeline")
        _same(g, w, 0.0, f"harvest {i}")
    require(len(got["windows"]) == len(want["windows"]) > 0, "sealed window count differs")
    for i, ((gh, gp), (wh, wp)) in enumerate(zip(got["windows"], want["windows"])):
        require(gh == wh, f"window {i}: header differs")
        with np.load(io.BytesIO(gp)) as a, np.load(io.BytesIO(wp)) as b:
            require(a.files == b.files, f"window {i}: payload arrays differ")
            for name in b.files:
                require(a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]),
                        f"window {i}: payload array {name} differs")
    scorer = got["scorer"]
    names = scorer_leaf_names(scorer)
    d, key_bound = scorer.config.d_model, 2 * scorer.config.lr * scorer.steps
    for stem in ("trace-exec", "trace-exec-invclasses", "trace-exec-scorer"):
        gl, wl = load_pytree(got_dir / stem), load_pytree(want_dir / stem)
        require(len(gl) == len(wl), f"checkpoint {stem}: leaf count differs")
        for j, (x, y) in enumerate(zip(gl, wl)):
            require(x.dtype == y.dtype and x.shape == y.shape, f"checkpoint {stem} leaf {j}")
            if not (stem.endswith("scorer") and x.dtype.kind == "f"):
                require(np.array_equal(x, y), f"checkpoint {stem} leaf {j} differs")
                continue
            x, y = x.astype(np.float64), y.astype(np.float64)
            if names[j].endswith("qkv.b") and not names[j].startswith(("mu.", "nu.")):
                # tests/test_torch_seqmodel.py: the key bias moves by rounding noise
                kb = max(np.abs(x[d:2 * d]).max(), np.abs(y[d:2 * d]).max())
                require(kb <= key_bound, f"scorer {names[j]}: key bias {kb} > {key_bound}")
                x, y = np.delete(x, np.s_[d:2 * d]), np.delete(y, np.s_[d:2 * d])
            gap, scale = np.abs(x - y).max(initial=0.0), np.abs(y).max(initial=0.0)
            rel = gap / scale if scale else (0.0 if gap == 0 else float("inf"))
            worst["scorer_leaf_rel_by_leaf"][names[j]] = rel
            worst["scorer_leaf_rel"] = max(worst["scorer_leaf_rel"], rel)
    by_leaf = worst["scorer_leaf_rel_by_leaf"]
    log("[operator] scorer leaves, largest gap over the leaf's scale, worst 8 of "
        f"{len(by_leaf)}: " + ", ".join(f"{k} {by_leaf[k]:.3g}" for k in sorted(
            by_leaf, key=lambda k: -by_leaf[k])[:8]))
    for name, rel in by_leaf.items():
        require(rel <= SCORER_RTOL, f"scorer {name}: {rel:.3g} of the leaf's scale apart "
                                    f"(bound {SCORER_RTOL})")
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2

    from inspektor_gadget_tpu_torch import models as M
    from inspektor_gadget_tpu_torch.device import device_report, time_cuda
    from inspektor_gadget_tpu_torch.native import build_all
    from inspektor_gadget_tpu_torch.ops import kernels as K
    from inspektor_gadget_tpu_torch.parallel import flash_attention as FA
    from inspektor_gadget_tpu_torch.ops import sketches as S
    from inspektor_gadget_tpu_torch.ops.hashing import _row_multiplier, hashed_bucket
    from inspektor_gadget_tpu_torch.sources import H2DStager, PinnedBufferPool, ZipfFoldedSource
    from inspektor_gadget_tpu_torch.sources import bridge
    from inspektor_gadget_tpu_torch.sources.synthetic import DISTINCT, HH, LANES, VALUES, WEIGHTS

    batch, prod = S.PRODUCTION_BATCH, S.PRODUCTION_GEOMETRY
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report: dict = {}

    # -- 1. device -------------------------------------------------------------
    rep = device_report(dev)
    log(f"[device] {rep['nvidia_smi']}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{rep['kind']} x{rep['count']}")
    report["device"] = rep

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    build_all([K.LIBRARY, FA.LIBRARY, bridge.LIBRARY])
    build_s = time.perf_counter() - t0
    for lib in (K.LIBRARY, FA.LIBRARY):
        log(f"[build] {lib.path.name} (nvcc {lib.build_seconds:.1f} s)")
        for line in lib.build_log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")
    log(f"[build] {bridge.LIBRARY.path.name} (g++ {bridge.LIBRARY.build_seconds:.1f} s)")
    log(f"[build] all three in {build_s:.1f} s")
    report["build_s"] = build_s
    hmma = hmma_count(FA.LIBRARY.path)
    log(f"[build] {FA.LIBRARY.path.name}: {hmma} HMMA instructions in its SASS")
    require(hmma > 0, "K3's bfloat16 kernel has no tensor-core instruction")
    report["k3_hmma"] = hmma

    src = ZipfFoldedSource(args.seed + 1)
    host = src.generate(batch, valid=batch - 4321)
    host[WEIGHTS, ::7] *= 3
    host[WEIGHTS, ::13] = 0
    g = (1 + prod["quantile_alpha"]) / (1 - prod["quantile_alpha"])
    rng = np.random.default_rng(args.seed)
    edge = np.floor(g ** rng.integers(0, 1100, batch // 2)) + rng.integers(-1, 2, batch // 2)
    host[VALUES, : batch // 2] = np.clip(edge, 0, 2**32 - 1).astype(np.uint32)
    lanes = torch.from_numpy(host.view(np.int32)).to(dev)
    hh, distinct, dist, w, values = (lanes[j] for j in range(LANES))
    errs = {"K1": 0, "K2": 0, "K3": 0.0}

    def stress_lanes(n: int, kind: str) -> torch.Tensor:
        """A (5, n) batch on the card whose lanes are rows of one tensor
        (for odd n, rows 1-4 start off 16 bytes): the zipf stream, one
        hot key in every row, or weights near 2**31 that wrap."""
        blk = ZipfFoldedSource(args.seed + 7).generate(n, valid=n - n // 9)
        if kind == "hot key":
            blk[HH] = blk[2] = blk[HH, 0]
            blk[DISTINCT] = blk[DISTINCT, 0]
        elif kind == "weights near 2**31":
            blk[WEIGHTS] = rng.choice(np.array([2**31 - 1, 2**31, 2**31 - 3, 1], np.uint32), n)
        return torch.from_numpy(blk.view(np.int32)).to(dev)

    stress = [(f"{kind}, n {n}", n, kind) for n, kind in (
        (batch, "hot key"), (batch, "weights near 2**31"), (100003, "zipf"), (33, "zipf"),
        (100003, "hot key"))]

    # -- 3. K1 against its plain version --------------------------------------
    mult = int(_row_multiplier(0))
    k1_cases = [(f"log2 width {lw}", lw, lanes) for lw in (12, 16)]
    k1_cases += [(f"log2 width {lw}, {name}", lw, stress_lanes(n, kind))
                 for lw in (12, 16, 17) for name, n, kind in stress]
    for name, lw, t in k1_cases:
        got = K.histogram(t[2], t[WEIGHTS], log2_width=lw, mult=mult, salt=0)
        want = K.histogram_plain(t[2], t[WEIGHTS], log2_width=lw, mult=mult, salt=0)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs["K1"] = max(errs["K1"], err)
        require(torch.equal(got, want), f"K1 at {name}: max abs err {err}")
        log(f"[K1] {name}: equal to the plain version ({int(got.sum())} weight)")

    # -- 4. K2 against its plain version --------------------------------------
    full = S.bundle_init(**prod, device=dev).geometry()
    no_inv = dict(inv_rows=0, inv_log2_buckets=0)
    plane_sets = {"base": dataclasses.replace(full, qt_buckets=0, **no_inv),
                  "+invertible": dataclasses.replace(full, qt_buckets=0),
                  "+quantiles": dataclasses.replace(full, **no_inv), "both": full}
    k2_cases = [(name, geom, lanes) for name, geom in plane_sets.items()]
    k2_cases += [(name, full, stress_lanes(n, kind)) for name, n, kind in stress]
    k2_cases += [(f"count-min log2 width {lw}", dataclasses.replace(full, log2_width=lw), lanes)
                 for lw in (18, 20)]
    k2_cases.append(("HLL p 16", dataclasses.replace(full, hll_p=16), lanes))
    for name, geom, t in k2_cases:
        got = K.fused_planes(t[HH], t[DISTINCT], t[2], t[WEIGHTS], t[VALUES], geom)
        want = K.fused_planes_plain(t[HH], t[DISTINCT], t[2], t[WEIGHTS], t[VALUES], geom)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs["K2"] = max(errs["K2"], err)
        require(torch.equal(got, want), f"K2 {name}: max abs err {err}")
        log(f"[K2] {name}: {len(geom.planes)} planes, {geom.total} buckets, n {t.shape[1]}, "
            f"equal to the plain version")

    # the launch plans of the main paths' shapes
    ent_plane = K.Plane(K.HIST64, K.LANE_HH, mult, 0, prod["entropy_log2_width"],
                        1 << prod["entropy_log2_width"], 0)
    report["plans"] = {}
    for name, planes in (("K1", (ent_plane,)), ("K2", full.planes)):
        plan = K.launch_plan(planes, batch, K.sm_count(dev))
        info = dict(plan.summary(), blocks_per_sm=K.plan_occupancy(plan))
        report["plans"][name] = info
        log(f"[plan] {name} at batch {batch}: {info}")
        require(info["blocks"] >= K.sm_count(dev) and info["blocks_per_sm"] >= 1,
                f"{name}'s production plan leaves SMs idle: {info}")

    # -- 5. the main path --------------------------------------------------------
    warm, steps = 4, 64
    total_steps = warm + steps
    bundle = S.bundle_init(**prod, device=dev)
    pool = PinnedBufferPool(batch, lanes=LANES, max_free=8, device=dev)
    stager = H2DStager(pool, depth=4, device=dev)
    q: queue.Queue = queue.Queue(maxsize=4)
    stop = threading.Event()
    producer_error: list[Exception] = []

    def producer() -> None:
        try:
            psrc = ZipfFoldedSource(args.seed)
            i = 0
            while not stop.is_set():
                blk = pool.get()
                fill_block(psrc, blk.numpy(), i)
                i += 1
                while not stop.is_set():
                    try:
                        q.put(blk, timeout=0.05)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # reported by the consumer below
            producer_error.append(e)

    def reset_launches() -> None:
        K.histogram.launches = 0
        K.fused_planes.launches = 0
        FA.flash_attention.launches = 0

    def read_launches() -> dict[str, int]:
        torch.cuda.synchronize()
        return {"K1": K.histogram.launches, "K2": K.fused_planes.launches,
                "K3": FA.flash_attention.launches}

    # path 1, staged ingest: pool -> stager -> bundle_ingest_step (K2)
    reset_launches()
    producer_thread = threading.Thread(target=producer, daemon=True)
    producer_thread.start()
    t_start = None
    for i in range(total_steps):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        blk = q.get(timeout=60)
        staged = stager.stage(blk, tuple(blk[j] for j in range(LANES)))
        bundle, fence = S.bundle_ingest_step(bundle, staged[HH], staged[DISTINCT],
                                             staged[2], staged[WEIGHTS], values=staged[VALUES])
        stager.fence(fence)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t_start
    ingest_launches = read_launches()
    stop.set()
    producer_thread.join(timeout=10)
    require(not producer_thread.is_alive() and not producer_error, f"producer: {producer_error}")
    stager.drain()
    e2e_ev_s = steps * batch / e2e_s
    log(f"[main] ingest: {total_steps} batches x {batch} events staged and ingested; "
        f"launches K2={ingest_launches['K2']} K1={ingest_launches['K1']}")
    require(ingest_launches == {"K1": 0, "K2": total_steps, "K3": 0},
            f"ingest launched {ingest_launches}, expected K2 once a step and no K1")

    def plain_fold(device, on_block=None):
        """The same stream folded by the plain composition `bundle_update`."""
        out = S.bundle_init(**prod, device=device)
        rsrc = ZipfFoldedSource(args.seed)
        blk = np.empty((LANES, batch), np.uint32)
        for i in range(total_steps):
            fill_block(rsrc, blk, i)
            t = torch.from_numpy(blk.view(np.int32)).to(device)
            S.bundle_update(out, t[HH], t[DISTINCT], t[2], t[WEIGHTS], values=t[VALUES])
            if on_block is not None:
                on_block(blk)
        return out

    # path 2, the plain composition on the card: its entropy update is K1
    reset_launches()
    composed = plain_fold(dev)
    compose_launches = read_launches()
    log(f"[main] plain composition on the card: launches K1={compose_launches['K1']} "
        f"K2={compose_launches['K2']}")
    require(compose_launches == {"K1": total_steps, "K2": 0, "K3": 0},
            f"bundle_update launched {compose_launches}, expected K1 once a step and no K2")
    launches = {"K1": compose_launches["K1"], "K2": ingest_launches["K2"]}

    # the reference: the same fold on the CPU, where every wrapper takes its
    # plain version, so no kernel enters the comparison
    exact_hh, exact_distinct, weight_sum = [], [], 0

    def tally(blk: np.ndarray) -> None:
        nonlocal weight_sum
        exact_hh.append(np.repeat(blk[HH], blk[WEIGHTS]))
        exact_distinct.append(blk[DISTINCT][blk[WEIGHTS] != 0])
        weight_sum += int(blk[WEIGHTS].sum(dtype=np.int64))

    reset_launches()
    t0 = time.perf_counter()
    reference = plain_fold(torch.device("cpu"), tally)
    log(f"[main] reference fold on the CPU in {time.perf_counter() - t0:.1f} s")
    require(read_launches() == {"K1": 0, "K2": 0, "K3": 0},
            "the CPU reference launched a kernel")
    ref_leaves = S.bundle_to_numpy(reference)
    for name, b in (("ingested", bundle), ("composed", composed)):
        for i, (x, y) in enumerate(zip(S.bundle_to_numpy(b), ref_leaves)):
            require(x.dtype == y.dtype and np.array_equal(x, y),
                    f"{name} bundle vs the CPU reference: leaf {i} differs")
    log("[main] the ingested and the composed bundle each equal the CPU reference, leaf by leaf")

    events, drops, distinct_est, ent_bits, overflow, keys, counts = S.decode_digest(
        S.bundle_digest(bundle))
    require(events == float(weight_sum), f"events {events} != {weight_sum}")
    exact_keys, exact_counts = np.unique(np.concatenate(exact_hh), return_counts=True)
    order = np.argsort(-exact_counts, kind="stable")[:10]
    found = dict(zip(keys.tolist(), counts.tolist()))
    for kk, cc in zip(exact_keys[order], exact_counts[order]):
        require(found.get(int(kk), -1) >= cc, f"heavy hitter {kk:#010x}: "
                f"{found.get(int(kk))} < exact {cc}")
    require(int(keys[0]) == int(exact_keys[order[0]]), "top heavy hitter differs")
    true_distinct = np.unique(np.concatenate(exact_distinct)).size
    require(abs(distinct_est - true_distinct) / true_distinct < 0.05,
            f"HLL {distinct_est} vs exact {true_distinct}")
    require(all(np.isfinite([events, distinct_est, ent_bits])), "non-finite digest")
    log(f"[main] events {events:.0f}, distinct ~{distinct_est:.0f} (exact {true_distinct}), "
        f"entropy {ent_bits:.4f} bits, candidate overflow {overflow}")
    log("[main] heavy hitters (key, count, exact): " + ", ".join(
        f"{int(k):#010x}:{int(c)}:{found_exact}" for k, c, found_exact in zip(
            keys[:8], counts[:8],
            [int(exact_counts[exact_keys == k][0]) if (exact_keys == k).any() else 0
             for k in keys[:8]])))

    # device-only rate: pre-staged device batches, the same step
    dbundle = S.bundle_init(**prod, device=dev)
    dsrc = ZipfFoldedSource(args.seed + 2)
    pre = [torch.from_numpy(dsrc.generate(batch).view(np.int32)).to(dev) for _ in range(8)]
    for i in range(warm):
        S.bundle_ingest_step(dbundle, pre[i][HH], pre[i][DISTINCT], pre[i][2],
                             pre[i][WEIGHTS], values=pre[i][VALUES])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        p = pre[i % 8]
        S.bundle_ingest_step(dbundle, p[HH], p[DISTINCT], p[2], p[WEIGHTS], values=p[VALUES])
    torch.cuda.synchronize()
    device_ev_s = steps * batch / (time.perf_counter() - t0)
    log(f"[main] end-to-end {e2e_ev_s:.0f} events/s over {steps} batches "
        f"(pool hits {pool.hits}, misses {pool.misses}); device-only {device_ev_s:.0f} events/s")

    # -- 5b. the capture leg: NativeCapture -> pool -> stager -> K2 + window
    # steps -> harvest, at a vocabulary under the decode's capacity and over it
    from inspektor_gadget_tpu_torch.telemetry import REGISTRY, PipelineStats

    def pool_counts() -> tuple[float, float]:
        return tuple(REGISTRY.counter(f"ig_ingest_pool_{x}_total", labels=("lane",))
                     .labels(lane="0").value for x in ("hits", "misses"))

    capture: dict = {"native_build_s": bridge.LIBRARY.build_seconds}
    for label, vocab in (("under capacity", 2000), ("over capacity", 20000)):
        run = CaptureRun(args.seed + 11, vocab, batch, prod)
        stats = PipelineStats(f"chip-smoke-{vocab}")
        hits0, misses0 = pool_counts()
        reset_launches()
        info = run.drive(dev, CAPTURE_BATCHES, stats)
        launched = read_launches()
        require(launched == {"K1": 0, "K2": info["batches"], "K3": 0},
                f"capture run ({label}) launched {launched}, expected K2 once a batch")
        launches["K2"] += launched["K2"]
        hits1, misses1 = pool_counts()
        info.update(vocab=vocab, launches=launched, starved=stats.starved,
                    saturated=stats.saturated, stall_s=stats.stall_s,
                    pool_hits=hits1 - hits0, pool_misses=misses1 - misses0)
        log(f"[capture] {label}: vocab {vocab}, {info['events']} events in {info['batches']} "
            f"batches ({info['full_batches']} full), {info['harvests']} harvests; launches "
            f"{launched}; drops 0")
        log(f"[capture] {label}: end-to-end {info['e2e_ev_per_s']:.0f} events/s with harvests, "
            f"{info['ingest_ev_per_s']:.0f} without; native source "
            f"{info['source_ev_per_s'] or 0:.0f} events/s (phase 5's Python source end to end: "
            f"{e2e_ev_s:.0f})")
        log(f"[capture] {label}: stager ticks starved {stats.starved}, saturated "
            f"{stats.saturated} (stall {stats.stall_s * 1e3:.2f} ms); pool hits "
            f"{info['pool_hits']:.0f}, misses {info['pool_misses']:.0f} (registry)")
        dec = info["decodes"][-1]
        log(f"[capture] {label}: harvest device loop {info['harvest_device_ms']:.2f} ms, host "
            f"finisher {info['harvest_host_ms']:.2f} ms a harvest; last decode recovered "
            f"{dec['recovered']} keys, complete {dec['complete']}, {dec['sweeps']} host "
            f"sweeps, residual {dec['residual_events']} events")
        t0 = time.perf_counter()
        cpu_harvests, cpu_final, cpu_window, keys = run.fold_cpu()
        info["cpu_fold_s"] = time.perf_counter() - t0
        require(len(cpu_harvests) == len(run.harvests) == info["batches"] // HARVEST_EVERY,
                f"capture run ({label}): {len(run.harvests)} harvests")
        for h, (got, want) in enumerate(zip(run.harvests, cpu_harvests)):
            # the digest's integer words (events, drops, overflow, top-k) bit
            # for bit; its distinct and entropy estimates are float32 sums of
            # logs taken in another order on each device: rtol 1e-5
            gd, wd = got["digest"].view(np.uint32), want["digest"].view(np.uint32)
            ints = np.r_[[0, 1, 4], np.arange(5, wd.size)]
            require(gd.shape == wd.shape and np.array_equal(gd[ints], wd[ints])
                    and np.allclose(gd[2:4].view(np.float32), wd[2:4].view(np.float32),
                                    rtol=1e-5, atol=0),
                    f"capture run ({label}), harvest {h}: digest differs from the CPU fold")
            for field in ("buffer", "residual", "wcms", "whll"):
                g, w_ = (got[field], want[field]) if field in ("buffer", "residual") else \
                    ([got[field]], [want[field]])
                require(all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(g, w_)),
                        f"capture run ({label}), harvest {h}: {field} differs from the CPU fold")
            require(got["decode"] == want["decode"] and got["n"] == want["n"]
                    and got["epoch"] == want["epoch"],
                    f"capture run ({label}), harvest {h}: InvDecode differs from the CPU fold")
        for i, (x, y) in enumerate(zip(run.final, cpu_final)):
            require(x.dtype == y.dtype and np.array_equal(x, y),
                    f"capture run ({label}): bundle leaf {i} differs from the CPU fold")
        require(all(np.array_equal(x, y) for x, y in zip(run.final_window, cpu_window)),
                f"capture run ({label}): window leaves differ from the CPU fold")
        # the events the last harvest saw: every batch up to it
        seen = sum(run.counts[:HARVEST_EVERY * len(run.harvests)])
        uniq, cnt = np.unique(keys[:seen], return_counts=True)
        tally = dict(zip(uniq.tolist(), cnt.tolist()))
        last = run.harvests[-1]["decode"]
        require(all(tally.get(k) == c for k, c in last["keys"]),
                f"capture run ({label}): a decoded count differs from the exact tally")
        if label == "under capacity":
            require(last["complete"] and last["recovered"] == len(tally),
                    f"capture run ({label}): decode incomplete ({last['recovered']} of "
                    f"{len(tally)} keys)")
        info.update(distinct=len(tally), complete=last["complete"],
                    recovered=last["recovered"], residual_events=last["residual_events"])
        capture[label] = info
        log(f"[capture] {label}: every harvest's digest, decode buffer, residual and "
            f"InvDecode, the window leaves and the bundle equal the CPU fold of the stream "
            f"rebuilt from the seed ({info['cpu_fold_s']:.1f} s); the {last['recovered']} "
            f"decoded counts equal the exact tally of {len(tally)} keys")

    # device-only events/s of the step alone and with the two window steps
    # (pre-staged batches of the native stream, one call, back to back)
    nsrc = bridge.NativeCapture(bridge.SRC_SYNTH_EXEC, seed=args.seed + 12, vocab=2000)
    pre_k = [torch.from_numpy(nsrc.generate_folded(batch).view(np.int32)).to(dev)
             for _ in range(8)]
    t0 = time.perf_counter()
    nsrc.generate_folded(batch * 8)
    native_fill = batch * 8 / (time.perf_counter() - t0)
    nsrc.close()
    ones = torch.ones(batch, dtype=torch.int32, device=dev)
    zeros = torch.zeros(batch, dtype=torch.int32, device=dev)
    from inspektor_gadget_tpu_torch.ops import hll_init
    from inspektor_gadget_tpu_torch.ops import window as W
    rates = {}
    for name, windows in (("step", False), ("step + window steps", True),
                          ("step again", False)):
        dbundle = S.bundle_init(**prod, device=dev)
        wcms, whll = W.wcms_init(**WINDOW, device=dev), hll_init(prod["hll_p"], device=dev)
        for i in range(warm + steps):
            if i == warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            k = pre_k[i % 8]
            S.bundle_ingest_step(dbundle, k, k, k, ones, values=zeros)
            if windows:
                W.wcms_ingest_step(wcms, k, ones)
                W.hll_ingest_step(whll, k, ones)
        torch.cuda.synchronize()
        rates[name] = steps * batch / (time.perf_counter() - t0)
    capture.update(device_only=rates, native_generate_folded_ev_per_s=native_fill)
    log(f"[capture] device-only events/s: " + ", ".join(f"{k} {v:.0f}" for k, v in rates.items())
        + f"; native generate_folded fills {native_fill:.0f} events/s on one host thread")
    report["capture"] = capture

    # -- 5c. the operator: TpuSketchInstance through its entry points ------------
    ckpt_root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    op_run = OperatorRun(args.seed + 21, 2000, batch, prod)
    reset_launches()
    op_rec, op_info = op_run.drive(dev, CAPTURE_BATCHES, ckpt_root / "gpu")
    launched = read_launches()
    n_ingest = op_info["folded_batches"] + OP_EVENT_BATCHES
    require(launched == {"K1": 0, "K2": n_ingest, "K3": 0},
            f"operator run launched {launched}, expected K2 {n_ingest} (once an ingest)")
    launches["K2"] += launched["K2"]
    t0 = time.perf_counter()
    cpu_rec = op_run.replay(torch.device("cpu"), ckpt_root / "cpu")
    op_info["cpu_replay_s"] = time.perf_counter() - t0
    op_info.update(launches=launched, worst=compare_operator_runs(
        op_rec, cpu_rec, ckpt_root / "gpu", ckpt_root / "cpu"))
    n_a = -(-op_info["folded_batches"] // HARVEST_EVERY)  # harvests of feed (a)
    seen = sum(op_run.counts[:HARVEST_EVERY])
    uniq, cnt = np.unique(op_run.keys[:seen], return_counts=True)
    first = op_rec["summaries"][0]
    require(first.inv["complete"] and first.decoded == sorted(
        zip(uniq.tolist(), cnt.tolist()), key=lambda kv: (-kv[1], kv[0])),
            "operator: the first harvest's decode differs from the exact tally")
    for sm in op_rec["summaries"]:
        require(all(np.isfinite([sm.distinct, sm.entropy_bits])) and sm.events > 0
                and len(sm.heavy_hitters) == prod["k"] and set(sm.classes) == {"hot", "rest"},
                f"operator: harvest {sm.epoch} is malformed")
    require(op_rec["summaries"][-1].anomaly is not None
            and len(op_rec["summaries"][-1].anomaly) == OP_CONTAINERS
            and all(np.isfinite(list(op_rec["summaries"][-1].anomaly.values()))),
            "operator: the seq scorer did not score every container")
    hm = op_info["harvest_ms"]
    log(f"[operator] feed (a): {op_info['folded_events']} events in "
        f"{op_info['folded_batches']} batches ({op_info['full_batches']} full) through "
        f"folded_block -> pop_folded -> ingest_folded, {n_a} harvests; launches {launched}")
    log(f"[operator] feed (a): end-to-end {op_info['folded_e2e_ev_per_s']:.0f} events/s with "
        f"harvests and seals, {op_info['folded_ingest_ev_per_s']:.0f} without; phase 5b's "
        f"hand-driven path at vocab 2000 in this run: "
        f"{capture['under capacity']['e2e_ev_per_s']:.0f} with harvests, "
        f"{capture['under capacity']['ingest_ev_per_s']:.0f} without")
    log(f"[operator] feed (b): {op_info['event_batch_events']} events in {OP_EVENT_BATCHES} "
        f"EventBatches through enrich_batch, {op_info['event_batch_e2e_ev_per_s']:.0f} events/s "
        f"with 2 harvests, their seals and the checkpoint")
    for i, h in enumerate(hm):
        log(f"[operator] harvest {i + 1}: " + ", ".join(f"{k} {v:.2f}" for k, v in h.items())
            + " ms (digest + device decode, host finisher and reads, seq step, seal)")
    last = op_rec["summaries"][-1]
    log(f"[operator] last harvest: events {last.events}, drops {last.drops}, distinct "
        f"~{last.distinct:.0f}, inv {last.inv}, classes "
        f"{ {k: (v['recovered'], v['complete']) for k, v in last.classes.items()} }, "
        f"p99 {last.quantiles['p99']:.0f}, accuracy ratio {last.accuracy['ratio']:.3g}")
    log(f"[operator] {len(op_rec['summaries'])} summaries, {len(op_rec['windows'])} sealed "
        f"windows and the checkpoint equal the CPU instance's on the same streams "
        f"({op_info['cpu_replay_s']:.1f} s); seq scores within "
        f"{op_info['worst']['anomaly_nats']:.3g} nats, scorer leaves within "
        f"{op_info['worst']['scorer_leaf_rel']:.3g} of each leaf's scale; the first decode "
        f"equals the exact tally of "
        f"{len(uniq)} keys")
    report["operator"] = op_info

    # -- 6. K3 against its plain version ----------------------------------------
    # the plain versions' float32 matmuls run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    op_shape = (CONTAINERS, SEQ_WINDOW - 1, 4, 32)  # the operator's window, scored as T=255
    long_shape = (16, 4095, 4, 32)
    test_shapes = (  # tests/test_flash_attention.py
        ((2, 256, 4, 32), True), ((1, 200, 2, 16), False), ((2, 128, 1, 128), True),
        ((1, 384, 2, 64), True))
    k3_cases = [("operator window", op_shape, torch.bfloat16, True)]
    k3_cases += [(f"test shape {sh}", sh, dt, c) for dt in (torch.float32, torch.bfloat16)
                 for sh, c in test_shapes]
    k3_cases.append(("long window", long_shape, torch.bfloat16, True))
    report["k3_errors"] = []
    for name, shape, dtype, causal in k3_cases:
        q, k, v = k3_inputs(shape, dtype, gen, dev)
        got = FA.flash_attention(q, k, v, causal=causal)
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, mean_err, used = k3_err(got, want, v, causal, name)
        errs["K3"] = max(errs["K3"], err)
        report["k3_errors"].append([name, shape, str(dtype)[6:], causal, err, mean_err, used])
        log(f"[K3] {name} {shape} {str(dtype)[6:]} causal={causal}: max abs err {err:.3g}, "
            f"mean {mean_err:.3g}, {used:.3f} of the tolerance")
    gshape = (4, SEQ_WINDOW - 1, 4, 32)
    q, k, v = (x.detach().requires_grad_() for x in k3_inputs(gshape, torch.float32, gen, dev))
    g_out = torch.randn(gshape, generator=gen, device=dev)
    grads = torch.autograd.grad(FA.flash_attention(q, k, v), (q, k, v), g_out)
    plain_grads = torch.autograd.grad(FA.flash_attention_plain(q, k, v), (q, k, v), g_out)
    grad_err = max(float((a - b).abs().max()) for a, b in zip(grads, plain_grads))
    require(all(torch.allclose(a, b, rtol=2e-3, atol=2e-3) for a, b in zip(grads, plain_grads)),
            f"K3 gradients vs autograd through the plain version: max abs err {grad_err}")
    log(f"[K3] gradients {gshape} f32 vs autograd through the plain version: "
        f"max abs err {grad_err:.3g} (tolerance 2e-3)")

    # -- 7. the anomaly plane: harvest ticks of the three scorer families -------
    stream = ContainerStream(args.seed + 3, vocab=512, dim=4096, window=SEQ_WINDOW)
    data = [stream.tick() for _ in range(TICKS)]
    seq_cfg = M.SeqConfig(vocab=512)  # the operator's at entropy-log2-width 12 (tpusketch.py:622)
    families = {  # tpusketch.py:617, :625
        "ae": lambda d: M.ae_init(M.AEConfig(input_dim=4096, hidden_dim=256, latent_dim=64),
                                  seed=args.seed, device=d),
        "vae": lambda d: M.vae_init(M.VAEConfig(input_dim=4096, hidden_dim=256, latent_dim=64),
                                    seed=args.seed, device=d),
        "seq": lambda d: M.seq_init(seq_cfg, seed=args.seed, device=d),
    }
    mat, n_ready, count_mat = data[-1]
    log(f"[anomaly] {TICKS} ticks of {CONTAINERS * 64} events over {len(stream.counts)} "
        f"containers: seq matrix {mat.shape} with {n_ready} ready rows, "
        f"{int((mat[:n_ready] < 0).any(axis=1).sum())} of them short; counts {count_mat.shape}")
    ticks: dict = {}
    for fam, init in families.items():
        batches = [d[0] for d in data] if fam == "seq" else [d[2] for d in data]
        scorer = init(dev)
        noise_state = scorer.gen.get_state() if fam == "vae" else None
        reset_launches()
        losses, scores, secs = run_ticks(scorer, batches, "flash")
        launched = read_launches()
        want_k3 = seq_cfg.n_layers * 2 * TICKS if fam == "seq" else 0  # train forward + score
        require(launched == {"K1": 0, "K2": 0, "K3": want_k3},
                f"{fam} ticks launched {launched}, expected K3 {want_k3} and no K1, K2")
        for (m_i, r_i, c_i), sc in zip(data, scores):
            rows = m_i.shape[0] if fam == "seq" else c_i.shape[0]
            require(sc.shape == (rows,) and np.isfinite(sc).all(), f"{fam} scores {sc.shape}")
            if fam == "seq":
                require((sc[:r_i] > 0).all() and (sc[r_i:] == 0).all(),
                        "seq: ready rows score > 0, filler rows 0")
        noise = None
        if noise_state is not None:  # the CPU takes the card's draws
            replay = torch.Generator(device=dev)
            replay.set_state(noise_state)
            noise = [torch.randn(b.shape[0], 64, generator=replay, device=dev).cpu()
                     for b in batches]
        cpu_losses, cpu_scores, cpu_secs = run_ticks(init("cpu"), batches, "flash", noise)
        vs_cpu = max(float(np.abs(a - b).max()) for a, b in zip(scores, cpu_scores))
        rel_cpu = max(float((np.abs(a - b) / np.abs(b).clip(min=1e-6)).max())
                      for a, b in zip(scores, cpu_scores))
        entry = {"losses": losses, "cpu_losses": cpu_losses, "tick_s": secs,
                 "cpu_tick_s": cpu_secs, "launches": launched, "max_abs_vs_cpu": vs_cpu,
                 "max_rel_vs_cpu": rel_cpu, "first_scores": scores[0][:8].tolist(),
                 "last_scores": scores[-1][:8].tolist()}
        if fam == "seq":
            # bf16 activations, 8 AdamW steps: 0.05 nats (0.8% of ln 512) per container
            require(vs_cpu <= 0.05, f"seq scores, card vs CPU: max abs diff {vs_cpu}")
            reset_launches()
            _, full_scores, full_secs = run_ticks(init(dev), batches, "full")
            require(read_launches()["K3"] == 0, "attn='full' launched K3")
            vs_full = max(float(np.abs(a - b).max()) for a, b in zip(scores, full_scores))
            require(vs_full <= 0.05, f"seq scores, flash vs full on the card: max abs diff {vs_full}")
            entry.update(max_abs_vs_full=vs_full, full_tick_s=full_secs)
            log(f"[anomaly] seq: flash vs full on the card max abs diff {vs_full:.3g}, "
                f"card vs CPU {vs_cpu:.3g} (tolerance 0.05 nats)")
        else:
            # bf16 matmuls on two devices, 8 Adam steps: 5% of each score
            require(rel_cpu <= 5e-2, f"{fam} scores, card vs CPU: max rel diff {rel_cpu}")
            log(f"[anomaly] {fam}: card vs CPU max rel diff {rel_cpu:.3g} (tolerance 5e-2)")
        # the tick time: ticks 2-8 in all over 7 (the first is warm-up), so a
        # stall in any tick shows; the median only beside it
        entry["tick_ms"] = sum(secs[1:]) / (TICKS - 1) * 1e3
        entry["tick_ms_median"] = statistics.median(secs[1:]) * 1e3
        log(f"[anomaly] {fam}: loss {losses[0]:.5g} -> {losses[-1]:.5g}; tick "
            f"{entry['tick_ms']:.3f} ms over ticks 2-{TICKS} (median "
            f"{entry['tick_ms_median']:.3f}, first {secs[0] * 1e3:.2f}; CPU "
            f"{sum(cpu_secs[1:]) / (TICKS - 1) * 1e3:.1f} ms); launches {launched}")
        ticks[fam] = entry
    launches["K3"] = ticks["seq"]["launches"]["K3"]
    report["anomaly_ticks"] = ticks

    # -- per-kernel times at the main path's shapes -----------------------------
    geom = bundle.geometry()
    ent_lw = prod["entropy_log2_width"]
    mult0 = int(_row_multiplier(0))
    k1_ms = time_cuda(lambda: K.histogram(dist, w, log2_width=ent_lw, mult=mult0))
    k1_plain = time_cuda(lambda: K.histogram_plain(dist, w, log2_width=ent_lw, mult=mult0))
    idx = hashed_bucket(dist, mult0, 0, ent_lw)
    w_f = w.to(torch.float32)
    k1_lib = time_cuda(lambda: torch.bincount(idx, weights=w_f, minlength=1 << ent_lw))
    k2_ms = time_cuda(lambda: K.fused_planes(hh, distinct, dist, w, values, geom))
    k2_plain = time_cuda(lambda: K.fused_planes_plain(hh, distinct, dist, w, values, geom),
                         per_round=2, warm=2)
    # yardstick: one scatter_add_ of every additive plane's values at
    # precomputed flat indices (the hashes and the HLL max plane excluded)
    flat_idx, flat_val = [], []
    lane_t = (hh, distinct, dist, values)
    from inspektor_gadget_tpu_torch.ops.invertible import inv_lane_values
    from inspektor_gadget_tpu_torch.ops.quantiles import bucket_index
    inv_vals = inv_lane_values(hh, w)
    for pl in geom.planes:
        if pl.kind == K.HLL:
            continue
        if pl.kind == K.QUANT:
            ix = bucket_index(values, alpha=geom.qt_alpha, min_value=geom.qt_min_value,
                              n_buckets=geom.qt_buckets)
            val = w.to(torch.int64)
        else:
            ix = hashed_bucket(lane_t[pl.lane], pl.mult, pl.salt, pl.log2_width)
            val = (w.to(torch.int64) if pl.kind in (K.HIST, K.HIST64)
                   else inv_vals[pl.kind - K.INV_COUNT])
        flat_idx.append(ix + pl.offset)
        flat_val.append(val)
    flat_idx, flat_val = torch.cat(flat_idx), torch.cat(flat_val)
    k2_lib = time_cuda(lambda: torch.zeros(geom.total, dtype=torch.int64, device=dev)
                       .scatter_add_(0, flat_idx, flat_val))
    q, k, v = k3_inputs(op_shape, torch.bfloat16, gen, dev)
    k3_ms = time_cuda(lambda: FA.flash_attention(q, k, v))
    k3_plain = time_cuda(lambda: FA.flash_attention_plain(q, k, v), per_round=2, warm=2)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    k3_lib = time_cuda(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True))
    k3_bound_ms, k3_bound_by = k3_bound(op_shape, torch.bfloat16, True)
    q, k, v = k3_inputs(long_shape, torch.bfloat16, gen, dev)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    long_bound = k3_bound(long_shape, torch.bfloat16, True)
    report["k3_long_window"] = {
        "shape": long_shape, "ms": time_cuda(lambda: FA.flash_attention(q, k, v), per_round=2),
        "plain_ms": time_cuda(lambda: FA.flash_attention_plain(q, k, v), rounds=5, per_round=1,
                              warm=1),
        "library_ms": time_cuda(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                        is_causal=True)),
        "bound_ms": long_bound[0], "bound_by": long_bound[1]}
    log(f"[time] K3 long window {long_shape}: " + ", ".join(
        f"{key} {val:.4f}" if isinstance(val, float) else f"{key} {val}"
        for key, val in report["k3_long_window"].items()))
    k1_bytes = batch * 4 * 2 + (1 << ent_lw) * 8  # int64 counts out
    k2_bytes = batch * 4 * 5 + geom.total * 4
    kernels = [
        {"name": "K1 hashed histogram (entropy update)", "route": "cuda", "source": SRC,
         "replaces": "inspektor_gadget_tpu/ops/pallas_kernels.py:61",
         "launches": launches["K1"], "max_abs_err": errs["K1"], "ms": k1_ms,
         "plain_ms": k1_plain, "bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": k1_lib},
        {"name": "K2 fused sketch planes", "route": "cuda", "source": SRC,
         "replaces": "inspektor_gadget_tpu/ops/pallas_kernels.py:296",
         "launches": launches["K2"], "max_abs_err": errs["K2"], "ms": k2_ms,
         "plain_ms": k2_plain, "bound_ms": k2_bytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": k2_lib},
        {"name": "K3 flash attention (seq scorer, causal, operator window)", "route": "cuda",
         "source": K3_SRC, "replaces": "inspektor_gadget_tpu/parallel/flash_attention.py:86",
         "launches": launches["K3"], "max_abs_err": errs["K3"], "ms": k3_ms,
         "plain_ms": k3_plain, "bound_ms": k3_bound_ms, "bound_by": k3_bound_by,
         "library_ms": k3_lib},
    ]
    for kinfo in kernels:
        log(f"[time] {kinfo['name']}: {kinfo['ms']:.4f} ms, plain {kinfo['plain_ms']:.4f} ms, "
            f"bound {kinfo['bound_ms']:.5f} ms, library {kinfo['library_ms']:.4f} ms")
    report.update(kernels=kernels, e2e_ev_per_s=e2e_ev_s, device_ev_per_s=device_ev_s,
                  steps=total_steps, batch=batch, pool_hits=pool.hits,
                  pool_misses=pool.misses, heavy_hitters=[[int(k), int(c)] for k, c in
                                                          zip(keys[:16], counts[:16])],
                  distinct_estimate=distinct_est, distinct_exact=int(true_distinct),
                  max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))

    log(f"[device] {rep['nvidia_smi']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": rep["kind"],
                                             "count": rep["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
