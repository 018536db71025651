#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed S]

Builds the port's CUDA kernels from ``inspektor_gadget_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card at the main
path's shapes, then drives the main path: a seeded zipf stream (vocab
5000, s 1.2) of 2**17-event batches through the pinned pool, the H2D
stager and `bundle_ingest_step` at the production sketch geometry with
every plane on (count-min 4 x 2**16, HLL p 14, entropy 2**12, top-k 128,
invertible 3 x 2**12, DDSketch 2048 buckets). The same stream is also
folded by the plain composition `bundle_update` on the card, whose
entropy update is K1. Both bundles must equal, leaf by leaf, the same
fold on the CPU, where no kernel runs. The launch counts are set to 0
just before each of the two card runs and read just after it.

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
import statistics
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SRC = "inspektor_gadget_tpu_torch/csrc/sketch_kernels.cu"
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's ~2 GHz SM clock


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, rounds: int = 21, per_round: int = 10, warm: int = 3) -> float:
    """Device milliseconds per call of `fn`: the median over `rounds` of
    CUDA-event time across `per_round` back-to-back calls, divided by
    `per_round`. Each round first parks the stream in a 20 ms device
    sleep, so the host has queued every call before the first starts and
    the events time the device's work, not the host's launch pace (a
    call whose host side is slower than its device side is timed at the
    host's pace all the same)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(per_round):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_round)
    return statistics.median(times)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2

    from inspektor_gadget_tpu_torch.device import device_report
    from inspektor_gadget_tpu_torch.ops import kernels as K
    from inspektor_gadget_tpu_torch.ops import sketches as S
    from inspektor_gadget_tpu_torch.ops.hashing import _row_multiplier, hashed_bucket
    from inspektor_gadget_tpu_torch.sources import H2DStager, PinnedBufferPool, ZipfFoldedSource
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
    K.LIBRARY.get()
    build_s = time.perf_counter() - t0
    log(f"[build] {K.LIBRARY.path.name} in {build_s:.1f} s (nvcc {K.LIBRARY.build_seconds:.1f} s)")
    for line in K.LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    report["build_s"] = build_s

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
    errs = {"K1": 0, "K2": 0}

    # -- 3. K1 against its plain version --------------------------------------
    for lw in (12, 16):
        mult = int(_row_multiplier(0))
        got = K.histogram(dist, w, log2_width=lw, mult=mult, salt=0)
        want = K.histogram_plain(dist, w, log2_width=lw, mult=mult, salt=0)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs["K1"] = max(errs["K1"], err)
        require(torch.equal(got, want), f"K1 at log2 width {lw}: max abs err {err}")
        log(f"[K1] log2 width {lw}: equal to the plain version ({int(got.sum())} weight)")

    # -- 4. K2 against its plain version --------------------------------------
    full = S.bundle_init(**prod, device=dev).geometry()
    no_inv = dict(inv_rows=0, inv_log2_buckets=0)
    plane_sets = {"base": dataclasses.replace(full, qt_buckets=0, **no_inv),
                  "+invertible": dataclasses.replace(full, qt_buckets=0),
                  "+quantiles": dataclasses.replace(full, **no_inv), "both": full}
    for name, geom in plane_sets.items():
        got = K.fused_planes(hh, distinct, dist, w, values, geom)
        want = K.fused_planes_plain(hh, distinct, dist, w, values, geom)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs["K2"] = max(errs["K2"], err)
        require(torch.equal(got, want), f"K2 plane set {name}: max abs err {err}")
        log(f"[K2] {name}: {len(geom.planes)} planes, {geom.total} buckets, "
            f"equal to the plain version")

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

    def read_launches() -> dict[str, int]:
        torch.cuda.synchronize()
        return {"K1": K.histogram.launches, "K2": K.fused_planes.launches}

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
    require(ingest_launches == {"K1": 0, "K2": total_steps},
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
    require(compose_launches == {"K1": total_steps, "K2": 0},
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
    require(read_launches() == {"K1": 0, "K2": 0}, "the CPU reference launched a kernel")
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
            val = w.to(torch.int64) if pl.kind == K.HIST else inv_vals[pl.kind - K.INV_COUNT]
        flat_idx.append(ix + pl.offset)
        flat_val.append(val)
    flat_idx, flat_val = torch.cat(flat_idx), torch.cat(flat_val)
    k2_lib = time_cuda(lambda: torch.zeros(geom.total, dtype=torch.int64, device=dev)
                       .scatter_add_(0, flat_idx, flat_val))
    k1_bytes = batch * 4 * 2 + (1 << ent_lw) * 4
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
