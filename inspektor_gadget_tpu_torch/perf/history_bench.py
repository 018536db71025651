"""Tiered-history micro-bench → schema-valid PerfRecords (the port's
copy of ``inspektor_gadget_tpu/perf/history_bench.py``).

The lifecycle subsystem's cost model is two
claims — (1) compaction rewrites aged windows into super-windows at
store-bounded cost (windows/s compacted), and (2) query pushdown folds
node-side so the wire carries ONE merged window instead of every
sealed window (fold-at-node vs fetch-and-fold, windows/s + bytes on
the wire). This bench measures both against a synthetic store and
publishes one record per series (`history-compaction` / `compact`,
`history-pushdown` / `query_fold`) to the perf ledger, so a lifecycle
regression gates exactly like a speed regression via `bench compare`.

Host work only (numpy window algebra and the store's disk): the records
name the device the process acquired, as every bench module's do.

Run standalone (`python -m inspektor_gadget_tpu_torch.perf.history_bench
[--device cuda|cpu] [--ledger PATH] [--windows N]`) or from tests with a
tiny store.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np


def _build_store(tmp: str, n_windows: int, *, depth: int = 4,
                 width: int = 256, hll_m: int = 256, ent_w: int = 64,
                 t0: float = 1_000_000.0, span: float = 10.0):
    """A fresh store with n_windows sealed level-0 windows (sealed
    segment, ready to compact/query). Returns (store, store_dir)."""
    from ..history import HistoryStore, SealedWindow, window_digest
    rng = np.random.default_rng(7)
    store = HistoryStore()
    store.set_base_dir(tmp)
    writer = store.writer_for("bench-history", node="bench", base_dir=tmp)
    for i in range(n_windows):
        win = SealedWindow(
            gadget="bench/history", node="bench", run_id="bench",
            window=i + 1, start_ts=t0 + i * span,
            end_ts=t0 + (i + 1) * span, events=1000, drops=0,
            cms=rng.integers(0, 100, (depth, width)).astype(np.int32),
            hll=rng.integers(0, 6, hll_m).astype(np.int32),
            ent=rng.random(ent_w).astype(np.float32),
            topk_keys=rng.integers(1, 1 << 31, 16).astype(np.uint32),
            topk_counts=rng.integers(1, 1000, 16).astype(np.int64),
            slices={f"mntns:{i % 8}": {
                "events": 100, "hll": np.zeros(256, np.uint8),
                "ent": np.zeros(64, np.int64), "hh": [(int(i) + 1, 3)]}},
        )
        win.digest = window_digest(win)
        store.append_window(win, writer=writer)
    writer.rotate()
    import os
    return store, os.path.join(tmp, "bench--bench-history")


def measure_compaction(n_windows: int = 256) -> dict:
    """Windows/s folded into super-windows by one compaction pass."""
    from ..history import CompactionEngine
    tmp = tempfile.mkdtemp(prefix="ig-hist-bench-")
    try:
        _store, store_dir = _build_store(tmp, n_windows)
        engine = CompactionEngine(
            "10s@1m,120s@1h,1h@inf",
            clock=lambda: 1_000_000.0 + 10_000_000.0)
        t0 = time.perf_counter()
        stats = engine.compact_store(store_dir)
        seconds = max(time.perf_counter() - t0, 1e-9)
        return {
            "windows": n_windows,
            "seconds": seconds,
            "windows_per_s": stats["source_windows"] / seconds,
            "super_windows": stats["super_windows"],
            "bytes_reclaimed": stats["bytes_reclaimed"],
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def measure_pushdown(n_windows: int = 256) -> dict:
    """Fold-at-node (the QueryWindows body) vs fetch-and-fold (pack
    every frame, ship, unpack, fold client-side) over one store."""
    from ..history import (decode_frames, dedupe_compacted, encode_window,
                           level_counts, merge_windows, merged_to_sealed,
                           pack_frames, unpack_frames)
    tmp = tempfile.mkdtemp(prefix="ig-hist-bench-")
    try:
        store, _store_dir = _build_store(tmp, n_windows)

        # pushdown: prune+decode+dedupe+merge node-side, ONE window out
        t0 = time.perf_counter()
        frames = list(store.fetch_windows(base_dir=tmp,
                                          gadget="bench/history"))
        kept, _notes = dedupe_compacted(decode_frames(frames))
        merged = merge_windows(kept)
        sw = merged_to_sealed(merged, gadget="bench/history", node="bench",
                              level=max(level_counts(kept), default=0))
        push_wire = pack_frames([encode_window(sw)])
        push_s = max(time.perf_counter() - t0, 1e-9)

        # fetch-and-fold: the path before pushdown — every frame packed, shipped,
        # unpacked, decoded, folded client-side
        t0 = time.perf_counter()
        frames = list(store.fetch_windows(base_dir=tmp,
                                          gadget="bench/history"))
        fetch_wire = pack_frames(frames)
        got, _dropped = unpack_frames(fetch_wire)
        kept2, _notes = dedupe_compacted(decode_frames(got))
        merge_windows(kept2)
        fetch_s = max(time.perf_counter() - t0, 1e-9)

        return {
            "windows": n_windows,
            "pushdown_seconds": push_s,
            "pushdown_windows_per_s": n_windows / push_s,
            "pushdown_wire_bytes": len(push_wire),
            "fetch_seconds": fetch_s,
            "fetch_windows_per_s": n_windows / fetch_s,
            "fetch_wire_bytes": len(fetch_wire),
            "wire_ratio": len(fetch_wire) / max(len(push_wire), 1),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def compaction_record(stats: dict, provenance: dict) -> dict:
    from .schema import make_record
    return make_record(
        config="history-compaction", metric="compact", unit="windows/s",
        value=stats["windows_per_s"],
        stages={"compact": {"seconds": stats["seconds"],
                            "events": float(stats["windows"])}},
        provenance=provenance,
        extra={"windows": stats["windows"],
               "super_windows": stats["super_windows"],
               "bytes_reclaimed": stats["bytes_reclaimed"]})


def pushdown_record(stats: dict, provenance: dict) -> dict:
    from .schema import make_record
    return make_record(
        config="history-pushdown", metric="query_fold", unit="windows/s",
        value=stats["pushdown_windows_per_s"],
        stages={"pushdown": {"seconds": stats["pushdown_seconds"],
                             "events": float(stats["windows"])},
                "fetch_fold": {"seconds": stats["fetch_seconds"],
                               "events": float(stats["windows"])}},
        provenance=provenance,
        extra={"windows": stats["windows"],
               "pushdown_wire_bytes": stats["pushdown_wire_bytes"],
               "fetch_wire_bytes": stats["fetch_wire_bytes"],
               "wire_ratio": stats["wire_ratio"],
               "fetch_windows_per_s": stats["fetch_windows_per_s"]})


def publish(*, n_windows: int = 256, device="cuda",
            ledger: str | None = None) -> list[dict]:
    """Measure both series and append the records to the ledger;
    returns the records (schema-validated by the append path)."""
    from .ledger import append_record
    from .provenance import acquire_device, device_provenance

    dev, acquired = acquire_device(device)
    prov = device_provenance(dev, acquired)
    records = [compaction_record(measure_compaction(n_windows), prov),
               pushdown_record(measure_pushdown(n_windows), prov)]
    for rec in records:
        append_record(rec, path=ledger)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="tiered-history micro-bench → perf ledger")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ledger", default=None,
                    help="ledger path (default: $IG_TPU_TORCH_PERF_LEDGER or the "
                         "user's state directory)")
    ap.add_argument("--windows", type=int, default=256)
    args = ap.parse_args(argv)
    for rec in publish(n_windows=args.windows, device=args.device, ledger=args.ledger):
        e = rec["extra"]
        if rec["config"] == "history-compaction":
            print(f"compaction: {rec['value']:,.0f} windows/s "
                  f"({e['windows']} -> {e['super_windows']} super, "
                  f"{e['bytes_reclaimed']} bytes reclaimed)")
        else:
            print(f"pushdown: {rec['value']:,.0f} windows/s folded, "
                  f"{e['pushdown_wire_bytes']} wire bytes vs "
                  f"{e['fetch_wire_bytes']} fetch-and-fold "
                  f"({e['wire_ratio']:.1f}x reduction)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
