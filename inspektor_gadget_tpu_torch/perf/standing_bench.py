"""Standing-query plane micro-bench → schema-valid PerfRecords (the
port's copy of ``inspektor_gadget_tpu/perf/standing_bench.py``).

The plane's economic claim is a PAIR: incremental refresh (fold ONE
just-sealed window into the running answer via the two-stack sliding
aggregation) costs the same whether the query watches 16 windows or
256, while the ad-hoc recompute an `ig-tpu-torch query` pays re-folds the
whole range — cost proportional to range length. Plus the serve-side
claim: a repeat read within one coverage is a digest-keyed cache hit
performing ZERO window folds. This bench measures all three and
publishes one record per series (`standing-refresh` / `sq_refresh`,
`standing-recompute` / `sq_recompute`, `standing-cache-hit` /
`sq_cache_hit`) to the perf ledger, gated by `bench compare` like
every other cost claim. Each refresh/recompute record carries BOTH
range lengths in `extra` so the independence claim is auditable from
the ledger alone.

Host-plane work only (numpy window algebra): the records name the device
the process acquired, as every bench module's do. Run standalone
(`python -m inspektor_gadget_tpu_torch.perf.standing_bench [--device
cuda|cpu] [--ledger PATH]`) or from tests with tiny shapes.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def make_windows(n: int, *, seed: int = 42, depth: int = 3,
                 width: int = 64, hll_m: int = 64, ent_w: int = 32,
                 k: int = 8) -> list:
    """n distinct synthetic sealed windows (1s each, ts i..i+1) with
    realistic lane shapes; distinct content so coverage digests are
    distinct, like real seal ticks. Top-k keys draw from a small hot-key
    universe — real heavy hitters RECUR across windows, so the fold's
    candidate union saturates at the hot-key cardinality instead of
    growing by k per window (the all-distinct worst case would make any
    top-k fold — incremental or not — scale with range)."""
    from ..history.window import SealedWindow, window_digest
    rng = np.random.default_rng(seed)
    universe = rng.integers(1, 1 << 20, size=8 * k).astype(np.uint32)
    wins = []
    for i in range(n):
        win = SealedWindow(
            gadget="bench/standing", node="bench0", run_id="bench",
            window=i + 1, start_ts=float(i), end_ts=float(i + 1),
            events=int(1000 + i), drops=0,
            cms=rng.integers(0, 1000, size=(depth, width)).astype(np.int32),
            hll=rng.integers(0, 16, size=hll_m).astype(np.int32),
            ent=rng.integers(0, 50, size=ent_w).astype(np.float32),
            topk_keys=rng.choice(universe, size=k, replace=False),
            topk_counts=rng.integers(1, 500, size=k).astype(np.int64),
            slices={},
        )
        win.digest = window_digest(win)
        wins.append(win)
    return wins


def _engine(range_windows: int, every: int = 1):
    from ..queries import StandingQuery, StandingQueryEngine
    spec = StandingQuery(id="bench", stats=("topk", "cardinality"),
                         range_s=float(range_windows), top=10,
                         every=every)
    return StandingQueryEngine([spec], gadget="bench/standing",
                               node="bench0")


def measure_refresh(*, range_windows: int, windows: list,
                    steps: int = 256) -> dict:
    """Refreshes/sec of the full seal-tick path (two-stack fold +
    materialize + encode + cache put) at one sliding-range length.
    Each window in the pool is pushed exactly once (monotonic seal
    ticks, like a real run); `steps` ticks are timed after the range
    is primed full, so the steady state is evict+push, not growth."""
    if len(windows) < range_windows + steps:
        raise ValueError(f"pool of {len(windows)} windows is too small "
                         f"for range {range_windows} + {steps} steps")
    eng = _engine(range_windows)
    tick = 0
    for _ in range(range_windows):
        w = windows[tick]
        eng.on_seal(w, now=w.end_ts)
        tick += 1
    t0 = time.perf_counter()
    for _ in range(steps):
        w = windows[tick]
        eng.on_seal(w, now=w.end_ts)
        tick += 1
    elapsed = max(time.perf_counter() - t0, 1e-9)
    return {"range_windows": range_windows, "steps": steps,
            "seconds": elapsed, "refresh_per_s": steps / elapsed}


def measure_recompute(*, range_windows: int, windows: list,
                      steps: int = 16) -> dict:
    """Recomputes/sec of the ad-hoc path over the same range: re-fold
    every covered window per request (merge + seal + pack), the cost
    `ig-tpu-torch query` pays on each dashboard refresh."""
    from ..history.query import pack_frames
    from ..history.window import encode_window, merge_windows, \
        merged_to_sealed
    covered = windows[:range_windows]
    t0 = time.perf_counter()
    for _ in range(steps):
        merged = merge_windows(covered)
        sealed = merged_to_sealed(merged, gadget="bench/standing",
                                  node="bench0", window=0, run_id="")
        pack_frames([encode_window(sealed)])
    elapsed = max(time.perf_counter() - t0, 1e-9)
    return {"range_windows": range_windows, "steps": steps,
            "seconds": elapsed, "recompute_per_s": steps / elapsed}


def measure_cache_hit(*, range_windows: int, windows: list,
                      steps: int = 4096) -> dict:
    """Reads/sec of the repeat-read path: same coverage, so every read
    is a digest-keyed cache hit — zero window folds, counter-checked."""
    eng = _engine(range_windows)
    for tick in range(range_windows):
        w = windows[tick]
        eng.on_seal(w, now=w.end_ts)
    eng.read("bench")  # ensure the entry is warm
    folds0 = eng._folds["bench"].folds
    t0 = time.perf_counter()
    for _ in range(steps):
        got = eng.read("bench")
        assert got is not None and got[2], "expected a cache hit"
    elapsed = max(time.perf_counter() - t0, 1e-9)
    folds = eng._folds["bench"].folds - folds0
    return {"range_windows": range_windows, "steps": steps,
            "seconds": elapsed, "reads_per_s": steps / elapsed,
            "folds_during_reads": folds}


def refresh_record(small: dict, large: dict, provenance: dict) -> dict:
    from .schema import make_record
    return make_record(
        config="standing-refresh", metric="sq_refresh",
        unit="refreshes/sec", value=large["refresh_per_s"],
        stages={"sq_refresh": {"seconds": large["seconds"],
                               "calls": float(large["steps"])}},
        provenance=provenance,
        extra={"range_small": small["range_windows"],
               "range_large": large["range_windows"],
               "refresh_per_s_small": small["refresh_per_s"],
               "refresh_per_s_large": large["refresh_per_s"],
               # ≈1.0 when refresh cost is independent of range length
               "large_over_small":
                   large["refresh_per_s"] / small["refresh_per_s"]})


def recompute_record(small: dict, large: dict, provenance: dict) -> dict:
    from .schema import make_record
    return make_record(
        config="standing-recompute", metric="sq_recompute",
        unit="recomputes/sec", value=large["recompute_per_s"],
        stages={"sq_recompute": {"seconds": large["seconds"],
                                 "calls": float(large["steps"])}},
        provenance=provenance,
        extra={"range_small": small["range_windows"],
               "range_large": large["range_windows"],
               "recompute_per_s_small": small["recompute_per_s"],
               "recompute_per_s_large": large["recompute_per_s"],
               # ≈ range_small/range_large when cost scales with length
               "large_over_small":
                   large["recompute_per_s"] / small["recompute_per_s"]})


def cache_record(stats: dict, provenance: dict) -> dict:
    from .schema import make_record
    return make_record(
        config="standing-cache-hit", metric="sq_cache_hit",
        unit="reads/sec", value=stats["reads_per_s"],
        stages={"sq_cache_hit": {"seconds": stats["seconds"],
                                 "calls": float(stats["steps"])}},
        provenance=provenance,
        extra={"range_windows": stats["range_windows"],
               "folds_during_reads": stats["folds_during_reads"]})


def publish(*, range_small: int = 16, range_large: int = 256,
            steps: int = 256, device="cuda",
            ledger: str | None = None) -> list[dict]:
    """Measure all three series and append the records to the ledger;
    returns the records (schema-validated by the append path)."""
    from .ledger import append_record
    from .provenance import acquire_device, device_provenance

    dev, acquired = acquire_device(device)
    prov = device_provenance(dev, acquired)
    windows = make_windows(range_large + steps)
    refresh = [measure_refresh(range_windows=r, windows=windows,
                               steps=steps)
               for r in (range_small, range_large)]
    recompute = [measure_recompute(range_windows=r, windows=windows,
                                   steps=max(steps // 16, 4))
                 for r in (range_small, range_large)]
    cache = measure_cache_hit(range_windows=range_small, windows=windows,
                              steps=max(steps * 16, 512))
    records = [
        refresh_record(refresh[0], refresh[1], prov),
        recompute_record(recompute[0], recompute[1], prov),
        cache_record(cache, prov),
    ]
    for rec in records:
        append_record(rec, path=ledger)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="standing-query plane micro-bench → perf ledger")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ledger", default=None,
                    help="ledger path (default: $IG_TPU_TORCH_PERF_LEDGER or the "
                         "user's state directory)")
    ap.add_argument("--range-small", type=int, default=16)
    ap.add_argument("--range-large", type=int, default=256)
    ap.add_argument("--steps", type=int, default=256,
                    help="timed seal ticks per refresh series")
    args = ap.parse_args(argv)
    for rec in publish(range_small=args.range_small,
                       range_large=args.range_large,
                       steps=args.steps, device=args.device, ledger=args.ledger):
        e = rec["extra"]
        if rec["config"] == "standing-refresh":
            grow = e["range_large"] / e["range_small"]
            cost = 1.0 / max(e["large_over_small"], 1e-9)
            print(f"standing-refresh: {e['refresh_per_s_small']:,.0f} "
                  f"refreshes/s @ {e['range_small']}w vs "
                  f"{e['refresh_per_s_large']:,.0f} @ {e['range_large']}w "
                  f"({grow:.0f}x the range costs {cost:.1f}x per refresh)")
        elif rec["config"] == "standing-recompute":
            grow = e["range_large"] / e["range_small"]
            cost = 1.0 / max(e["large_over_small"], 1e-9)
            print(f"standing-recompute: {e['recompute_per_s_small']:,.0f} "
                  f"recomputes/s @ {e['range_small']}w vs "
                  f"{e['recompute_per_s_large']:,.0f} @ "
                  f"{e['range_large']}w ({grow:.0f}x the range costs "
                  f"{cost:.1f}x per recompute)")
        else:
            print(f"standing-cache-hit: {rec['value']:,.0f} reads/s "
                  f"({e['folds_during_reads']} window folds during the "
                  "read loop)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
