"""DDSketch quantile-plane micro-bench → schema-valid PerfRecords (the
port's copy of ``inspektor_gadget_tpu/perf/quantile_bench.py``).

The quantile plane's cost model is two claims: (1) the standalone
DDSketch batch fold absorbs values at device speed (K2 carries the plane
as one more plane on the hot path, so this is the upper bound on what
the plane adds), and (2) the bucket-wise merge is cheap enough that
cluster folds are free relative to ingest. This bench measures both and
publishes one record per series (`quantile-update` / `qt_update` in
events/sec, `quantile-merge` / `qt_merge` in merges/sec) to the perf
ledger, so a plane regression gates like a speed regression through
`bench compare`.

Run standalone (`python -m inspektor_gadget_tpu_torch.perf.quantile_bench
[--device cuda|cpu] [--ledger PATH] [--batch N] [--buckets N]`) or from
tests with tiny shapes.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .harness import _sync


def _latencies(batch: int, seed: int = 42) -> np.ndarray:
    """Synthetic ns-domain latencies: lognormal body (~50µs median) with
    a heavy tail — the shape a syscall-latency lane actually carries."""
    rng = np.random.default_rng(seed)
    v = rng.lognormal(mean=np.log(50_000.0), sigma=1.2, size=batch)
    return v.astype(np.float32)


def _values(batch: int, dev: torch.device, seed: int = 42) -> torch.Tensor:
    return torch.from_numpy(_latencies(batch, seed)).to(dev)


def measure_update(*, batch: int = 1 << 15, n_buckets: int = 2048,
                   alpha: float = 0.01, seconds: float = 1.0,
                   device: str | torch.device = "cuda") -> dict:
    """Events/sec through the standalone dd_update at one batch shape
    (in-place steps, a synchronize every 8 and at the end)."""
    from ..device import resolve_device
    from ..ops.quantiles import dd_init, dd_update

    dev = resolve_device(device)
    s = dd_init(alpha, n_buckets, min_value=1.0, device=dev)
    values = _values(batch, dev)
    dd_update(s, values)
    _sync(dev)  # the first call outside the window
    steps = 0
    t0 = time.perf_counter()
    while True:
        dd_update(s, values)
        steps += 1
        if steps % 8 == 0:
            _sync(dev)
            if time.perf_counter() - t0 >= seconds:
                break
    _sync(dev)
    elapsed = max(time.perf_counter() - t0, 1e-9)
    return {
        "batch": batch, "n_buckets": n_buckets, "alpha": alpha,
        "steps": steps, "events": steps * batch, "seconds": elapsed,
        "ev_per_s": steps * batch / elapsed,
    }


def merged_sketch(*, n_buckets: int = 2048, alpha: float = 0.01,
                  device: str | torch.device = "cuda"):
    """The two sketches the merge bench folds (seeded latencies 7 and 8,
    4096 each) and their merge: deterministic on every device."""
    from ..device import resolve_device
    from ..ops.quantiles import dd_init, dd_update

    dev = resolve_device(device)
    a = dd_update(dd_init(alpha, n_buckets, min_value=1.0, device=dev), _values(4096, dev, 7))
    b = dd_update(dd_init(alpha, n_buckets, min_value=1.0, device=dev), _values(4096, dev, 8))
    return a, b


def measure_merge(*, n_buckets: int = 2048, alpha: float = 0.01,
                  seconds: float = 0.5, device: str | torch.device = "cuda") -> dict:
    """Merges/sec of the bucket-wise dd_merge: the per-pair cost a
    client-side fold of N nodes' sealed windows pays N-1 times."""
    from ..ops.quantiles import dd_merge

    a, b = merged_sketch(n_buckets=n_buckets, alpha=alpha, device=device)
    dev = a.counts.device
    dd_merge(a, b)
    _sync(dev)
    steps = 0
    t0 = time.perf_counter()
    while True:
        a = dd_merge(a, b)
        steps += 1
        if steps % 16 == 0:
            _sync(dev)
            if time.perf_counter() - t0 >= seconds:
                break
    _sync(dev)
    elapsed = max(time.perf_counter() - t0, 1e-9)
    return {
        "n_buckets": n_buckets, "alpha": alpha, "steps": steps,
        "seconds": elapsed, "merges_per_s": steps / elapsed,
    }


def update_record(stats: dict, provenance: dict) -> dict:
    from .schema import make_record
    return make_record(
        config="quantile-update", metric="qt_update", unit="events/sec",
        value=stats["ev_per_s"],
        stages={"qt_update": {"seconds": stats["seconds"],
                              "events": float(stats["events"]),
                              "ev_per_s": stats["ev_per_s"],
                              "calls": float(stats["steps"])}},
        provenance=provenance,
        extra={"batch": stats["batch"], "n_buckets": stats["n_buckets"],
               "alpha": stats["alpha"]})


def merge_record(stats: dict, provenance: dict) -> dict:
    from .schema import make_record
    return make_record(
        config="quantile-merge", metric="qt_merge", unit="merges/sec",
        value=stats["merges_per_s"],
        stages={"qt_merge": {"seconds": stats["seconds"],
                             "calls": float(stats["steps"])}},
        provenance=provenance,
        extra={"n_buckets": stats["n_buckets"], "alpha": stats["alpha"]})


def publish(*, batch: int = 1 << 15, n_buckets: int = 2048,
            alpha: float = 0.01, seconds: float = 1.0,
            device: str | torch.device = "cuda",
            ledger: str | None = None) -> list[dict]:
    """Measure both series on `device` and append the records to the
    ledger; returns the records (schema-validated by the append path)."""
    from .ledger import append_record
    from .provenance import acquire_device, device_provenance

    dev, acquired = acquire_device(device)
    prov = device_provenance(dev, acquired)
    records = [
        update_record(measure_update(batch=batch, n_buckets=n_buckets,
                                     alpha=alpha, seconds=seconds, device=dev), prov),
        merge_record(measure_merge(n_buckets=n_buckets, alpha=alpha,
                                   seconds=min(seconds, 0.5), device=dev), prov),
    ]
    for rec in records:
        append_record(rec, path=ledger)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="DDSketch quantile-plane micro-bench → perf ledger")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ledger", default=None,
                    help="ledger path (default: $IG_TPU_TORCH_PERF_LEDGER or the "
                         "user's state directory)")
    ap.add_argument("--batch", type=int, default=1 << 15)
    ap.add_argument("--buckets", type=int, default=2048)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for rec in publish(batch=args.batch, n_buckets=args.buckets,
                       alpha=args.alpha, seconds=args.seconds,
                       device=args.device, ledger=args.ledger):
        e = rec["extra"]
        if rec["config"] == "quantile-update":
            print(f"quantile-update: {rec['value']:,.0f} ev/s "
                  f"(batch {e['batch']}, {e['n_buckets']} buckets, "
                  f"alpha {e['alpha']:g})")
        else:
            print(f"quantile-merge: {rec['value']:,.0f} merges/s "
                  f"({e['n_buckets']} buckets)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
