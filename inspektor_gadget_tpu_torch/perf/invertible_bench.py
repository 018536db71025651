"""Invertible-sketch micro-bench → schema-valid PerfRecords (the port's
copy of ``inspektor_gadget_tpu/perf/invertible_bench.py``).

The invertible plane's cost model is two claims: (1) the standalone
update absorbs batches at device speed (K2 carries it as more planes on
the hot path, so this is the upper bound on what the plane adds), and
(2) decode of merged state recovers keys at a rate that makes a decode a
harvest viable. This bench measures both and publishes one record per
series (`inv-update` / `inv_update` in events/sec, `inv-decode` /
`inv_decode` in keys/sec) to the perf ledger, so a plane regression
gates like a speed regression through `bench compare`.

Run standalone (`python -m inspektor_gadget_tpu_torch.perf.invertible_bench
[--device cuda|cpu] [--ledger PATH] [--batch N] [--keys N]`) or from
tests with tiny shapes.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .harness import _sync, _to_device


def measure_update(*, batch: int = 1 << 15, rows: int = 3,
                   log2_buckets: int = 12, seconds: float = 1.0,
                   device: str | torch.device = "cuda") -> dict:
    """Events/sec through the standalone inv_update at one batch shape
    (in-place steps, a synchronize every 8 and at the end)."""
    from ..device import resolve_device
    from ..ops.invertible import inv_init, inv_update

    dev = resolve_device(device)
    s = inv_init(rows, log2_buckets, device=dev)
    rng = np.random.default_rng(42)
    keys = _to_device(rng.integers(1, 1 << 32, batch).astype(np.uint32), dev)
    w = torch.ones(batch, dtype=torch.int32, device=dev)
    inv_update(s, keys, w)
    _sync(dev)  # the first call outside the window
    steps = 0
    t0 = time.perf_counter()
    while True:
        inv_update(s, keys, w)
        steps += 1
        if steps % 8 == 0:
            _sync(dev)
            if time.perf_counter() - t0 >= seconds:
                break
    _sync(dev)
    elapsed = max(time.perf_counter() - t0, 1e-9)
    return {
        "batch": batch, "rows": rows, "log2_buckets": log2_buckets,
        "steps": steps, "events": steps * batch, "seconds": elapsed,
        "ev_per_s": steps * batch / elapsed,
    }


def loaded_sketch(*, n_keys: int = 2048, rows: int = 3, log2_buckets: int = 12,
                  device: str | torch.device = "cuda"):
    """A sketch loaded with `n_keys` distinct seeded keys of zipf counts
    (seed 7): returns (state, keys, counts)."""
    from ..device import resolve_device
    from ..ops.invertible import inv_init, inv_update

    rng = np.random.default_rng(7)
    keys = rng.choice(np.arange(1, 1 << 22, dtype=np.uint32), size=n_keys, replace=False)
    # cap at a value with few trailing zero bits: counts divisible by 2^17+
    # are the decode's documented blind spot, and a power-of-two clip would
    # manufacture exactly that
    counts = rng.zipf(1.4, size=n_keys).clip(1, 999_999).astype(np.int64)
    dev = resolve_device(device)
    s = inv_init(rows, log2_buckets, device=dev)
    inv_update(s, _to_device(keys, dev), torch.from_numpy(counts.astype(np.int32)).to(dev))
    _sync(dev)
    return s, keys, counts


def measure_decode(*, n_keys: int = 2048, rows: int = 3,
                   log2_buckets: int = 12, reps: int = 3,
                   device: str | torch.device = "cuda") -> dict:
    """Keys/sec recovered by a full decode (device peel + host finisher)
    of a sketch loaded to `n_keys` distinct keys, kept under the
    documented capacity so the measured decode is COMPLETE (checked: a
    partial decode would publish a meaningless rate). `decoded` holds the
    recovered (key, count) pairs."""
    from ..ops.invertible import inv_capacity, inv_decode

    cap = inv_capacity(rows, log2_buckets)
    if n_keys > cap:
        raise ValueError(f"n_keys {n_keys} exceeds decode capacity {cap} "
                         f"for rows={rows} log2_buckets={log2_buckets}")
    s, _keys, _counts = loaded_sketch(n_keys=n_keys, rows=rows, log2_buckets=log2_buckets,
                                      device=device)
    best = None
    dec = None
    for _ in range(reps):
        t0 = time.perf_counter()
        dec = inv_decode(s)
        dt = max(time.perf_counter() - t0, 1e-9)
        if not dec.complete or dec.recovered != n_keys:
            raise AssertionError(
                f"decode under capacity must be complete: recovered "
                f"{dec.recovered}/{n_keys}, complete={dec.complete}")
        best = dt if best is None else min(best, dt)
    return {
        "keys": n_keys, "rows": rows, "log2_buckets": log2_buckets,
        "capacity": cap, "seconds": best,
        "keys_per_s": n_keys / best, "complete": True, "decoded": dec.keys,
    }


def update_record(stats: dict, provenance: dict) -> dict:
    from .schema import make_record
    return make_record(
        config="inv-update", metric="inv_update", unit="events/sec",
        value=stats["ev_per_s"],
        stages={"inv_update": {"seconds": stats["seconds"],
                               "events": float(stats["events"]),
                               "ev_per_s": stats["ev_per_s"],
                               "calls": float(stats["steps"])}},
        provenance=provenance,
        extra={"batch": stats["batch"], "rows": stats["rows"],
               "log2_buckets": stats["log2_buckets"]})


def decode_record(stats: dict, provenance: dict) -> dict:
    from .schema import make_record
    return make_record(
        config="inv-decode", metric="inv_decode", unit="keys/sec",
        value=stats["keys_per_s"],
        stages={"inv_decode": {"seconds": stats["seconds"],
                               "events": float(stats["keys"])}},
        provenance=provenance,
        extra={"keys": stats["keys"], "rows": stats["rows"],
               "log2_buckets": stats["log2_buckets"],
               "capacity": stats["capacity"],
               "complete": 1.0})


def publish(*, batch: int = 1 << 15, n_keys: int = 2048,
            rows: int = 3, log2_buckets: int = 12,
            seconds: float = 1.0, device: str | torch.device = "cuda",
            ledger: str | None = None) -> list[dict]:
    """Measure both series on `device` and append the records to the
    ledger; returns the records (schema-validated by the append path)."""
    from .ledger import append_record
    from .provenance import acquire_device, device_provenance

    dev, acquired = acquire_device(device)
    prov = device_provenance(dev, acquired)
    records = [
        update_record(measure_update(batch=batch, rows=rows,
                                     log2_buckets=log2_buckets,
                                     seconds=seconds, device=dev), prov),
        decode_record(measure_decode(n_keys=n_keys, rows=rows,
                                     log2_buckets=log2_buckets, device=dev), prov),
    ]
    for rec in records:
        append_record(rec, path=ledger)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="invertible-sketch micro-bench → perf ledger")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ledger", default=None,
                    help="ledger path (default: $IG_TPU_TORCH_PERF_LEDGER or the "
                         "user's state directory)")
    ap.add_argument("--batch", type=int, default=1 << 15)
    ap.add_argument("--keys", type=int, default=2048)
    ap.add_argument("--rows", type=int, default=3)
    ap.add_argument("--log2-buckets", type=int, default=12)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for rec in publish(batch=args.batch, n_keys=args.keys, rows=args.rows,
                       log2_buckets=args.log2_buckets,
                       seconds=args.seconds, device=args.device, ledger=args.ledger):
        e = rec["extra"]
        if rec["config"] == "inv-update":
            print(f"inv-update: {rec['value']:,.0f} ev/s "
                  f"(batch {e['batch']}, {e['rows']}x2^{e['log2_buckets']})")
        else:
            print(f"inv-decode: {rec['value']:,.0f} keys/s "
                  f"({e['keys']} keys, capacity {e['capacity']}, "
                  "complete)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
