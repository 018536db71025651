"""Accuracy-audit-plane micro-bench → schema-valid PerfRecords (the
port's copy of ``inspektor_gadget_tpu/perf/accuracy_bench.py``).

The audit plane's cost model is one claim: the shadow-sample feed rides
an existing host lane, so turning the plane on costs a bounded slice of
ingest throughput, not a new pipeline stage. Its value model is another:
the observed heavy-hitter error the shadow audit reports sits well
inside the count-min's analytic bound at the documented geometry. This
bench measures both and publishes three series to the perf ledger:

  * `accuracy-audit` / `audit_feed` (events/sec): ingest throughput (the
    plain `bundle_update`, whose entropy update is K1) WITH the bottom-k
    shadow sample folding every batch.
  * `accuracy-overhead` / `audit_overhead` (fraction, lower better): the
    relative ingest throughput the plane costs — the same loop with the
    feed off and on; `extra.audit_overhead` in harness records tracks
    the same quantity live.
  * `accuracy-observed-err` / `cms_observed_err` (pct, lower better):
    the shadow-audited heavy-hitter relative error of a real count-min
    at depth 4 / width 65536 over a zipf stream of millions of events.

Run standalone (`python -m inspektor_gadget_tpu_torch.perf.accuracy_bench
[--device cuda|cpu] [--ledger PATH] [--batch N] [--capacity K]
[--events N]`) or from tests with tiny shapes.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .harness import _sync, _to_device


def _zipf_keys(events: int, vocab: int = 4096, s: float = 1.2,
               seed: int = 42) -> np.ndarray:
    """Synthetic zipf-weighted uint32 key stream (1..vocab — key 0 is
    reserved as padding throughout the repo, so the stream avoids it)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -s
    p /= p.sum()
    return (rng.choice(vocab, size=events, p=p) + 1).astype(np.uint32)


def measure_feed(*, batch: int = 1 << 14, capacity: int = 1024,
                 seconds: float = 0.5, vocab: int = 4096,
                 device: str | torch.device = "cuda") -> dict:
    """Ingest throughput with and without the shadow sample: the same
    `bundle_update` absorbs the same zipf batches, and the audited loop
    also folds every batch into the bottom-k sample (the operator's
    `audit-sample > 0` path). The overhead fraction is the throughput the
    plane costs a real ingest loop."""
    from ..device import resolve_device
    from ..ops.accuracy import ShadowSample
    from ..ops.sketches import bundle_init, bundle_update

    dev = resolve_device(device)
    keys = _zipf_keys(batch * 8, vocab=vocab)
    host_batches = [keys[i * batch:(i + 1) * batch] for i in range(8)]
    dev_batches = [_to_device(b, dev) for b in host_batches]
    mask = torch.ones(batch, dtype=torch.bool, device=dev)

    def loop(feed: bool) -> tuple[int, float]:
        bundle = bundle_init(device=dev)
        sh = ShadowSample(capacity)
        bundle_update(bundle, dev_batches[0], dev_batches[0], dev_batches[0], mask)
        _sync(dev)  # the first call outside the window
        sh.update(host_batches[0])  # warm: fill the reservoir once
        steps = 0
        t0 = time.perf_counter()
        while True:
            i = steps % 8
            bundle_update(bundle, dev_batches[i], dev_batches[i], dev_batches[i], mask)
            if feed:
                sh.update(host_batches[i])
            steps += 1
            if steps % 8 == 0:
                _sync(dev)
                if time.perf_counter() - t0 >= seconds:
                    break
        _sync(dev)
        return steps, max(time.perf_counter() - t0, 1e-9)

    base_steps, base_s = loop(False)
    fed_steps, fed_s = loop(True)
    base_ev = base_steps * batch / base_s
    fed_ev = fed_steps * batch / fed_s
    return {
        "batch": batch, "capacity": capacity, "vocab": vocab,
        "steps": fed_steps, "events": fed_steps * batch, "seconds": fed_s,
        "base_ev_per_s": base_ev, "ev_per_s": fed_ev,
        "audit_overhead": max(1.0 - fed_ev / max(base_ev, 1e-9), 0.0),
    }


def measure_observed_err(*, events: int = 2_000_000, batch: int = 1 << 16,
                         vocab: int = 4096, capacity: int = 1024,
                         depth: int = 4, log2_width: int = 16,
                         top: int = 32, device: str | torch.device = "cuda") -> dict:
    """Shadow-audited observed error of a REAL count-min at the geometry
    ops/countmin.py documents: feed a zipf stream to the sketch and the
    bottom-k shadow sample side by side, take the audited heavy keys'
    exact counts from the full stream, and report the mean relative
    overestimate of the sketch's point queries, next to the analytic
    e/width bound. Deterministic: the same on every device."""
    from ..device import resolve_device
    from ..ops.accuracy import ShadowSample, cms_bound
    from ..ops.countmin import cms_init, cms_query, cms_update

    dev = resolve_device(device)
    keys = _zipf_keys(events, vocab=vocab, seed=7)
    cms = cms_init(depth=depth, log2_width=log2_width, device=dev)
    sh = ShadowSample(capacity)
    for i in range(0, events, batch):
        chunk = keys[i:i + batch]
        cms_update(cms, _to_device(chunk, dev))
        sh.update(chunk)
    exact = np.bincount(keys.astype(np.int64), minlength=vocab + 1)
    # audit set: the shadow-resident keys, heaviest first — the ground
    # truth the operator's accuracy block audits against
    resident = sh.keys[np.argsort(-exact[sh.keys.astype(np.int64)])]
    audited = resident[:top].astype(np.int64)
    est = cms_query(cms, _to_device(audited.astype(np.uint32), dev)).cpu().numpy().astype(
        np.float64)
    truth = exact[audited].astype(np.float64)
    rel = (est - truth) / np.maximum(truth, 1.0)
    bound = cms_bound(depth, 1 << log2_width, float(events))
    return {
        "events": events, "vocab": vocab, "depth": depth,
        "log2_width": log2_width, "capacity": capacity,
        "audited_keys": int(audited.size),
        "observed_err_pct": float(np.mean(rel)) * 100.0,
        "max_err_pct": float(np.max(rel)) * 100.0,
        "bound_pct": float(bound["bound"]) * 100.0,
    }


def feed_record(stats: dict, provenance: dict) -> dict:
    from .schema import make_record
    return make_record(
        config="accuracy-audit", metric="audit_feed", unit="events/sec",
        value=stats["ev_per_s"],
        stages={"audit_feed": {"seconds": stats["seconds"],
                               "events": float(stats["events"]),
                               "ev_per_s": stats["ev_per_s"],
                               "calls": float(stats["steps"])}},
        provenance=provenance,
        extra={"batch": stats["batch"], "capacity": stats["capacity"],
               "vocab": stats["vocab"],
               "audit_overhead": round(stats["audit_overhead"], 4)})


def overhead_record(stats: dict, provenance: dict) -> dict:
    from .schema import make_record
    return make_record(
        config="accuracy-overhead", metric="audit_overhead",
        unit="fraction", value=round(stats["audit_overhead"], 4),
        stages={"audit_feed": {"seconds": stats["seconds"],
                               "ev_per_s": stats["ev_per_s"],
                               "calls": float(stats["steps"])}},
        provenance=provenance,
        extra={"batch": stats["batch"], "capacity": stats["capacity"],
               "base_ev_per_s": round(stats["base_ev_per_s"], 1),
               "fed_ev_per_s": round(stats["ev_per_s"], 1)})


def err_record(stats: dict, provenance: dict) -> dict:
    from .schema import make_record
    return make_record(
        config="accuracy-observed-err", metric="cms_observed_err",
        unit="pct", value=round(stats["observed_err_pct"], 5),
        stages={"audit_feed": {"events": float(stats["events"]),
                               "calls": float(stats["audited_keys"])}},
        provenance=provenance,
        extra={"events": stats["events"], "vocab": stats["vocab"],
               "depth": stats["depth"], "log2_width": stats["log2_width"],
               "capacity": stats["capacity"],
               "audited_keys": stats["audited_keys"],
               "observed_err_pct": round(stats["observed_err_pct"], 5),
               "max_err_pct": round(stats["max_err_pct"], 5),
               "bound_pct": round(stats["bound_pct"], 5)})


def publish(*, batch: int = 1 << 14, capacity: int = 1024,
            seconds: float = 0.5, events: int = 2_000_000,
            device: str | torch.device = "cuda",
            ledger: str | None = None) -> list[dict]:
    """Measure all three series on `device` and append the records to
    the ledger; returns the records (schema-validated by the append
    path)."""
    from .ledger import append_record
    from .provenance import acquire_device, device_provenance

    dev, acquired = acquire_device(device)
    prov = device_provenance(dev, acquired)
    feed = measure_feed(batch=batch, capacity=capacity, seconds=seconds, device=dev)
    err = measure_observed_err(events=events, capacity=capacity, device=dev)
    records = [feed_record(feed, prov), overhead_record(feed, prov),
               err_record(err, prov)]
    for rec in records:
        append_record(rec, path=ledger)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="accuracy-audit-plane micro-bench → perf ledger")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ledger", default=None,
                    help="ledger path (default: $IG_TPU_TORCH_PERF_LEDGER or the "
                         "user's state directory)")
    ap.add_argument("--batch", type=int, default=1 << 14)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--events", type=int, default=2_000_000,
                    help="stream length for the observed-error audit")
    args = ap.parse_args(argv)
    for rec in publish(batch=args.batch, capacity=args.capacity,
                       seconds=args.seconds, events=args.events,
                       device=args.device, ledger=args.ledger):
        e = rec["extra"]
        if rec["config"] == "accuracy-audit":
            print(f"accuracy-audit: {rec['value']:,.0f} ev/s with the "
                  f"shadow feed (batch {e['batch']}, capacity "
                  f"{e['capacity']}, overhead {e['audit_overhead']:.1%})")
        elif rec["config"] == "accuracy-overhead":
            print(f"accuracy-overhead: {rec['value']:.4f} "
                  f"({e['base_ev_per_s']:,.0f} -> {e['fed_ev_per_s']:,.0f} "
                  "ev/s)")
        else:
            print(f"accuracy-observed-err: {rec['value']:.5f}% observed "
                  f"vs {e['bound_pct']:.5f}% bound ({e['audited_keys']} "
                  f"key(s) audited over {e['events']:,} events)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
