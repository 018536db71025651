"""Subscriber fan-out micro-bench → schema-valid PerfRecords (the port's
copy of ``inspektor_gadget_tpu/perf/fanout.py``).

The shared-run plane's cost model is "agent-side
cost flat in K, per-subscriber delivery cost linear in K". This bench
measures the delivery plane directly (SharedRun.push with K attached,
actively-drained subscribers — no gRPC, no gadget: the pure fan-out
hot path), and publishes one record per K to the perf ledger under the
series `shared-fanout-k<K>` / `sub_fanout`, so a fan-out regression
gates exactly like a speed regression via `bench compare`.

Host work only (queues and threads): the records name the device the
process acquired, as every bench module's do. Run standalone (`python -m
inspektor_gadget_tpu_torch.perf.fanout [--device cuda|cpu] [--ledger
PATH] [--k 1,16] [--messages N]`) or from tests with a tiny message
count.
"""

from __future__ import annotations

import argparse
import queue
import threading
import time


def measure_fanout(k: int, *, messages: int = 20000,
                   queue_max: int = 4096,
                   payload_bytes: int = 512) -> dict:
    """Push `messages` typical records through a SharedRun with K
    attached, drained subscribers; returns timing/delivery stats."""
    from ..agent import wire
    from ..agent.service import SharedRun

    run = SharedRun(f"fanout-k{k}", "bench/fanout", shared=True,
                    keepalive=0.05, max_subscribers=max(k, 1),
                    sub_budget=max(queue_max * k * 2, 1), node="bench")
    drained = [0] * k
    stop = threading.Event()
    threads = []
    queues = []
    for i in range(k):
        sub = run.admit({"queue": queue_max})
        assert not isinstance(sub, dict), f"admission refused: {sub}"
        q, _gen, _ack = run.attach_subscriber(sub, 0)
        queues.append(q)

        def drain(q=q, i=i):
            while True:
                try:
                    item = q.get(timeout=0.2)
                except queue.Empty:
                    if stop.is_set():
                        return
                    continue
                if item is None:
                    return
                drained[i] += 1

        t = threading.Thread(target=drain, daemon=True)
        t.start()
        threads.append(t)

    payload = b"x" * payload_bytes
    header = {"node": "bench"}
    t0 = time.perf_counter()
    for _ in range(messages):
        run.push(wire.EV_PAYLOAD_JSON, header, payload)
    push_s = max(time.perf_counter() - t0, 1e-9)
    run.finish()
    stop.set()
    for t in threads:
        t.join(timeout=10.0)
    return {
        "subscribers": k,
        "messages": messages,
        "push_seconds": push_s,
        "push_msg_per_s": messages / push_s,
        # the linear axis: one delivery per (message, subscriber)
        "per_delivery_us": push_s / max(messages * k, 1) * 1e6,
        "delivered": sum(drained),
        "drops": run.dropped,
    }


def fanout_record(stats: dict, provenance: dict) -> dict:
    from .schema import make_record
    k = stats["subscribers"]
    return make_record(
        config=f"shared-fanout-k{k}", metric="sub_fanout", unit="msg/s",
        value=stats["push_msg_per_s"],
        stages={"push": {"seconds": stats["push_seconds"],
                         "calls": float(stats["messages"])},
                "deliver": {"calls": float(stats["messages"] * k),
                            "events": float(stats["delivered"])}},
        provenance=provenance,
        extra={"subscribers": k,
               "per_delivery_us": stats["per_delivery_us"],
               "delivered": stats["delivered"],
               "drops": stats["drops"]})


def publish(ks=(1, 16), *, messages: int = 20000, device="cuda",
            ledger: str | None = None) -> list[dict]:
    """Measure every K and append the records to the ledger; returns
    the records (schema-validated by the append path)."""
    from .ledger import append_record
    from .provenance import acquire_device, device_provenance

    dev, acquired = acquire_device(device)
    prov = device_provenance(dev, acquired)
    records = []
    for k in ks:
        rec = fanout_record(measure_fanout(k, messages=messages), prov)
        append_record(rec, path=ledger)
        records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="subscriber fan-out micro-bench → perf ledger")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ledger", default=None,
                    help="ledger path (default: $IG_TPU_TORCH_PERF_LEDGER or the "
                         "user's state directory)")
    ap.add_argument("--k", default="1,16",
                    help="comma-separated subscriber counts")
    ap.add_argument("--messages", type=int, default=20000)
    args = ap.parse_args(argv)
    ks = tuple(int(x) for x in args.k.split(",") if x)
    for rec in publish(ks, messages=args.messages, device=args.device,
                       ledger=args.ledger):
        e = rec["extra"]
        print(f"K={e['subscribers']:>2d}: {rec['value']:,.0f} push msg/s, "
              f"{e['per_delivery_us']:.2f} µs/delivery, "
              f"{e['delivered']} delivered, {e['drops']} dropped")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
