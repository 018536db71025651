#!/usr/bin/env python3
"""Host cost of tracing in the tpusketch operator's batch path, on the CPU.

    python tools/trace_cost.py [--batches 400] [--rounds 15] [--events 8192]

Runs one CPU `TpuSketchInstance` (small geometry, no harvest) under the
operator chain's ``op/tpusketch`` span, in rounds that alternate two
modes on the same batches:

- ``live``: tracing as the package ships it (spans into the ring, and
  whatever profiler ranges it opens with no profiler running);
- ``bare``: the chain's tracer and the instance's span helper replaced
  by a no-op span, so no span, id, range or ring write is made.

The step itself (`bundle_ingest_step`) is stubbed out in both modes, so
what is left of a batch is the host path around it: the key fold into
the pinned block, the stager, the watermarks and the tracing. Prints one
JSON object: the median host µs a batch in each mode and their
difference, tracing's host µs a batch.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class _NullSpan:
    duration = 0.0
    context = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set_attr(self, key, value):
        return self


class _NullTracer:
    _span = _NullSpan()

    def span(self, *args, **kwargs):
        return self._span

    def current_context(self):
        return None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="trace_cost")
    ap.add_argument("--batches", type=int, default=400)
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--events", type=int, default=8192)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from inspektor_gadget_tpu_torch.operators import operators as O
    from inspektor_gadget_tpu_torch.operators import tpusketch as T
    from inspektor_gadget_tpu_torch.sources.batch import EventBatch

    torch.set_num_threads(1)
    T.bundle_ingest_step = lambda bundle, *a, **k: (bundle, None)
    cfg = T.SketchConfig(depth=3, log2_width=10, hll_p=8, entropy_log2_width=6, topk=8,
                         harvest_interval=3600.0)
    inst = T.TpuSketchInstance(cfg, T.SketchContext(run_id="trace-cost"), device="cpu")
    chain = O.Operators([inst])
    rng = np.random.default_rng(7)
    n = args.events
    batches = []
    for _ in range(8):
        b = EventBatch.alloc(n, with_comm=False)
        b.cols["key_hash"][:] = rng.integers(1, 5000, n).astype(np.uint64) * \
            np.uint64(0x9E3779B97F4A7C15)
        b.cols["ts"][:] = 1_700_000_000_000_000_000
        b.count = n
        batches.append(b)

    live_tracer, live_span = O.TRACER, inst._span
    null = _NullTracer()

    def set_mode(bare: bool) -> None:
        O.TRACER = null if bare else live_tracer
        if bare:
            inst._span = null.span
        else:
            inst.__dict__.pop("_span", None)
            assert inst._span == live_span

    def run(bare: bool) -> float:
        set_mode(bare)
        t0 = time.perf_counter()
        for i in range(args.batches):
            chain.enrich_batch(batches[i % len(batches)])
        return (time.perf_counter() - t0) / args.batches * 1e6

    run(False)
    run(True)
    live, bare = [], []
    for r in range(args.rounds):
        order = (False, True) if r % 2 == 0 else (True, False)
        for mode in order:
            (bare if mode else live).append(run(mode))
    set_mode(False)
    diffs = [a - b for a, b in zip(live, bare)]
    print(json.dumps({"events": n, "batches": args.batches, "rounds": args.rounds,
                      "live_us": statistics.median(live), "bare_us": statistics.median(bare),
                      "tracing_us": statistics.median(diffs),
                      "tracing_us_quartiles": statistics.quantiles(diffs, n=4)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
