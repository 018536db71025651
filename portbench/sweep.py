"""Find the highest rate an open-loop cell sustains: run the cell's
program at each offered rate in one process and report, a rate, the
chunks dropped, the queue's depth over the window's first and last
thirds, the p95 and p99 fold latency, the summary lag and the mean
queue wait. No output check.

    python3 -m portbench.sweep --workload <cell> --rates 1e6,2e6 --seconds 10 --seed 1
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from . import readings
from .harness import Run
from .run import ROOT, _cache_dirs
from .spec import Spec


def sweep_point(spec: Spec, cell: str, rate: float, seconds: float, seed: int,
                device: str = "cuda") -> dict:
    run = Run(spec, cell, seed, seconds, device=device,
              traffic_overrides={"rate_events_per_s": rate})
    obs = run.execute()["obs"]
    depth = [d for _, d in obs["queue_depth"]]
    third = max(len(depth) // 3, 1)
    return {"rate": rate, "dropped": obs["chunks"]["dropped"],
            "offered": len(obs["chunks"]["due"]),
            "depth_first_third": statistics.fmean(depth[:third]) if depth else 0.0,
            "depth_last_third": statistics.fmean(depth[-third:]) if depth else 0.0,
            "p95_ms": readings.fold_latency_ms(obs, 0.95),
            "p99_ms": readings.fold_latency_ms(obs, 0.99),
            "summary_lag_ms": readings.summary_lag_ms(obs),
            "queue_wait_ms": readings.queue_wait_ms(obs),
            "pops": len(obs["batches"]),
            "operator_ms": readings.histogram_ms(obs, "enrich"),
            "harvest_ms": readings.histogram_ms(obs, "harvest")}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _cache_dirs()
    spec = Spec(ROOT / "BENCHMARK.json")
    for rate in (float(r) for r in args.rates.split(",")):
        print(json.dumps(sweep_point(spec, args.workload, rate, args.seconds, args.seed, device=args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
