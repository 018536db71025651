"""The readings a cell's limits are set from, in one process: the
program on each of `--seeds` (the lower readings: each number its
largest over the seeds) and the control, the reference in bfloat16 put
in the program's place, on each of `--control-seeds` (the upper
readings: each number its smallest). Writes every reading as JSON.

    python3 -m portbench.limits --workload <cell> --seconds 8 \\
        --seeds 1,2,3 --control-seeds 4,5,6 --out chiprun_out/limits.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .check import compare
from .harness import Run
from .run import ROOT, _cache_dirs
from .spec import Spec


def readings_for(spec: Spec, cell: str, seed: int, seconds: float, *, control: bool,
                 device: str = "cuda") -> dict:
    run = Run(spec, cell, seed, seconds, device=device)
    res = run.execute()
    ref = run.judge(res["prog"])
    judged = run.judge(res["prog"], control=True) if control else res["prog"]
    ok, rows = compare(judged, ref, run.cell["limits"])
    return {"seed": seed, "control": control, "correct": ok,
            "numbers": {name: v for name, v, _ in rows}}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _cache_dirs()
    spec = Spec(ROOT / "BENCHMARK.json")
    out = []
    for seeds, control in ((args.seeds, False), (args.control_seeds, True)):
        for s in (int(x) for x in seeds.split(",") if x):
            t = time.perf_counter()
            r = readings_for(spec, args.workload, s, args.seconds, control=control, device=args.device)
            r["seconds"] = time.perf_counter() - t
            print(json.dumps(r), flush=True)
            out.append(r)
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload, "readings": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
