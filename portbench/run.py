"""Run one cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``compared``: each number the
comparison with the reference held against its limit. The same numbers
are the last lines of standard error. Without a card, or with fewer
cards than the cell asks for, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "inspektor_gadget_tpu")


def _cache_dirs() -> None:
    """Every kernel cache inside the checkout, at a fixed path."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def execute(spec, cell: str, seed: int, seconds: float, trace: bool, device: str,
            t_proc0: float, **kw) -> tuple[dict, list]:
    """One run: (result line, [(name, value, limit)] compared)."""
    from .check import compare
    from .harness import Run
    run = Run(spec, cell, seed, seconds, trace=trace, device=device, t_proc0=t_proc0, **kw)
    res = run.execute()
    obs = res["obs"]
    ok, rows = compare(res["prog"], run.judge(res["prog"]), run.cell["limits"])
    metrics = {}
    for m in spec.metrics_for(cell, trace):
        v = spec.reader(m["name"])(obs)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    import torch
    dev = {"platform": "gpu" if run.cuda else "cpu",
           "kind": torch.cuda.get_device_name(run.dev) if run.cuda else "cpu",
           "count": int(run.cell["chips"]) if run.cuda else 0,
           "memory_peak_bytes": int(res["peak"])}
    attempted, failed = run.attempted_failed(obs)
    line = {"correct": bool(ok), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    prof = obs.get("profile")
    if trace and prof and prof.get("kernels"):
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        line["breakdown"] = {"device_ops": [[n, s] for n, s in prof["device_ops"]],
                             "idle_gaps": prof["idle_gaps"]}
    line["timings"] = {"reference_s": run.reference_s}
    line["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return line, rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    from .spec import Spec
    spec = Spec(ROOT / "BENCHMARK.json")
    chips = int(spec.cell(args.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, rows = execute(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_PROC0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v, lim in rows:
        print(f"compared {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
