"""`ig-tpu-torch bench`: the perf verbs (the port's copy of
``inspektor_gadget_tpu/cli/bench.py``).

run      stage-segmented harness run → PerfRecord → ledger (+ optional
         Chrome-trace attachment of the run)
compare  newest record per series vs a noise-aware baseline from the
         last K same-config NON-degraded records; exit 1 on regression,
         exit 3 when a claim made on the card (or a TPU) has only
         degraded or other-platform history (refused)
report   ledger history rendered through the column system
import   seed the ledger from BENCH_r*.json artifacts

`run --device {cuda,cpu}` (default cuda) takes the place of the
reference's `--platform`: cuda without a card exits 1 with
`resolve_device`'s message and writes nothing. The ledger is --ledger,
else $IG_TPU_TORCH_PERF_LEDGER, else ig-tpu-torch/PERF.jsonl in the
user's state directory (`perf/ledger.py`).
"""

from __future__ import annotations

import argparse
import glob
import json
import sys


def add_bench_parser(sub) -> None:
    bp = sub.add_parser("bench", help="perf harness, ledger, regression "
                        "gates (run / compare / report / import)")
    bp.set_defaults(func=lambda a: (bp.print_help(), 0)[1])
    bsub = bp.add_subparsers(dest="bench_verb")

    def _ledger_arg(p):
        p.add_argument("--ledger", default=None,
                       help="perf ledger path (default $IG_TPU_TORCH_PERF_LEDGER, "
                            "else ig-tpu-torch/PERF.jsonl in the user's state directory)")

    rp = bsub.add_parser("run", help="run the stage-segmented harness and "
                         "append a provenance-stamped PerfRecord")
    rp.add_argument("--config", default="e2e",
                    help="harness config (e2e, e2e-prod, tiny)")
    rp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the run (no fallback: cuda without a card fails)")
    rp.add_argument("--seconds", type=float, default=None,
                    help="override the config's measurement window")
    rp.add_argument("--probe-timeout", type=float, default=None)
    rp.add_argument("--probe-attempts", type=int, default=None)
    rp.add_argument("--probe-horizon", type=float, default=None,
                    help="seconds the probe retries are spread over")
    rp.add_argument("--trace-out", default="",
                    help="also write a Chrome trace of the run here")
    rp.add_argument("--replay", default="",
                    help="feed the harness a capture journal instead of "
                         "the synthetic source (reproducible input; the "
                         "journal digest lands in the record provenance)")
    rp.add_argument("--pipeline", default="fused",
                    choices=["fused", "classic", "sharded"],
                    help="hot-path shape: fused (pop_folded->h2d_overlap->"
                         "fused_update, default), classic (pop->decode->"
                         "enrich->fold32->h2d->bundle_update), or sharded "
                         "(pop_folded->h2d_lanes->sharded_update over N "
                         "device lanes); all append to the same ledger "
                         "series, extra.pipeline/extra.chips say which "
                         "shape/scale ran")
    rp.add_argument("--chips", type=int, default=1,
                    help="device lanes for pipeline=sharded (1..local "
                         "device count; extra.chips names the scale point)")
    rp.add_argument("--invertible", action="store_true",
                    help="enable the invertible heavy-key plane in the "
                         "measured bundle (more K2 planes on the fused "
                         "path; adds inv_update/inv_decode stages; "
                         "extra.invertible marks the record, series "
                         "unforked)")
    rp.add_argument("--quantiles", action="store_true",
                    help="enable the DDSketch latency quantile plane in "
                         "the measured bundle (fused pipeline only: the "
                         "value lane rides the staging block; adds a "
                         "qt_update stage; extra.quantiles marks the "
                         "record, series unforked)")
    rp.add_argument("--no-ledger", action="store_true",
                    help="print the record without appending it")
    rp.add_argument("-o", "--output", default="json",
                    choices=["json", "summary"])
    _ledger_arg(rp)
    rp.set_defaults(func=cmd_bench_run)

    cp = bsub.add_parser("compare", help="gate the newest record per series "
                         "against its noise-aware ledger baseline")
    cp.add_argument("--config", action="append", default=[],
                    help="restrict to these configs (repeatable)")
    cp.add_argument("--k", type=int, default=5,
                    help="baseline pool size (last K non-degraded records)")
    cp.add_argument("--band", type=float, default=0.15,
                    help="relative noise band floor (0.15 = ±15%%)")
    cp.add_argument("--candidate-file", default="",
                    help="compare this record/BENCH JSON file instead of "
                         "the ledger's newest records")
    _ledger_arg(cp)
    cp.set_defaults(func=cmd_bench_compare)

    pp = bsub.add_parser("report", help="render ledger history (column "
                         "system)")
    pp.add_argument("--last", type=int, default=10)
    pp.add_argument("--config", action="append", default=[])
    pp.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    _ledger_arg(pp)
    pp.set_defaults(func=cmd_bench_report)

    ip = bsub.add_parser("import", help="import BENCH_r*.json artifacts into "
                         "the ledger (idempotent)")
    ip.add_argument("paths", nargs="*", default=[],
                    help="files or globs (default: BENCH_r*.json)")
    _ledger_arg(ip)
    ip.set_defaults(func=cmd_bench_import)


def cmd_bench_run(args) -> int:
    from ..perf import append_record, ledger_path, run_harness
    try:
        rec = run_harness(
            args.config, device=args.device, seconds=args.seconds,
            probe_timeout=args.probe_timeout,
            probe_attempts=args.probe_attempts,
            probe_horizon=args.probe_horizon,
            trace_out=args.trace_out or None,
            replay=args.replay or None,
            pipeline=args.pipeline,
            chips=args.chips,
            invertible=args.invertible,
            quantiles=args.quantiles)
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:  # no card, a failed probe, a kernel that did not launch
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not args.no_ledger:
        path = append_record(rec, args.ledger)
        print(f"appended to {path}", file=sys.stderr)
        # fused runs carry per-stage lag and starvation accounting: the
        # device-plane p99 lag is its own `.pipeline-lag` series, so
        # `bench compare` gates lag regressions (unit seconds →
        # lower_better) alongside throughput
        stage_lag = (rec.get("extra") or {}).get("stage_lag") or {}
        if "h2d" in stage_lag:
            from ..perf.schema import make_record
            lag_rec = make_record(
                config=f"{rec['config']}.pipeline-lag",
                metric="pipeline_device_lag_p99",
                unit="seconds",
                value=stage_lag["h2d"]["p99_s"],
                stages={},
                provenance=rec["provenance"],
                extra={
                    "starved_fraction":
                        rec["extra"].get("starved_fraction", 0.0),
                    "stall_s": rec["extra"].get("stall_s", 0.0),
                    "stage_lag": stage_lag,
                    "source_config": rec["config"],
                })
            append_record(lag_rec, args.ledger)
            print(f"appended {lag_rec['config']} "
                  f"(p99 {lag_rec['value']:.9f}s, starved "
                  f"{lag_rec['extra']['starved_fraction']:.0%})",
                  file=sys.stderr)
    else:
        print(f"not appended (--no-ledger); would use "
              f"{ledger_path(args.ledger)}", file=sys.stderr)
    if args.output == "json":
        print(json.dumps(rec, sort_keys=True))
    else:
        prov = rec["provenance"]
        print(f"{rec['config']}: {rec['value']:,.1f} {rec['unit']} on "
              f"{prov['platform']}"
              + (" (DEGRADED)" if prov["degraded"] else ""))
        for name, st in rec["stages"].items():
            desc = ", ".join(f"{k}={v:,}" for k, v in st.items())
            print(f"  {name:14s} {desc}")
    return 0


def cmd_bench_compare(args) -> int:
    from ..perf import read_ledger
    from ..perf.compare import (
        RC_USAGE, compare_ledger, compare_record, render_compare,
    )
    from ..perf.ledger import bench_json_to_record
    from ..perf.schema import validate_record
    lr = read_ledger(args.ledger)
    for s in lr.skipped:
        print(f"warning: ledger {s}", file=sys.stderr)
    if args.candidate_file:
        try:
            with open(args.candidate_file, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: {args.candidate_file}: {e}", file=sys.stderr)
            return RC_USAGE
        if validate_record(doc):
            # not a PerfRecord — try the BENCH artifact's shape
            try:
                doc = bench_json_to_record(doc, source=args.candidate_file)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return RC_USAGE
        results = [compare_record(doc, lr.records, k=args.k, band=args.band)]
    else:
        if not lr.records:
            print("perf ledger is empty — nothing to compare",
                  file=sys.stderr)
            return 0
        results = compare_ledger(lr.records, configs=args.config or None,
                                 k=args.k, band=args.band)
    print(render_compare(results))
    return max((r.rc for r in results), default=0)


def cmd_bench_report(args) -> int:
    from ..perf import read_ledger, render_report
    lr = read_ledger(args.ledger)
    for s in lr.skipped:
        print(f"warning: ledger {s}", file=sys.stderr)
    if args.output == "json":
        recs = [r for r in lr.records
                if not args.config or r.get("config") in args.config]
        print(json.dumps(recs[-args.last:] if args.last else recs,
                         sort_keys=True))
        return 0
    print(render_report(lr.records, last=args.last,
                        configs=args.config or None))
    return 0


def cmd_bench_import(args) -> int:
    from ..perf import import_bench_files
    paths: list[str] = []
    for pat in (args.paths or ["BENCH_r*.json"]):
        hits = sorted(glob.glob(pat))
        paths.extend(hits if hits else [pat])
    n, skipped = import_bench_files(paths, args.ledger)
    for s in skipped:
        print(f"skipped {s}", file=sys.stderr)
    print(f"imported {n} record(s)")
    return 0


def main(argv: list[str] | None = None) -> int:
    """Standalone entry (python -m inspektor_gadget_tpu_torch.cli.bench ...)."""
    ap = argparse.ArgumentParser(prog="ig-tpu-torch bench")
    sub = ap.add_subparsers()
    add_bench_parser(sub)
    args = ap.parse_args(["bench", *(argv if argv is not None
                                     else sys.argv[1:])])
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
