"""`ig-tpu query` — fleet-wide historical range queries over sealed
sketch windows.

The live dashboard answers "what is happening"; this verb answers "what
was happening": cardinality, heavy hitters, and entropy for any seq/ts
range — whole-traffic or one subpopulation slice (`--key mntns:<ns>`,
`--key kind:<syscall>`, `--key 'mntns:<ns>|kind:<k>'`) — merged
client-side from whichever nodes' sealed windows overlap the range.

    ig-tpu-torch query --remote n0=...,n1=... --last 1h --key mntns:4026531840
    ig-tpu-torch query --history ./bundle-history --start-ts 1718000000 \
        --end-ts 1718003600 --slices
    ig-tpu-torch query --gadget trace/exec --last 1h --key mntns:4026531840

The port's copy of ``inspektor_gadget_tpu/cli/query.py``: the local
store, or with ``--remote`` the agents' (`GrpcRuntime.query_history`,
through the fleet aggregation tier with ``--topology``). One flag more,
``--archive-dir``: the archive root whose manifest rows a local query
rehydrates (the reference's agents hold it from ``--history-archive-dir``).
"""

from __future__ import annotations

import json
import sys
import time

from ..params.validators import parse_duration


def add_query_parser(sub) -> None:
    qp = sub.add_parser(
        "query", help="historical range queries over sealed sketch "
        "windows: cardinality / heavy hitters / entropy for a (key, "
        "time-range) slice, merged across nodes")
    qp.add_argument("--remote", default="",
                    help="fan out to agents: name=target[,...]; default: "
                         "the local history store")
    qp.add_argument("--history", default="",
                    help="local history directory to query (default: the "
                         "node area, $IG_HISTORY_DIR)")
    qp.add_argument("--archive-dir", default="",
                    help="archive root (filesystem backend) to rehydrate "
                         "offloaded segments from (local store only: agents "
                         "take theirs from --history-archive-dir)")
    qp.add_argument("--gadget", default="",
                    help="restrict to one gadget's windows, e.g. trace/exec")
    qp.add_argument("--start-ts", type=float, default=None,
                    help="range start (epoch seconds)")
    qp.add_argument("--end-ts", type=float, default=None,
                    help="range end (epoch seconds)")
    qp.add_argument("--last", default="",
                    help="relative range shorthand: 15m / 2h / 90s "
                         "(overrides --start-ts)")
    qp.add_argument("--start-seq", type=int, default=None)
    qp.add_argument("--end-seq", type=int, default=None)
    qp.add_argument("--key", default="",
                    help="subpopulation slice, e.g. mntns:4026531840, "
                         "kind:59, 'mntns:...|kind:59'")
    qp.add_argument("--slices", action="store_true",
                    help="also print every observed slice (default: only "
                         "--key's)")
    qp.add_argument("--top", type=int, default=10,
                    help="heavy hitters to print")
    qp.add_argument("--quantiles", action="store_true",
                    help="print the merged latency quantiles (p50/p90/"
                         "p99/p99.9) and a log2 ASCII histogram; needs "
                         "windows sealed with 'quantiles true'")
    qp.add_argument("--topology", default="",
                    help="route the fold through the fleet aggregation "
                         "tier: 'auto', 'auto:<fan_in>', or a declared "
                         "zone grammar like 'zone-a=n0,n1;zone-b=n2' "
                         "(byte-identical answer, O(log N) fan-in; "
                         "remote mode only)")
    qp.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    qp.set_defaults(func=cmd_query)


def cmd_query(args) -> int:
    from ..params import ParamError
    start_ts, end_ts = args.start_ts, args.end_ts
    if args.last:
        try:
            start_ts = time.time() - parse_duration(args.last)
        except ValueError:
            print(f"error: bad --last {args.last!r}", file=sys.stderr)
            return 2
    ranges = dict(gadget=args.gadget, start_ts=start_ts, end_ts=end_ts,
                  start_seq=args.start_seq, end_seq=args.end_seq)
    key = args.key or None
    # getattr: programmatic callers hand in plain namespaces that
    # predate the fleet tier; only the parser guarantees the attribute
    topology = getattr(args, "topology", "")

    if args.remote:
        from ..runtime.grpc_runtime import GrpcRuntime
        from .main import parse_targets
        try:
            targets = parse_targets(args.remote)
        except ParamError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        runtime = GrpcRuntime(targets)
        try:
            if topology:
                from ..fleet import TopologyError
                try:
                    answer = runtime.query_history(
                        key=key, top=args.top, topology=topology,
                        **ranges)
                except TopologyError as e:
                    print(f"error: {e}", file=sys.stderr)
                    return 2
            else:
                answer = runtime.query_history(key=key, top=args.top,
                                               **ranges)
        finally:
            runtime.close()
    else:
        if topology:
            print("error: --topology needs --remote (the aggregation "
                  "tier folds across agents)", file=sys.stderr)
            return 2
        from ..history import HISTORY, answer_query, decode_frames
        if getattr(args, "archive_dir", ""):
            HISTORY.set_archive(args.archive_dir, base_dir=args.history or None)
        losses: list = []
        frames = list(HISTORY.fetch_windows(
            base_dir=args.history or None, losses=losses, key=key, **ranges))
        dropped = [f"local: torn window tail ({loss.get('reason', '?')}, "
                   f"{loss.get('dropped_bytes', 0)} bytes)"
                   for loss in losses]
        answer = answer_query(decode_frames(frames), key=key, top=args.top,
                              dropped=dropped, paths={"local": "local"})

    if args.output == "json":
        print(json.dumps(answer.to_dict(), indent=2, default=str))
    else:
        _print_answer(answer, key=key, show_slices=args.slices,
                      top=args.top, quantiles=args.quantiles)
    for node, err in answer.errors.items():
        print(f"{node}: error: {err}", file=sys.stderr)
    if answer.windows == 0 and not answer.errors:
        print("no sealed windows overlap the range", file=sys.stderr)
    return 1 if answer.errors else 0


def render_histogram_log2(hist, *, width: int = 40) -> list[str]:
    """biolatency-style ASCII render of a log2 histogram: one line per
    non-empty slot range, `value range  count  distribution` (the
    reference's print_log2_hist shape). Values are the raw integer
    domain the value lane captured (ns for latency fields)."""
    rows = [(k, int(n)) for k, n in enumerate(hist) if int(n) > 0]
    if not rows:
        return []
    lo = min(k for k, _ in rows)
    hi = max(k for k, _ in rows)
    peak = max(n for _, n in rows)
    counts = {k: n for k, n in rows}
    out = []
    for k in range(lo, hi + 1):
        n = counts.get(k, 0)
        bar = "*" * max(1 if n else 0, round(width * n / peak))
        out.append(f"  [{2 ** k:>10,}, {2 ** (k + 1):>10,})  "
                   f"{n:>10,} |{bar:<{width}s}|")
    return out


def _print_quantiles(answer) -> None:
    qt = answer.quantiles
    if qt is None:
        print("quantiles: not available — no window in the range carries "
              "the quantile plane (run with 'quantiles true')")
        return
    print(f"latency quantiles (value-lane units, ddsketch "
          f"alpha={qt['alpha']:g}):")
    print(f"  p50={qt['p50']:,.0f} p90={qt['p90']:,.0f} "
          f"p99={qt['p99']:,.0f} p99.9={qt['p999']:,.0f}")
    print(f"  total={qt['total']:,} zeros={qt['zeros']:,} "
          f"underflow={qt['underflow']:,}")
    for line in render_histogram_log2(answer.histogram or []):
        print(line)


def _print_accuracy_audit(acc: dict) -> None:
    """Observed-error lines when the range was audited (windows carried
    the shadow sample): `stat  observed vs ±bound` per audited stat."""
    if not acc.get("audited"):
        return
    print(f"accuracy audit (shadow sample, {acc.get('sample_size', 0)} "
          f"key(s) of {acc.get('sample_capacity', 0)}):")
    for stat, row in sorted((acc.get("stats") or {}).items()):
        if not row.get("audited") or row.get("observed_err") is None:
            continue
        obs, bound = float(row["observed_err"]), row.get("bound")
        line = f"  {stat:<16s} observed err {obs:.5f}"
        if bound:
            line += f" vs bound {float(bound):.5f}"
        if stat == "heavy_hitters" and row.get("audited_keys"):
            line += f" ({row['audited_keys']} key(s) audited)"
        print(line)


def _print_answer(answer, *, key: str | None, show_slices: bool,
                  top: int, quantiles: bool = False) -> None:
    nodes = ",".join(answer.nodes) or "local"
    print(f"{answer.windows} window(s) [{nodes}] "
          f"ts {answer.start_ts:.3f} .. {answer.end_ts:.3f}")
    compacted = answer.compacted_windows()
    if compacted:
        # resolution loss must be visible, not a surprise: part of this
        # answer came from compacted (coarser) super-windows
        lvl_s = ", ".join(f"L{lvl}×{n}"
                          for lvl, n in sorted(answer.levels.items())
                          if lvl > 0)
        print(f"note: {compacted} of {answer.windows} window(s) were "
              f"compacted to coarser resolution ({lvl_s}) — time "
              "granularity inside those ranges is the tier's, not the "
              "native seal interval")
    fallback = sorted(n for n, p in answer.paths.items() if p == "fetch")
    if fallback:
        print(f"note: node(s) {', '.join(fallback)} answered via "
              "list+fetch fallback (pre-pushdown agent)")
    if answer.fleet:
        fl = answer.fleet
        print(f"merge tree: depth {fl['depth']}, fan-in {fl['fan_in']}, "
              f"{fl['aggregators']} aggregator(s), "
              f"{fl['subtree_folds']} subtree fold(s)")
        if fl.get("fallback"):
            print(f"note: aggregator(s) {', '.join(fl['fallback'])} "
                  "unreachable or crashed mid-fold — their subtrees "
                  "were re-folded flat from the leaves (exactly-once; "
                  "answer unchanged)")
        flat = sorted(n for n, p in answer.paths.items()
                      if p == "flat-fallback")
        if flat:
            print(f"note: leaf/leaves {', '.join(flat)} answered via "
                  "the flat fallback path")
    # error envelopes (accuracy audit plane): analytic bounds ride every
    # answer; ± annotations draw from them inline
    acc = answer.accuracy or {}
    astats = acc.get("stats") or {}
    d_bound = (astats.get("distinct") or {}).get("bound")
    e_bound = (astats.get("entropy") or {}).get("bound")
    line = (f"events={answer.events:,} drops={answer.drops} "
            f"distinct≈{answer.distinct:,.0f}")
    if d_bound is not None:
        line += f" (±{d_bound * 100:.2f}%)"
    line += f" entropy={answer.entropy_bits:.2f}b"
    if e_bound is not None:
        line += f" (bias ≤{e_bound:.3f}b)"
    print(line)
    if answer.approx:
        # the seal-boundary taint: at least one
        # consulted window's top-k candidate population exceeded k
        print("note: heavy-hitter ranks are approximate — a consulted "
              "window overflowed its top-k candidate ring")
    if answer.heavy_hitters:
        hh_env = astats.get("heavy_hitters") or {}
        hdr = "heavy hitters"
        if hh_env.get("bound_abs") is not None:
            hdr += (f" (overestimate ≤ {hh_env['bound_abs']:,.0f} per "
                    f"count @ {hh_env.get('confidence', 0.0):.0%} "
                    f"confidence)")
        print(hdr + ":")
        for k32, count, label in answer.heavy_hitters[:top]:
            print(f"  {label:<24s}  {count:>12,}")
    _print_accuracy_audit(acc)
    if answer.heavy_flows:
        inv = answer.inv or {}
        cov = ("complete" if inv.get("complete")
               else f"partial ({inv.get('residual_events', 0)} events "
                    "undecoded)")
        print(f"heavy flows (invertible decode, exact counts, {cov}):")
        for k32, count, label in answer.heavy_flows[:top]:
            print(f"  {label:<24s}  {count:>12,}")
        if answer.decoded_only:
            # the observable win over the candidate ring: keys recovered
            # from merged state that no node's tracker ever surfaced
            print(f"decode recovered {len(answer.decoded_only)} key(s) "
                  "the candidate ring missed:")
            for k32, count, label in answer.decoded_only[:top]:
                print(f"  {label:<24s}  {count:>12,}")
    if quantiles:
        _print_quantiles(answer)
    wanted = ([key] if key else
              (sorted(answer.slices) if show_slices else []))
    for skey in wanted:
        s = answer.slices.get(skey)
        if s is None:
            print(f"slice {skey}: not observed in the range")
            continue
        print(f"slice {skey}: events={s['events']:,} "
              f"distinct≈{s['distinct']:,.0f} "
              f"entropy={s['entropy_bits']:.2f}b")
        for hh in s["heavy_hitters"][:top]:
            print(f"  {hh['label']:<24s}  {hh['count']:>12,}")
    for why in answer.dropped_windows:
        print(f"dropped: {why}", file=sys.stderr)
