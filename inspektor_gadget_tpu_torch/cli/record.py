"""`ig-tpu record` + `ig-tpu replay` — the capture/replay verbs.

record start    arm a recording on every agent (or this process): all
                running and future gadget runs tee into journals
record stop     seal the journals; --fetch pulls them into one bundle
record list     active + on-disk recordings per node
record inspect  per-journal stats of one recording / journal / bundle
                (record counts by type, seq/ts ranges, torn-tail loss,
                content digest)
record fetch    pull a stopped recording's per-node journals into one
                client-side bundle directory

replay <path>   re-drive a journal (or every journal of a recording /
                bundle) through the real operator chain on the recorded
                clock; --verify exits 1 unless the replayed summary
                digests and alert transitions reproduce the recording

The port's copy of ``inspektor_gadget_tpu/cli/record.py``; `replay` takes
``--device {cuda,cpu}`` (default ``cuda``, no fallback).
"""

from __future__ import annotations

import json
import os
import sys


def add_record_parser(sub) -> None:
    rp = sub.add_parser("record", help="capture-plane recording lifecycle: "
                        "start / stop / list / inspect / fetch")
    rp.set_defaults(func=lambda a: (rp.print_help(), 0)[1])
    rsub = rp.add_subparsers(dest="record_verb")

    def _remote_arg(p):
        p.add_argument("--remote", default="",
                       help="name=target[,...]; defaults to the local "
                            "fleet, else this process")

    sp = rsub.add_parser("start", help="arm a recording (agents via RPC, "
                         "or this process when no agents)")
    sp.add_argument("--id", required=True, help="recording id")
    _remote_arg(sp)
    sp.add_argument("--max-segment-bytes", type=int, default=None)
    sp.add_argument("--max-segment-age", type=float, default=None)
    sp.add_argument("--retention-bytes", type=int, default=None)
    sp.add_argument("--retention-segments", type=int, default=None)
    sp.set_defaults(func=cmd_record_start)

    tp = rsub.add_parser("stop", help="seal a recording's journals")
    tp.add_argument("--id", required=True)
    _remote_arg(tp)
    tp.add_argument("--fetch", default="",
                    help="also pull every node's journals into this "
                         "bundle directory")
    tp.set_defaults(func=cmd_record_stop)

    lp = rsub.add_parser("list", help="recordings per node")
    _remote_arg(lp)
    lp.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    lp.set_defaults(func=cmd_record_list)

    ip = rsub.add_parser("inspect", help="stats of a recording id or a "
                         "journal/recording/bundle path")
    ip.add_argument("target", help="recording id, or a path to a journal/"
                    "recording/bundle directory")
    _remote_arg(ip)
    ip.set_defaults(func=cmd_record_inspect)

    fp = rsub.add_parser("fetch", help="pull a recording's per-node "
                         "journals into one bundle")
    fp.add_argument("--id", required=True)
    fp.add_argument("--dest", required=True, help="bundle directory")
    _remote_arg(fp)
    fp.set_defaults(func=cmd_record_fetch)


def add_replay_parser(sub) -> None:
    pp = sub.add_parser("replay", help="re-drive a recorded journal "
                        "through the real operator chain (enrich → "
                        "tpusketch → alerts) on the recorded clock")
    pp.add_argument("path", help="journal, recording, or bundle directory")
    pp.add_argument("--speed", type=float, default=0.0,
                    help="pace: 0 = as fast as possible (default), "
                         "1 = recorded pace, 10 = 10x")
    pp.add_argument("--rules-file", default="",
                    help="replace the recorded alert rules with this file")
    pp.add_argument("--verify", action="store_true",
                    help="exit 1 unless replayed summary digests and "
                         "alert transitions reproduce the recording")
    pp.add_argument("-o", "--output", default="summary",
                    choices=["summary", "json"])
    pp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device the replay refolds the recorded batches on "
                         "(no fallback: cuda without a card fails)")
    pp.set_defaults(func=cmd_replay)


def _targets(args) -> dict[str, str]:
    from .deploy import local_targets
    from .main import parse_targets
    return parse_targets(args.remote) if args.remote else local_targets()


def _start_opts(args) -> dict:
    opts = {}
    for flag, key in (("max_segment_bytes", "max_segment_bytes"),
                      ("max_segment_age", "max_segment_age"),
                      ("retention_bytes", "retention_bytes"),
                      ("retention_segments", "retention_segments")):
        v = getattr(args, flag, None)
        if v is not None:
            opts[key] = v
    return opts


def cmd_record_start(args) -> int:
    from ..params import ParamError
    try:
        targets = _targets(args)
    except ParamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not targets:
        # no agents: arm this process's own manager (local gadget runs)
        from ..capture import RECORDINGS
        try:
            rec = RECORDINGS.start(args.id, **_start_opts(args))
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"recording {rec.id} started (local) -> {rec.path}")
        return 0
    from ..runtime.grpc_runtime import GrpcRuntime
    runtime = GrpcRuntime(targets)
    try:
        results, errors = runtime.start_recording(args.id,
                                                  opts=_start_opts(args))
    finally:
        runtime.close()
    for node, res in results.items():
        print(f"{node}: recording {args.id} started -> {res.get('dir', '')}")
    for node, err in errors.items():
        print(f"{node}: error: {err}", file=sys.stderr)
    return 1 if errors else 0


def cmd_record_stop(args) -> int:
    from ..params import ParamError
    try:
        targets = _targets(args)
    except ParamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not targets:
        from ..capture import RECORDINGS
        try:
            meta = RECORDINGS.stop(args.id)
        except KeyError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"recording {args.id} stopped: "
              f"{len(meta.get('journals', []))} journal(s)")
        return 0
    from ..runtime.grpc_runtime import GrpcRuntime
    runtime = GrpcRuntime(targets)
    try:
        results, errors = runtime.stop_recording(args.id)
        for node, res in results.items():
            js = (res.get("recording") or {}).get("journals", [])
            print(f"{node}: recording {args.id} stopped "
                  f"({len(js)} journal(s))")
        for node, err in errors.items():
            print(f"{node}: error: {err}", file=sys.stderr)
        if args.fetch:
            bundle = runtime.fetch_recording(args.id, args.fetch)
            _print_bundle(bundle, args.fetch)
            errors.update(bundle.get("errors") or {})
    finally:
        runtime.close()
    return 1 if errors else 0


def _print_bundle(bundle: dict, dest: str) -> None:
    for node, st in (bundle.get("nodes") or {}).items():
        print(f"{node}: fetched {st['files']} file(s), {st['bytes']:,} bytes")
    for node, err in (bundle.get("errors") or {}).items():
        print(f"{node}: fetch error: {err}", file=sys.stderr)
    print(f"bundle -> {dest}")


def cmd_record_list(args) -> int:
    from ..params import ParamError
    try:
        targets = _targets(args)
    except ParamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    tables: dict[str, list[dict]] = {}
    rc = 0
    if not targets:
        from ..capture import RECORDINGS
        tables["local"] = RECORDINGS.list()
    else:
        from ..runtime.grpc_runtime import GrpcRuntime
        runtime = GrpcRuntime(targets)
        try:
            results, errors = runtime.list_recordings()
        finally:
            runtime.close()
        for node, res in results.items():
            tables[node] = res.get("recordings") or []
        for node, err in errors.items():
            print(f"{node}: error: {err}", file=sys.stderr)
            rc = 1
    if args.output == "json":
        print(json.dumps(tables, indent=2, default=str))
        return rc
    printed = False
    for node, recs in tables.items():
        for r in recs:
            if not printed:
                print(f"{'NODE':<12s} {'ID':<20s} {'STATE':<10s} PATH")
                printed = True
            print(f"{node:<12s} {r.get('id', ''):<20s} "
                  f"{r.get('state', ''):<10s} {r.get('path', '')}")
    if not printed:
        print("no recordings")
    return rc


def cmd_record_inspect(args) -> int:
    from ..capture import JournalReader, RECORDINGS, is_journal, iter_journals
    target = args.target
    if os.path.isdir(target):
        if is_journal(target):
            print(json.dumps(JournalReader(target).stats(), indent=2,
                             default=str))
            return 0
        journals = {j: JournalReader(j).stats() for j in iter_journals(target)}
        if not journals:
            print(f"error: no journals under {target}", file=sys.stderr)
            return 2
        print(json.dumps({"path": target, "journals": journals}, indent=2,
                         default=str))
        return 0
    # a recording id: local manager first, then agents
    try:
        print(json.dumps(RECORDINGS.inspect(target), indent=2, default=str))
        return 0
    except (FileNotFoundError, ValueError):
        pass
    from ..params import ParamError
    try:
        targets = _targets(args)
    except ParamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not targets:
        print(f"error: no recording {target!r} locally and no agents",
              file=sys.stderr)
        return 2
    from ..runtime.grpc_runtime import GrpcRuntime
    runtime = GrpcRuntime(targets)
    try:
        results, errors = runtime.list_recordings(target)
    finally:
        runtime.close()
    out = {node: res for node, res in results.items()}
    for node, err in errors.items():
        out[node] = {"error": err}
    print(json.dumps(out, indent=2, default=str))
    return 1 if errors else 0


def cmd_record_fetch(args) -> int:
    from ..params import ParamError
    try:
        targets = _targets(args)
    except ParamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not targets:
        print("no agents (use deploy --local N or --remote)", file=sys.stderr)
        return 2
    from ..runtime.grpc_runtime import GrpcRuntime
    runtime = GrpcRuntime(targets)
    try:
        bundle = runtime.fetch_recording(args.id, args.dest)
    finally:
        runtime.close()
    _print_bundle(bundle, args.dest)
    return 1 if bundle.get("errors") else 0


def cmd_replay(args) -> int:
    from ..capture import iter_journals, replay_journal
    if not os.path.isdir(args.path):
        print(f"error: {args.path}: not a directory", file=sys.stderr)
        return 2
    journals = list(iter_journals(args.path))
    if not journals:
        print(f"error: no journals under {args.path}", file=sys.stderr)
        return 2
    rc = 0
    reports = []
    for jpath in journals:
        def on_summary(s, _jpath=jpath):
            if args.output == "summary":
                print(f"[{os.path.basename(_jpath)}] epoch {s.get('epoch')}: "
                      f"events={s.get('events'):,} "
                      f"distinct≈{s.get('distinct', 0):,.0f} "
                      f"entropy={s.get('entropy', 0):.2f}b")

        def on_alert(a, _jpath=jpath):
            if args.output == "summary":
                key = f" key={a['key']}" if a.get("key") else ""
                print(f"[{os.path.basename(_jpath)}] !! {a.get('rule')} -> "
                      f"{a.get('transition')}{key} "
                      f"value={a.get('value', 0):.6g}")

        try:
            res = replay_journal(
                jpath, speed=args.speed,
                rules_file=args.rules_file or None,
                on_summary=on_summary, on_alert=on_alert,
                device=args.device)
        except (RuntimeError, FileNotFoundError, ValueError) as e:
            print(f"error: {jpath}: {e}", file=sys.stderr)
            rc = 1
            continue
        verified = res.digests_match and res.alerts_match
        reports.append({
            "journal": jpath,
            "records": res.records,
            "batches": res.batches,
            "events": res.events,
            "harvests": len(res.digests),
            "digests": res.digests,
            "recorded_digests": res.recorded_digests,
            "digests_match": res.digests_match,
            "alerts": len(res.alerts),
            "alerts_match": res.alerts_match,
            "losses": res.losses,
        })
        if args.output == "summary":
            print(f"{jpath}: {res.batches} batches / {res.events:,} events "
                  f"/ {len(res.digests)} harvests / {len(res.alerts)} "
                  f"transitions"
                  + (f"; {len(res.losses)} torn segment(s) dropped"
                     if res.losses else "")
                  + (f"; verify={'ok' if verified else 'MISMATCH'}"
                     if args.verify else ""))
        if args.verify and not verified:
            rc = 1
    if args.output == "json":
        print(json.dumps(reports, indent=2, default=str))
    return rc
