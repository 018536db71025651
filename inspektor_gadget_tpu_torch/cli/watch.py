"""`ig-tpu watch` — live standing-query answers.

`query` asks once; `watch` rides a registered standing query: the node
folds each sealed window into the materialized answer at seal time and
publishes it on the summary tier, so this verb renders refreshes as
they land — no per-refresh range recompute anywhere.

    ig-tpu-torch watch --remote n0=...,n1=... --id hot-tenants
    ig-tpu-torch watch --remote ... --id hot-tenants --json --iterations 10
    ig-tpu-torch watch --list --remote ...        # accounting rows per node
    ig-tpu-torch watch --local --id hot-tenants   # in-process engine read

The port's copy of ``inspektor_gadget_tpu/cli/watch.py``.
"""

from __future__ import annotations

import json
import sys
import threading
import time

from .query import _print_answer


def add_watch_parser(sub) -> None:
    wp = sub.add_parser(
        "watch", help="live standing-query answers: render a registered "
        "query's materialized answer as each seal tick refreshes it")
    wp.add_argument("--id", default="",
                    help="standing query id to watch (as registered via "
                         "the 'standing-queries' param)")
    wp.add_argument("--remote", default="",
                    help="fan out to agents: name=target[,...]; defaults "
                         "to the local fleet")
    wp.add_argument("--local", action="store_true",
                    help="read the in-process live engine instead of "
                         "subscribing to agents (embedded runs)")
    wp.add_argument("--list", action="store_true", dest="list_queries",
                    help="one accounting row per live standing query "
                         "(coverage, refreshes, cache hit/miss) instead "
                         "of watching one")
    wp.add_argument("--gadget", default="",
                    help="restrict to one gadget's shared run "
                         "(category/name)")
    wp.add_argument("--run", default="",
                    help="attach to one specific run id")
    wp.add_argument("--json", action="store_true",
                    help="stream one JSON object per refresh instead of "
                         "the live table")
    wp.add_argument("--iterations", type=int, default=0,
                    help="stop after N refreshes (0 = until interrupted)")
    wp.add_argument("--duration", type=float, default=0.0,
                    help="stop after S seconds (0 = until interrupted)")
    wp.add_argument("--deadline", type=float, default=3.0,
                    help="per-agent RPC deadline for --list (seconds)")
    wp.add_argument("--interval", type=float, default=1.0,
                    help="poll interval for --local mode (seconds)")
    wp.add_argument("--top", type=int, default=10,
                    help="heavy hitters to print")
    wp.add_argument("--quantiles", action="store_true",
                    help="also print merged latency quantiles")
    wp.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    wp.set_defaults(func=cmd_watch)


def _render_refresh(answer, meta: dict, *, args, n: int) -> None:
    if args.json:
        print(json.dumps({"refresh": n, "meta": meta,
                          "answer": answer.to_dict()}, default=str),
              flush=True)
        return
    node_bits = ", ".join(
        f"{node} tick {info.get('tick', 0)} "
        f"({info.get('windows', 0)}w)"
        for node, info in sorted((meta.get("nodes") or {}).items()))
    print(f"-- refresh #{n} [{meta.get('id', '')}] {node_bits}")
    _print_answer(answer, key=None, show_slices=False, top=args.top,
                  quantiles=args.quantiles)
    print(flush=True)


def _watch_remote(args, targets: dict) -> int:
    from ..runtime.grpc_runtime import GrpcRuntime
    stop = threading.Event()
    count = [0]

    def on_answer(answer, meta):
        count[0] += 1
        _render_refresh(answer, meta, args=args, n=count[0])
        if args.iterations and count[0] >= args.iterations:
            stop.set()

    if args.duration:
        timer = threading.Timer(args.duration, stop.set)
        timer.daemon = True
        timer.start()
    runtime = GrpcRuntime(targets)
    try:
        results = runtime.subscribe_query(
            query_id=args.id, gadget=args.gadget, run_id=args.run,
            on_answer=on_answer, stop_event=stop)
    finally:
        runtime.close()
    errs = {n: r["error"] for n, r in sorted(results.items())
            if r.get("error")}
    for node, err in errs.items():
        print(f"{node}: error: {err}", file=sys.stderr)
    if count[0] == 0 and errs:
        return 1
    return 0


def _watch_local(args) -> int:
    from ..history import answer_query
    from ..history.query import unpack_frames
    from ..history.window import decode_window
    from ..queries import live_engines

    deadline = (time.time() + args.duration) if args.duration else None
    n = 0
    last_cov = None
    while True:
        engines = [(rid, eng) for rid, eng in live_engines()
                   if (not args.run or rid == args.run)
                   and args.id in eng.specs]
        if not engines:
            print(f"no live engine registers query {args.id!r}",
                  file=sys.stderr)
            return 1
        rid, eng = engines[0]
        got = eng.read(args.id)
        if got is not None:
            header, payload, cached = got
            if header.get("coverage_digest") != last_cov:
                last_cov = header.get("coverage_digest")
                n += 1
                frames, _dropped = unpack_frames(payload)
                win = decode_window(*frames[0])
                answer = answer_query(
                    [win], key=(header.get("key") or None),
                    top=int(header.get("top", args.top)))
                meta = {"id": args.id, "run_id": rid,
                        "cached": bool(cached),
                        "nodes": {header.get("node", "local"): {
                            "tick": header.get("tick", 0),
                            "windows": header.get("windows", 0),
                            "coverage_digest": last_cov}}}
                _render_refresh(answer, meta, args=args, n=n)
        if args.iterations and n >= args.iterations:
            return 0
        if deadline is not None and time.time() >= deadline:
            return 0
        time.sleep(max(args.interval, 0.01))


def _list_queries(args, targets: dict | None) -> int:
    rows: list[dict] = []
    errors: dict[str, str] = {}
    if args.local or not targets:
        from ..queries import live_stats
        rows = [{"node": "local", **row} for row in live_stats()]
    else:
        from ..agent.client import AgentClient
        for node, target in targets.items():
            client = None
            try:
                client = AgentClient(target, node,
                                     rpc_deadline=args.deadline)
                for row in (client.dump_state().get("standing_queries")
                            or []):
                    rows.append({"node": node, **row})
            except Exception as e:  # noqa: BLE001 — per-node isolation
                errors[node] = str(e)
            finally:
                if client is not None:
                    client.close()
    if args.output == "json" or args.json:
        print(json.dumps({"queries": rows, "errors": errors}, indent=2,
                         default=str))
        return 0 if not errors else 1
    print(f"{'NODE':<10s} {'QUERY':<18s} {'STATS':<28s} {'RANGE':>8s} "
          f"{'WIN':>4s} {'EVENTS':>12s} {'TICKS':>6s} {'PUB':>5s} "
          f"{'CACHE h/m/i':>12s}")
    for r in rows:
        if "error" in r and "id" not in r:
            print(f"{r.get('node', '?'):<10s} error: {r['error']}")
            continue
        cache = r.get("cache") or {}
        cache_s = (f"{cache.get('hits', 0)}/{cache.get('misses', 0)}/"
                   f"{cache.get('invalidations', 0)}")
        print(f"{r.get('node', ''):<10s} {r.get('id', ''):<18s} "
              f"{','.join(r.get('stats') or []):<28s} "
              f"{r.get('range_s', 0):>7.0f}s {r.get('windows', 0):>4d} "
              f"{r.get('events', 0):>12,d} {r.get('ticks', 0):>6d} "
              f"{r.get('published', 0):>5d} {cache_s:>12s}")
    for node, err in errors.items():
        print(f"{node}: error: {err}", file=sys.stderr)
    return 0 if not errors else 1


def cmd_watch(args) -> int:
    from ..params import ParamError
    targets: dict | None = None
    if args.remote:
        from .main import parse_targets
        try:
            targets = parse_targets(args.remote)
        except ParamError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if args.list_queries:
        return _list_queries(args, targets)
    if not args.id:
        print("error: --id is required (or use --list)", file=sys.stderr)
        return 2
    if args.local:
        return _watch_local(args)
    if targets is None:
        from .deploy import local_targets
        targets = local_targets()
    if not targets:
        print("no agents (use deploy --local N, --remote, or --local "
              "for in-process engines)", file=sys.stderr)
        return 2
    return _watch_remote(args, targets)
