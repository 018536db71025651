"""`ig-tpu-torch fleet` — fleet-plane verbs (the port's copy of
``inspektor_gadget_tpu/cli/fleet.py``, over the port's `AgentClient`).

`fleet runs` renders the shared-run plane: one row per (node, shared
gadget run) with live subscriber count and priority-class mix, worst
queue depth, drop/eviction totals, and keepalive state — the operator's
"who is riding which capture, and is anyone being shed".

`fleet health` probes every agent with a bounded per-RPC deadline and
renders the reachability + run-stream view the chaos runtime maintains
live: a reachable agent is `healthy`, an unreachable one `dead`, and
each agent's DumpState `runs` rows show which gadget runs are serving a
client vs lingering detached awaiting a resume. This is the operator's
"is the fleet fine?" surface; the *in-run* states
(healthy|reconnecting|straggling|dead) ride CombinedGadgetResult and the
`ig_fleet_node_state` gauge of the process running the fan-out.
"""

from __future__ import annotations

import json
import sys


def add_fleet_parser(sub) -> None:
    fp = sub.add_parser(
        "fleet", help="fleet-plane verbs: per-agent health, run-stream "
        "attach states, reconnect/backfill counters")
    fsub = fp.add_subparsers(dest="fleet_verb", required=True)
    hp = fsub.add_parser(
        "health", help="probe every agent under a bounded deadline; "
        "report healthy/dead + active and lingering runs")
    hp.add_argument("--remote", default="",
                    help="name=target[,...]; defaults to the local fleet")
    hp.add_argument("--deadline", type=float, default=3.0,
                    help="per-agent RPC deadline in seconds (an "
                         "unresponsive agent is reported dead, not "
                         "waited on)")
    hp.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    hp.set_defaults(func=cmd_fleet_health)
    rp = fsub.add_parser(
        "runs", help="per-node shared gadget runs: subscriber counts/"
        "classes, queue depths, drops, keepalive state")
    rp.add_argument("--remote", default="",
                    help="name=target[,...]; defaults to the local fleet")
    rp.add_argument("--deadline", type=float, default=3.0,
                    help="per-agent RPC deadline in seconds")
    rp.add_argument("--gadget", default="",
                    help="restrict to one gadget (category/name)")
    rp.add_argument("--all", action="store_true",
                    help="include private (non-shared) and finished runs")
    rp.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    rp.set_defaults(func=cmd_fleet_runs)
    qp = fsub.add_parser(
        "queries", help="per-node standing queries: coverage, refresh/"
        "publish counts, cache hit/miss/invalidation accounting")
    qp.add_argument("--remote", default="",
                    help="name=target[,...]; defaults to the local fleet")
    qp.add_argument("--deadline", type=float, default=3.0,
                    help="per-agent RPC deadline in seconds")
    qp.add_argument("--gadget", default="",
                    help="restrict to one gadget (category/name)")
    qp.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    qp.set_defaults(func=cmd_fleet_queries)
    lp = fsub.add_parser(
        "lag", help="per-node pipeline health: per-stage lag watermarks/"
        "p99, batch rates, ring occupancy, starved ratio")
    lp.add_argument("--remote", default="",
                    help="name=target[,...]; defaults to the local fleet")
    lp.add_argument("--deadline", type=float, default=3.0,
                    help="per-agent RPC deadline in seconds")
    lp.add_argument("--gadget", default="",
                    help="restrict to one gadget (category/name)")
    lp.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                    help="re-poll every SECONDS and show batch rates "
                         "from count deltas (0 = one shot)")
    lp.add_argument("--iterations", type=int, default=0,
                    help="with --watch: stop after N refreshes "
                         "(0 = until interrupted)")
    lp.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    lp.set_defaults(func=cmd_fleet_lag)
    ap = fsub.add_parser(
        "accuracy", help="per-node sketch accuracy audit: per-stat "
        "analytic bound vs observed error (shadow-sample ground truth), "
        "audit sample sizes, drift ratio")
    ap.add_argument("--remote", default="",
                    help="name=target[,...]; defaults to the local fleet")
    ap.add_argument("--deadline", type=float, default=3.0,
                    help="per-agent RPC deadline in seconds")
    ap.add_argument("--gadget", default="",
                    help="restrict to one gadget (category/name)")
    ap.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    ap.set_defaults(func=cmd_fleet_accuracy)
    tp = fsub.add_parser(
        "topology", help="render the fleet merge tree: zones, "
        "aggregators, depth/fan-in, and the wire cost of one merged "
        "query through the tree vs the flat fold")
    tp.add_argument("--remote", default="",
                    help="name=target[,...]; defaults to the local fleet")
    tp.add_argument("--topology", default="auto",
                    help="'auto', 'auto:<fan_in>', or the declared zone "
                         "grammar 'zone-a=n0,n1;zone-b=n2' (default "
                         "auto)")
    tp.add_argument("--fan-in", type=int, default=0,
                    help="shorthand for --topology auto:<N>")
    tp.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    tp.set_defaults(func=cmd_fleet_topology)


def _probe_agent(node: str, target: str, deadline: float) -> dict:
    from ..agent.client import AgentClient
    row: dict = {"node": node, "target": target, "state": "healthy",
                 "runs": [], "detached": 0, "alerts": 0, "error": ""}
    client = None
    try:
        client = AgentClient(target, node, rpc_deadline=deadline)
        state = client.dump_state()
        runs = state.get("runs") or []
        row["runs"] = runs
        row["detached"] = sum(1 for r in runs
                              if not r.get("attached") and not r.get("done"))
        row["alerts"] = len(state.get("alerts") or [])
    except Exception as e:  # noqa: BLE001 — per-node isolation
        row["state"] = "dead"
        row["error"] = str(e)
    finally:
        if client is not None:
            client.close()
    return row


def cmd_fleet_health(args) -> int:
    from ..params import ParamError
    from .main import parse_targets
    try:
        if args.remote:
            targets = parse_targets(args.remote)
        else:
            from .deploy import local_targets
            targets = local_targets()
    except ParamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not targets:
        print("no agents (use deploy --local N or --remote)",
              file=sys.stderr)
        return 2
    rows = [_probe_agent(n, t, args.deadline) for n, t in targets.items()]
    if args.output == "json":
        print(json.dumps({"agents": rows}, indent=2, default=str))
    else:
        print(f"{'NODE':<14s} {'STATE':<9s} {'RUNS':>4s} {'DETACHED':>8s} "
              f"{'ALERTS':>6s}  DETAIL")
        for r in rows:
            active = sum(1 for run in r["runs"] if not run.get("done"))
            detail = r["error"]
            if not detail and r["detached"]:
                lingering = [run["run_id"] for run in r["runs"]
                             if not run.get("attached")
                             and not run.get("done")]
                detail = ("awaiting resume: " + ", ".join(lingering))
            print(f"{r['node']:<14s} {r['state']:<9s} {active:>4d} "
                  f"{r['detached']:>8d} {r['alerts']:>6d}  {detail}")
    return 0 if all(r["state"] == "healthy" for r in rows) else 1


def _resolve_targets(args) -> dict | None:
    from ..params import ParamError
    from .main import parse_targets
    try:
        if args.remote:
            return parse_targets(args.remote)
        from .deploy import local_targets
        return local_targets()
    except ParamError as e:
        print(f"error: {e}", file=sys.stderr)
        return None


def _sweep_agents(targets: dict, deadline: float, extract,
                  **defaults) -> list[dict]:
    """The ONE per-agent sweep every fleet verb uses: dial each agent
    under the bounded deadline, merge `extract(client)`'s dict into the
    node row, and capture failures as the row's `error` (per-node
    isolation — an unreachable agent is a row, never an exception).
    Each verb used to hand-roll this loop with its own error shape; one
    helper means one rc contract and one unreachable row everywhere."""
    from ..agent.client import AgentClient
    rows: list[dict] = []
    for node, target in targets.items():
        row: dict = {"node": node, "target": target, "error": "",
                     **{k: (v.copy() if isinstance(v, (list, dict))
                            else v) for k, v in defaults.items()}}
        client = None
        try:
            client = AgentClient(target, node, rpc_deadline=deadline)
            row.update(extract(client))
        except Exception as e:  # noqa: BLE001 — per-node isolation
            row["error"] = str(e)
        finally:
            if client is not None:
                client.close()
        rows.append(row)
    return rows


def _unreachable_line(row: dict, width: int = 12) -> str:
    """The uniform unreachable row every fleet table prints (the runs
    verb used to render a dashed variant — one shape, one test)."""
    return f"{row['node']:<{width}s} unreachable: {row['error']}"


def _fleet_rc(rows: list[dict]) -> int:
    """The uniform fleet-verb exit code: 0 when every agent answered,
    1 when any row is an error."""
    return 0 if not any(r.get("error") for r in rows) else 1


def _sub_summary(run: dict) -> tuple[str, str, int, int]:
    """(classes, queue, drops, evictions) strings/counts for one run's
    subscriber rows."""
    subs = run.get("subscribers") or []
    live = [s for s in subs if not s.get("left")]
    classes: dict[str, int] = {}
    for s in live:
        classes[s.get("priority", "?")] = classes.get(
            s.get("priority", "?"), 0) + 1
    cls = ",".join(f"{n}×{c}" if n > 1 else c
                   for c, n in sorted(classes.items())) or "-"
    depth = max((s.get("queue_depth", 0) for s in live), default=0)
    qmax = max((s.get("queue_max", 0) for s in live), default=0)
    drops = sum(s.get("drops", 0) for s in subs)
    evictions = sum(1 for s in subs if s.get("evicted"))
    return cls, f"{depth}/{qmax}" if qmax else "-", drops, evictions


def cmd_fleet_runs(args) -> int:
    """Operator view of the shared-run plane: one row per (node, run)
    with subscriber classes, worst queue depth, drop/eviction totals,
    and keepalive state — the `fleet health` companion for "who is
    riding which capture, and is anyone being shed"."""
    targets = _resolve_targets(args)
    if targets is None:
        return 2
    if not targets:
        print("no agents (use deploy --local N or --remote)",
              file=sys.stderr)
        return 2
    def extract(client) -> dict:
        runs = client.dump_state().get("runs") or []
        if not args.all:
            runs = [r for r in runs
                    if r.get("shared") and not r.get("done")]
        if args.gadget:
            runs = [r for r in runs if r.get("gadget") == args.gadget]
        return {"runs": runs}

    per_node = _sweep_agents(targets, args.deadline, extract, runs=[])
    if args.output == "json":
        print(json.dumps({"agents": per_node}, indent=2, default=str))
        return _fleet_rc(per_node)
    print(f"{'NODE':<12s} {'RUN':<22s} {'GADGET':<16s} {'SUBS':>4s} "
          f"{'CLASSES':<14s} {'QUEUE':>9s} {'DROPS':>6s} {'EVICT':>5s}  "
          f"STATE")
    for r in per_node:
        if r["error"]:
            print(_unreachable_line(r))
            continue
        if not r["runs"]:
            print(f"{r['node']:<12s} {'-':<22s} {'-':<16s} {0:>4d} "
                  f"{'-':<14s} {'-':>9s} {'-':>6s} {'-':>5s}  no shared "
                  f"runs")
            continue
        for run in r["runs"]:
            cls, q, drops, evictions = _sub_summary(run)
            if run.get("done"):
                state = "done"
            elif run.get("attached"):
                state = "serving"
            elif run.get("keepalive_remaining", 0) > 0:
                state = (f"keepalive "
                         f"{run['keepalive_remaining']:.1f}s left")
            else:
                state = "detached"
            print(f"{r['node']:<12s} {run['run_id']:<22s} "
                  f"{run.get('gadget', ''):<16s} "
                  f"{run.get('live_subscribers', 0):>4d} {cls:<14s} "
                  f"{q:>9s} {drops:>6d} {evictions:>5d}  {state}")
    return _fleet_rc(per_node)


def cmd_fleet_queries(args) -> int:
    """Operator view of the standing-query plane: one row per (node,
    query) with covered windows, refresh/publish counts, and result-
    cache accounting — `fleet runs`' companion for "who is watching
    what, and is the cache earning its bytes"."""
    targets = _resolve_targets(args)
    if targets is None:
        return 2
    if not targets:
        print("no agents (use deploy --local N or --remote)",
              file=sys.stderr)
        return 2
    def extract(client) -> dict:
        qrows = (client.dump_state().get("standing_queries") or [])
        if args.gadget:
            qrows = [q for q in qrows if q.get("gadget") == args.gadget]
        return {"queries": qrows}

    per_node = _sweep_agents(targets, args.deadline, extract, queries=[])
    if args.output == "json":
        print(json.dumps({"agents": per_node}, indent=2, default=str))
        return _fleet_rc(per_node)
    print(f"{'NODE':<12s} {'QUERY':<18s} {'GADGET':<16s} {'RANGE':>8s} "
          f"{'WIN':>4s} {'EVENTS':>12s} {'TICKS':>6s} {'PUB':>5s} "
          f"{'FOLDS':>6s} {'CACHE h/m/i':>12s}")
    for r in per_node:
        if r["error"]:
            print(_unreachable_line(r))
            continue
        if not r["queries"]:
            print(f"{r['node']:<12s} no standing queries")
            continue
        for q in r["queries"]:
            cache = q.get("cache") or {}
            cache_s = (f"{cache.get('hits', 0)}/{cache.get('misses', 0)}"
                       f"/{cache.get('invalidations', 0)}")
            print(f"{r['node']:<12s} {q.get('id', ''):<18s} "
                  f"{q.get('gadget', ''):<16s} "
                  f"{q.get('range_s', 0):>7.0f}s {q.get('windows', 0):>4d} "
                  f"{q.get('events', 0):>12,d} {q.get('ticks', 0):>6d} "
                  f"{q.get('published', 0):>5d} {q.get('folds', 0):>6d} "
                  f"{cache_s:>12s}")
    return _fleet_rc(per_node)


def _poll_pipeline(targets: dict, deadline: float,
                   gadget: str) -> list[dict]:
    """One DumpState sweep → [{node, error, runs: [pipeline rows]}]."""
    def extract(client) -> dict:
        runs = client.dump_state().get("pipeline") or []
        runs = [r for r in runs if "error" not in r]
        if gadget:
            runs = [r for r in runs if r.get("gadget") == gadget]
        return {"runs": runs}

    return _sweep_agents(targets, deadline, extract, runs=[])


def _fmt_lag(v: float) -> str:
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.1f}ms"
    return f"{v * 1e6:.0f}us"


def _print_lag_table(per_node: list[dict], prev: dict, dt: float) -> dict:
    """Render one poll; returns {key: count} for the next poll's rate
    column (batches/s from count deltas — a DumpState snapshot carries
    totals, not rates)."""
    print(f"{'NODE':<12s} {'RUN':<14s} {'STAGE':<8s} {'RATE':>9s} "
          f"{'LAG':>9s} {'P99':>9s} {'OCC':>4s} {'STARVED':>8s}")
    counts: dict = {}
    for r in per_node:
        if r["error"]:
            print(_unreachable_line(r))
            continue
        if not r["runs"]:
            print(f"{r['node']:<12s} no instrumented runs")
            continue
        for run in r["runs"]:
            rid = str(run.get("run_id", ""))[:14]
            starved = f"{run.get('starved_ratio', 0.0) * 100:.0f}%"
            occ = run.get("occupancy") or {}
            for stage, srow in sorted((run.get("stages") or {}).items()):
                key = (r["node"], run.get("run_id"), stage)
                counts[key] = srow.get("count", 0)
                delta = counts[key] - prev.get(key, 0)
                rate = (f"{delta / dt:,.0f}/s"
                        if dt > 0 and key in prev else "-")
                o = max((v for k, v in occ.items()
                         if k.split(":", 1)[0] == stage), default=0.0)
                print(f"{r['node']:<12s} {rid:<14s} {stage:<8s} "
                      f"{rate:>9s} "
                      f"{_fmt_lag(srow.get('watermark_s', 0.0)):>9s} "
                      f"{_fmt_lag(srow.get('p99_s', 0.0)):>9s} "
                      f"{o:>4.0f} {starved:>8s}")
    return counts


def cmd_fleet_accuracy(args) -> int:
    """Operator view of the accuracy audit plane: one row per
    (node, run, stat) with the analytic error bound, the observed error
    vs the shadow-sample ground truth, and whether the stat was audited
    at all — the fleet-wide answer to "can I trust these numbers"."""
    targets = _resolve_targets(args)
    if targets is None:
        return 2
    if not targets:
        print("no agents (use deploy --local N or --remote)",
              file=sys.stderr)
        return 2

    def extract(client) -> dict:
        runs = client.dump_state().get("accuracy") or []
        runs = [r for r in runs if "error" not in r]
        if args.gadget:
            runs = [r for r in runs if r.get("gadget") == args.gadget]
        return {"runs": runs}

    per_node = _sweep_agents(targets, args.deadline, extract, runs=[])
    if args.output == "json":
        print(json.dumps({"agents": per_node}, indent=2, default=str))
        return _fleet_rc(per_node)
    print(f"{'NODE':<12s} {'RUN':<14s} {'STAT':<14s} {'BOUND':>10s} "
          f"{'OBSERVED':>10s} {'AUDITED':>7s} {'SAMPLE':>7s} "
          f"{'RATIO':>6s}")
    for r in per_node:
        if r["error"]:
            print(_unreachable_line(r))
            continue
        if not r["runs"]:
            print(f"{r['node']:<12s} no audited runs (audit-sample 0?)")
            continue
        for run in r["runs"]:
            rid = str(run.get("run_id", ""))[:14]
            sample = run.get("sample_size", 0)
            ratio = f"{run.get('ratio', 0.0):.2f}"
            for stat, srow in sorted((run.get("stats") or {}).items()):
                obs = srow.get("observed_err")
                print(f"{r['node']:<12s} {rid:<14s} {stat:<14s} "
                      f"{srow.get('bound', 0.0):>10.5f} "
                      f"{(f'{obs:.5f}' if obs is not None else '-'):>10s} "
                      f"{('yes' if srow.get('audited') else 'no'):>7s} "
                      f"{sample:>7d} {ratio:>6s}")
    return _fleet_rc(per_node)


def cmd_fleet_lag(args) -> int:
    """Operator view of the pipeline health plane: one row per (node,
    run, stage) with batch rate, lag watermark, p99 lag, ring occupancy,
    and starved ratio. `--watch` re-polls and turns count deltas into
    rates."""
    import time as _time
    targets = _resolve_targets(args)
    if targets is None:
        return 2
    if not targets:
        print("no agents (use deploy --local N or --remote)",
              file=sys.stderr)
        return 2
    prev: dict = {}
    last_t = 0.0
    i = 0
    while True:
        per_node = _poll_pipeline(targets, args.deadline, args.gadget)
        now = _time.monotonic()
        if args.output == "json":
            print(json.dumps({"agents": per_node}, indent=2, default=str))
        else:
            prev = _print_lag_table(per_node, prev,
                                    now - last_t if last_t else 0.0)
        last_t = now
        i += 1
        if not args.watch or (args.iterations and i >= args.iterations):
            break
        try:
            _time.sleep(args.watch)
        except KeyboardInterrupt:
            break
    return _fleet_rc(per_node)


def cmd_fleet_topology(args) -> int:
    """Render the merge tree the aggregation tier would fold this fleet
    through: zone membership, depth/fan-in, and the wire cost of one
    merged query — tree edges + 1 root frame vs one frame per node flat,
    with the client's own link load dropping from N to fan-in."""
    from ..fleet import TopologyError, parse_topology
    targets = _resolve_targets(args)
    if targets is None:
        return 2
    if not targets:
        print("no agents (use deploy --local N or --remote)",
              file=sys.stderr)
        return 2
    spec = f"auto:{args.fan_in}" if args.fan_in else args.topology
    try:
        topo = parse_topology(spec, list(targets))
    except TopologyError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    n = len(topo.leaves())
    if args.output == "json":
        print(json.dumps({"spec": spec, "topology": topo.to_dict(),
                          "wire_windows_tree": topo.edges() + 1,
                          "wire_windows_flat": n}, indent=2))
        return 0

    def render(node, indent: int = 0) -> None:
        pad = "  " * indent
        if node.is_leaf:
            print(f"{pad}{node.id}")
            return
        kinds = sum(1 for c in node.children if not c.is_leaf)
        what = (f"{len(node.children)} zone(s)" if kinds
                else f"{len(node.children)} agent(s)")
        print(f"{pad}{node.id}/  [{what}]")
        for c in node.children:
            render(c, indent + 1)

    print(f"merge tree over {n} agent(s): depth {topo.depth()}, "
          f"fan-in {topo.fan_in()}, {len(topo.aggregators())} "
          f"aggregator(s)")
    print(f"wire cost per merged query: {topo.edges() + 1} window "
          f"frame(s) through the tree vs {n} flat; client link folds "
          f"{len(topo.root.children)} instead of {n}")
    render(topo.root)
    return 0
