"""ig-tpu-torch CLI: commands generated from the gadget registry.

Reference contract: cmd/common/registry.go:46-101 builds a cobra tree with
one command per category/gadget, flags materialized from ParamDescs
(gadget + operators + runtime); RunE wires runtime.Init → gadgetcontext →
parser callback → formatter (registry.go:172-346). `ig` uses the local
runtime (cmd/ig/main.go:36-57); `--remote` switches to the gRPC fan-out
runtime (kubectl-gadget analogue, cmd/kubectl-gadget/main.go:48-69).

The port's copy of ``inspektor_gadget_tpu/cli/main.py``: ``list``,
``catalog``, ``version``, every gadget command on the local runtime or,
with ``--remote``, fanned out to agents, ``query``, ``watch``,
``history``, ``record``, ``replay`` and ``alerts`` on this process or the
agents, ``agent`` (the per-node daemon, `agent.main serve`), ``debug``,
``deploy``, ``undeploy``, ``traces``, ``fleet``, ``doctor`` and ``bench``
(the perf harness and its ledger), with one more flag, ``--device
{cuda,cpu}`` (default ``cuda``): the device the run's operators (and
``profile block-io --quantiles true``) put their state on, for ``deploy
--local`` the device of the agents it starts, and for ``bench run`` the
device it measures. Every top-level command of the reference's CLI is
ported.

    python -m inspektor_gadget_tpu_torch.cli.main trace exec --device cpu \\
        --source pysynthetic --timeout 3 --tpusketch-enable true
"""

from __future__ import annotations

import argparse
import json
import signal
import sys

# a Ctrl-C during the (slow, torch-importing) startup must not dump a
# KeyboardInterrupt traceback: remember it, finish loading, exit cleanly.
# Only armed when this module IS the program (python -m …cli.main) — a
# library import must not hijack the host process's SIGINT handling.
_early_interrupt = False
_prev_sigint = None


def _early_sigint(signum, frame):
    global _early_interrupt
    _early_interrupt = True


if __name__ == "__main__":
    import threading as _threading
    if _threading.current_thread() is _threading.main_thread():
        _prev_sigint = signal.signal(signal.SIGINT, _early_sigint)

from .. import all_gadgets  # noqa: F401,E402 — registers every gadget and operator
from ..columns import (TextFormatter, match_event, parse_filters, parse_sort,  # noqa: E402
                       sort_events)
from ..gadgets import GadgetContext  # noqa: E402
from ..gadgets import registry as gadget_registry  # noqa: E402
from ..gadgets.interface import GadgetType  # noqa: E402
from ..operators import operators as op_registry  # noqa: E402
from ..params import Collection, ParamError  # noqa: E402
from ..telemetry.tracing import RECORDER, TRACER, export_chrome, load_dump  # noqa: E402
from .alerts import add_alerts_parser  # noqa: E402
from .bench import add_bench_parser  # noqa: E402
from .fleet import add_fleet_parser  # noqa: E402
from .history import add_history_parser  # noqa: E402
from .query import add_query_parser  # noqa: E402
from .record import add_record_parser, add_replay_parser  # noqa: E402
from .watch import add_watch_parser  # noqa: E402

__version__ = "0.1.0"

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ig-tpu-torch",
        description="streaming observability framework (PyTorch/CUDA port)",
    )
    sub = ap.add_subparsers(dest="category")

    lp = sub.add_parser("list", help="list gadgets")
    lp.set_defaults(func=cmd_list)

    dr = sub.add_parser("doctor", help="probe capture windows, report "
                        "per-gadget real/degraded/unavailable status")
    dr.add_argument("-o", "--output", default="table", choices=["table", "json"])
    dr.set_defaults(func=cmd_doctor)

    cp = sub.add_parser("catalog", help="print the full catalog as JSON")
    cp.set_defaults(func=cmd_catalog)

    vp = sub.add_parser("version", help="print version")
    vp.set_defaults(func=lambda a: (print(f"ig-tpu-torch {__version__}"), 0)[1])

    dp = sub.add_parser("deploy", help="render agent manifests / start local agents")
    dp.add_argument("--render", action="store_true",
                    help="print DaemonSet+RBAC manifests")
    dp.add_argument("--local", type=int, default=0,
                    help="start N local agent daemons")
    dp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the local agents (no fallback: cuda without a "
                         "card fails)")
    dp.add_argument("--apply", action="store_true",
                    help="apply manifests via kubectl and wait for rollout")
    dp.add_argument("--context", default="", help="kubectl context for --apply")
    dp.add_argument("--rollout-timeout", type=float, default=120.0)
    dp.add_argument("--image", default="")
    dp.set_defaults(func=cmd_deploy)

    up = sub.add_parser("undeploy", help="stop local agents / render deletion")
    up.add_argument("--render", action="store_true",
                    help="print kubectl deletion manifest list")
    up.add_argument("--apply", action="store_true",
                    help="delete the deployed manifests via kubectl")
    up.add_argument("--context", default="", help="kubectl context for --apply")
    up.set_defaults(func=cmd_undeploy)

    add_query_parser(sub)
    add_fleet_parser(sub)
    add_watch_parser(sub)
    add_history_parser(sub)
    add_alerts_parser(sub)
    add_record_parser(sub)
    add_replay_parser(sub)
    add_bench_parser(sub)

    # help-listing stub only: main() intercepts `agent` before argparse and
    # forwards the raw argv to agent.main serve (REMAINDER can't pass
    # through leading --flags it doesn't own)
    sub.add_parser(
        "agent", help="run the per-node agent daemon (all agent.main serve "
        "flags pass through, e.g. --listen, --device, --metrics-addr)")
    _add_debug_parser(sub)

    # legacy CRD-path verbs (ref: cmd/kubectl-gadget/utils/trace.go:340-848 —
    # CreateTrace / SetTraceOperation / waitForCondition, over agent RPCs)
    tp = sub.add_parser("traces", help="Trace-resource lifecycle on agents")
    tsub = tp.add_subparsers(dest="verb", required=True)
    for verb in ("start", "stop", "generate", "get", "delete", "list"):
        vparser = tsub.add_parser(verb)
        vparser.add_argument("--remote", default="",
                             help="name=target[,...]; defaults to the local fleet")
        if verb != "list":
            vparser.add_argument("--name", required=True)
        if verb == "start":
            vparser.add_argument("--gadget", required=True,
                                 help="category/name, e.g. advise/seccomp-profile")
            vparser.add_argument("--node", default="",
                                 help="restrict the trace to one node")
            vparser.add_argument("-p", "--param", action="append", default=[],
                                 help="gadget parameter k=v (repeatable)")
        vparser.set_defaults(func=cmd_traces, verb=verb)

    categories = gadget_registry.categories()
    for category in sorted(categories):
        catp = sub.add_parser(category, help=f"{category} gadgets")
        catsub = catp.add_subparsers(dest="gadget")
        for desc in categories.get(category, ()):
            gp = catsub.add_parser(desc.name, help=desc.description)
            _add_common_flags(gp)
            for p in desc.params().to_params():
                d = p.desc
                try:
                    gp.add_argument(
                        f"--{d.key}", default=d.default, dest=f"param_{d.key}",
                        help=_help_text(d.description or d.key),
                    )
                except argparse.ArgumentError:
                    # a common flag (e.g. --max-rows, --sort) owns the option;
                    # its value is copied into the gadget param in cmd_run
                    pass
            for op in op_registry.get_all():
                if not op.can_operate_on(desc):
                    continue
                for p in op.instance_params().to_params():
                    d = p.desc
                    gp.add_argument(
                        f"--{op.name}-{d.key}", default=d.default,
                        dest=f"opparam_{op.name}.{d.key}",
                        help=_help_text(f"[operator {op.name}] {d.description or d.key}"),
                    )
            gp.set_defaults(func=cmd_run, desc=desc)
    return ap


def _add_debug_parser(sub) -> None:
    bp = sub.add_parser("debug", help="agent debugging: state dump, flight "
                        "recorder, Chrome-trace export")
    bp.add_argument("--remote", default="",
                    help="name=target[,...]; defaults to the local fleet")
    bp.set_defaults(func=cmd_debug, node="")  # bare `debug` → state dump
    bsub = bp.add_subparsers(dest="debug_verb")

    # sub-verb flags use SUPPRESS defaults: argparse copies a subparser's
    # defaults OVER the parent namespace, so a plain default would
    # silently discard `debug --remote X <verb>` (flag before the verb)
    def _remote_arg(p):
        p.add_argument("--remote", default=argparse.SUPPRESS,
                       help="name=target[,...]; defaults to the local fleet")

    dsp = bsub.add_parser("state", help="dump agent state (DumpState)")
    _remote_arg(dsp)
    dsp.set_defaults(func=cmd_debug)

    frp = bsub.add_parser("flight-record",
                          help="recent spans/logs/errors per agent "
                          "(the crash-safe black box)")
    _remote_arg(frp)
    frp.add_argument("--node", default=argparse.SUPPRESS,
                     help="restrict to one node")
    frp.add_argument("--from-dump", default=argparse.SUPPRESS,
                     help="read a crash dump file instead of live agents "
                          "(tolerates crash-truncated dumps)")
    frp.set_defaults(func=cmd_debug_flight)

    dtp = bsub.add_parser("trace", help="distributed-trace verbs")
    dtsub = dtp.add_subparsers(dest="trace_verb", required=True)
    tep = dtsub.add_parser("export", help="merge local + agent spans into "
                           "Chrome trace-event JSON (Perfetto-loadable)")
    _remote_arg(tep)
    tep.add_argument("--node", default=argparse.SUPPRESS,
                     help="restrict to one node")
    tep.add_argument("--trace-id", default="",
                     help="export only this trace (default: all retained)")
    tep.add_argument("--out", default="ig-trace.json",
                     help="output path, or '-' for stdout")
    tep.set_defaults(func=cmd_debug_trace_export)


def _help_text(text: str) -> str:
    """A param's description as argparse help: argparse %-formats help
    strings, so a literal % (e.g. "1%") is doubled."""
    return text.replace("%", "%%")


def _add_common_flags(gp: argparse.ArgumentParser) -> None:
    gp.add_argument("--remote", default="",
                    help="fan out to agents: name=target[,name=target...] "
                         "(the kubectl-gadget mode)")
    gp.add_argument("--node", default="", help="restrict --remote to one node")
    gp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the run's operator state (no fallback: cuda "
                         "without a card fails; --remote runs take each agent's)")
    gp.add_argument("-o", "--output", default="columns",
                    choices=["columns", "json"], help="output format")
    gp.add_argument("--timeout", type=float, default=0.0,
                    help="stop after N seconds")
    gp.add_argument("-F", "--filter", default="",
                    help="column filters, e.g. comm:bash,pid:>100")
    gp.add_argument("--sort", default="", help="sort spec, e.g. -count,comm")
    gp.add_argument("--max-rows", type=int, default=50)
    gp.add_argument("--columns", default="", help="comma-separated columns to show")
    gp.add_argument("--no-header", action="store_true")


def cmd_list(args) -> int:
    for desc in gadget_registry.get_all():
        print(f"{desc.category:10s} {desc.name:18s} {desc.description}")
    return 0


def cmd_doctor(args) -> int:
    """ref: gadget-container/entrypoint.sh:21-120 environment detection,
    reshaped as an on-demand capability probe (see doctor.py). Exit 1 if
    and only if some gadget is unavailable on this host."""
    import dataclasses as dc

    from ..doctor import gadget_report, probe_windows, render_report
    from ..telemetry import snapshot
    from ..utils.platform_probe import last_acquire
    windows = probe_windows()
    gadgets = gadget_report(windows)
    if args.output == "json":
        print(json.dumps({
            "windows": {k: dc.asdict(w) for k, w in windows.items()},
            "gadgets": [dc.asdict(g) for g in gadgets],
            # device-plane acquisition outcome (agents probe at startup)
            "platform": last_acquire() or {"platform": "unprobed"},
            # the probed facts double as registry gauges
            "telemetry": snapshot(),
        }, indent=2))
    else:
        print(render_report(windows, gadgets))
    return 1 if any(g.status == "unavailable" for g in gadgets) else 0


def cmd_catalog(args) -> int:
    from ..runtime.runtime import build_catalog
    print(json.dumps(build_catalog(), indent=2))
    return 0


def print_sketch_summary(s) -> None:
    """The sketch plane's harvest as the reference's CLI prints it."""
    sys.stdout.write(
        f"\n— sketch epoch {s.epoch}: events={s.events:,} "
        f"distinct≈{s.distinct:,.0f} entropy={s.entropy_bits:.2f}b "
        f"drops={s.drops}\n")
    for key32, count in s.heavy_hitters[:10]:
        label = s.names.get(key32, f"0x{key32:08x}")
        sys.stdout.write(f"  {label:<24s}  {count:>10,}\n")
    if s.anomaly:
        worst = sorted(s.anomaly.items(), key=lambda kv: -kv[1])[:5]
        for ns, score in worst:
            sys.stdout.write(f"  anomaly mntns={ns}: {score:.4f}\n")
    sys.stdout.flush()


def print_alert(ev: dict) -> None:
    """One alert transition as the reference's CLI prints it."""
    key = f" key={ev['key']}" if ev.get("key") else ""
    sys.stdout.write(
        f"\n!! alert {ev['rule']} -> {ev['transition']}{key} "
        f"value={ev.get('value', 0):.6g} "
        f"threshold={ev.get('threshold', 0):g} "
        f"[{ev.get('severity', '')}]\n")
    sys.stdout.flush()


def print_cluster_alert(ev: dict) -> None:
    """One cluster-folded alert transition (the GrpcRuntime dedup) as the
    reference's CLI prints it."""
    nodes = ",".join(ev.get("nodes") or [])
    key = f" key={ev['key']}" if ev.get("key") else ""
    sys.stdout.write(
        f"\n!! alert {ev['rule']} -> {ev['transition']}{key} "
        f"value={ev.get('value', 0):.6g} nodes=[{nodes}] "
        f"[{ev.get('severity', '')}]\n")
    sys.stdout.flush()


def cmd_run(args) -> int:
    desc = args.desc
    gadget_params = desc.params().to_params()
    common = {"max-rows": str(args.max_rows), "sort": args.sort or None}
    for p in list(gadget_params):
        v = getattr(args, f"param_{p.key}", None)
        if v is None and p.key in common:
            v = common[p.key]
        if v is not None:
            try:
                gadget_params.set(p.key, v)
            except ParamError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2

    op_params = Collection()
    for op in op_registry.get_all():
        prefix = f"operator.{op.name}."
        params = op.instance_params().to_params()
        for p in list(params):
            # argparse keeps the dots of a dest: look up both spellings
            v = getattr(args, f"opparam_{op.name}.{p.key}".replace(".", "_"), None)
            if v is None:
                v = getattr(args, f"opparam_{op.name}.{p.key}", None)
            if v is not None:
                try:
                    params.set(p.key, v)
                except ParamError as e:
                    print(f"error: {e}", file=sys.stderr)
                    return 2
        op_params[prefix] = params

    extra = {}
    if "operator.tpusketch." in op_params:
        sp = op_params["operator.tpusketch."]
        if sp.get("enable").as_bool():
            extra["on_sketch_summary"] = print_sketch_summary

    # local runs surface alert transitions inline (remote runs ride the
    # EV_ALERT stream through the GrpcRuntime dedup instead)
    alerts_set = False
    if "operator.alerts." in op_params:
        alp = op_params["operator.alerts."]
        alerts_set = bool(alp.get("rules-file").as_string() or alp.get("rules").as_string())
    if alerts_set and not args.remote:
        extra["on_alert_event"] = print_alert

    extra["output"] = args.output
    ctx = GadgetContext(
        desc,
        gadget_params=gadget_params,
        operator_params=op_params,
        timeout=args.timeout,
        extra=extra,
        device=args.device,
    )

    if args.remote:
        from ..environment import Environment, set_environment
        set_environment(Environment.KUBERNETES)  # show node columns

    cols = ctx.columns
    filters = parse_filters(args.filter, cols) if args.filter and cols else []
    if filters and not args.remote:
        # push filters into the gadget's batch loop: rows that can't match
        # are dropped columnar and never become Python objects (batch-
        # capable gadgets set display_filters_applied and on_event skips
        # the re-check)
        extra["display_filters"] = filters
        extra["display_columns"] = cols
    if cols is not None:
        from ..environment import Environment, current
        if current() == Environment.LOCAL:
            cols.hide_tagged(["kubernetes"])
    if args.columns and cols:
        cols.set_visible(args.columns.split(","))
    formatter = TextFormatter(cols) if cols else None

    out = sys.stdout
    printed_header = False

    def on_event(ev):
        nonlocal printed_header
        if (filters and not extra.get("display_filters_applied")
                and not match_event(ev, filters, cols)):
            return
        if args.output == "json":
            out.write(cols.to_json(ev) + "\n")
        else:
            if not printed_header and not args.no_header:
                out.write(formatter.header() + "\n")
                printed_header = True
            out.write(formatter.format_event(ev) + "\n")
        out.flush()

    def on_event_array(evs):
        rows = [e for e in evs if not filters or match_event(e, filters, cols)]
        if args.sort:
            rows = sort_events(rows, parse_sort(args.sort, cols), cols)
        if desc.gadget_type == GadgetType.TRACE_INTERVALS:
            rows = rows[: args.max_rows]  # top-gadget truncation only
        if args.output == "json":
            out.write(json.dumps([cols.to_dict(e) for e in rows], default=str) + "\n")
        else:
            out.write("\n" + formatter.format_table(rows) + "\n")
        out.flush()

    def on_sigint(signum, frame):
        ctx.cancel()

    signal.signal(signal.SIGINT, on_sigint)

    run_kwargs = {}
    if args.remote:
        from ..runtime.grpc_runtime import GrpcRuntime
        try:
            targets = parse_targets(args.remote)
        except ParamError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        runtime = GrpcRuntime(targets)
        if args.node:
            ctx.runtime_params = runtime.params().to_params()
            ctx.runtime_params.set("node", args.node)
        if alerts_set:
            # cluster-folded alerts from the GrpcRuntime dedup
            run_kwargs["on_alert"] = print_cluster_alert
    else:
        from ..runtime.local import LocalRuntime
        runtime = LocalRuntime()
    try:
        result = runtime.run_gadget(
            ctx,
            on_event=on_event if desc.gadget_type in (GadgetType.TRACE,) else None,
            on_event_array=on_event_array
            if desc.gadget_type in (GadgetType.TRACE_INTERVALS, GadgetType.ONE_SHOT)
            else None,
            **run_kwargs,
        )
    finally:
        runtime.close()
    if getattr(result, "partial", False) and result.contributing():
        # a degraded fleet answer is LABELED partial, never silently
        # full-looking (supervisor.FleetHealth states ride the result).
        # Zero contributors is not a partial answer — it is a plain
        # failure, and the per-node error lines below cover it.
        unhealthy = {n: s for n, s in result.health.items() if s != "healthy"}
        print("warning: PARTIAL result — contributing: "
              + (",".join(result.contributing()) or "<none>")
              + (f"; unhealthy: {unhealthy}" if unhealthy else ""),
              file=sys.stderr)
    errs = result.errors()
    if errs:
        for node, err in errs.items():
            print(f"error on {node}: {err}", file=sys.stderr)
        return 1
    res = result.first()
    if res is not None:
        if isinstance(res, bytes):
            sys.stdout.buffer.write(res)
        else:
            print(res)
    return 0


def parse_targets(spec: str) -> dict[str, str]:
    """Parse 'name=host:port[,name=host:port...]' with a usage error on
    malformed input (shared by --remote run/debug)."""
    targets = {}
    for kv in spec.split(","):
        if "=" not in kv:
            raise ParamError(
                f"bad --remote entry {kv!r}: expected name=host:port")
        name, target = kv.split("=", 1)
        targets[name] = target
    return targets


def _debug_targets(args) -> dict[str, str]:
    """--remote targets, else the local fleet, filtered by --node when
    set; may be empty (caller decides whether local-process data
    suffices). Raises ParamError on malformed --remote or unknown
    --node."""
    from .deploy import local_targets
    targets = parse_targets(args.remote) if args.remote else local_targets()
    node = getattr(args, "node", "")
    if node:
        targets = {n: t for n, t in targets.items() if n == node}
        if not targets:
            raise ParamError(f"unknown node {node!r}")
    return targets


def cmd_debug(args) -> int:
    """ref: `kubectl-gadget debug` + DumpState RPC
    (gadgettracermanager.go:204-219, cmd/kubectl-gadget/debug.go)."""
    from ..agent.client import AgentClient
    try:
        targets = _debug_targets(args)
    except ParamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not targets:
        print("no agents (use deploy --local N or --remote)", file=sys.stderr)
        return 2
    rc = 0
    for node, target in targets.items():
        client = AgentClient(target)
        try:
            state = client.dump_state()
            print(f"=== {node} ({target}) ===")
            print(json.dumps(state, indent=2, default=str))
        except Exception as e:  # noqa: BLE001 — per-node isolation
            print(f"=== {node} ({target}) === error: {e}", file=sys.stderr)
            rc = 1
        finally:
            client.close()
    return rc


def cmd_debug_flight(args) -> int:
    """ref: the flight-recorder analogue of `kubectl-gadget debug` — the
    agent's crash-safe ring of recent spans/logs/errors over DumpState."""
    from ..agent.client import AgentClient
    dump_path = getattr(args, "from_dump", "")
    if dump_path:
        doc, err = load_dump(dump_path)
        if doc is None:
            print(f"error: {err}", file=sys.stderr)
            return 1
        if err:
            print(f"warning: {err}", file=sys.stderr)
        print(json.dumps({dump_path: doc}, indent=2, default=str))
        return 0
    try:
        targets = _debug_targets(args)
    except ParamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not targets:
        # no agents: this process's own flight record is still evidence
        print(json.dumps({"local": RECORDER.snapshot()}, indent=2,
                         default=str))
        return 0
    rc = 0
    out = {}
    for node, target in targets.items():
        client = AgentClient(target, node_name=node)
        try:
            out[node] = client.flight_record()
        except Exception as e:  # noqa: BLE001 — per-node isolation
            out[node] = {"error": str(e)}
            rc = 1
        finally:
            client.close()
    print(json.dumps(out, indent=2, default=str))
    return rc


def cmd_debug_trace_export(args) -> int:
    """Merge this process's span ring with every agent's (via DumpState)
    and write one Chrome trace-event JSON file (Perfetto-loadable)."""
    from ..agent.client import AgentClient
    try:
        targets = _debug_targets(args)
    except ParamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    spans = TRACER.export()
    rc = 0
    for node, target in targets.items():
        client = AgentClient(target, node_name=node)
        try:
            # pull deep into the agent's span ring, not the 512-span
            # debug default (a truncated export silently loses early
            # spans) — but stay under gRPC's 4 MiB default message cap:
            # ~250 B/span JSON puts 8192 spans around 2 MiB
            fr = client.flight_record(max_spans=8192)
            for s in fr.get("spans", []):
                s.setdefault("node", node)
                spans.append(s)
        except Exception as e:  # noqa: BLE001 — per-node isolation
            print(f"{node}: error: {e}", file=sys.stderr)
            rc = 1
        finally:
            client.close()
    doc = export_chrome(spans, trace_id=args.trace_id or None)
    payload = json.dumps(doc, default=str)
    if args.out == "-":
        print(payload)
    else:
        with open(args.out, "w") as f:
            f.write(payload)
        n_spans = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
        print(f"wrote {n_spans} spans to {args.out}")
    return rc


def cmd_deploy(args) -> int:
    from .deploy import AGENT_IMAGE, deploy_local, render_manifests
    if args.render:
        print(render_manifests(image=args.image or AGENT_IMAGE))
        return 0
    if args.apply:
        # ref: deploy.go:100-546 — apply + wait for DaemonSet rollout
        from .apply import KubectlApplier
        from .apply import deploy as apply_deploy
        try:
            desired, ready = apply_deploy(
                KubectlApplier(context=args.context),
                render_manifests(image=args.image or AGENT_IMAGE),
                rollout_timeout=args.rollout_timeout)
        except (RuntimeError, TimeoutError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"deployed: {ready}/{desired} agents ready")
        return 0
    if args.local > 0:
        try:
            targets = deploy_local(args.local, device=args.device)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        spec = ",".join(f"{k}={v}" for k, v in targets.items())
        print(f"started {args.local} agents; use: --remote {spec}")
        return 0
    print("use --render or --local N", file=sys.stderr)
    return 2


def cmd_undeploy(args) -> int:
    from .deploy import render_undeploy, undeploy_local
    if args.render:
        print(render_undeploy())
        return 0
    if args.apply:
        from .apply import KubectlApplier
        from .apply import undeploy as apply_undeploy
        from .deploy import render_manifests
        try:
            removed = apply_undeploy(KubectlApplier(context=args.context),
                                     render_manifests())
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print("removed: " + ", ".join(f"{k}/{n}" for k, n in removed))
        return 0
    stopped = undeploy_local()
    print(f"stopped {len(stopped)} agents" + (f": {', '.join(stopped)}"
                                              if stopped else ""))
    return 0


def cmd_traces(args) -> int:
    """Serve the §3.5 call stack from the client side: build a CR-shaped
    Trace doc, apply it with the operation annotation to every agent (one
    Trace per node, as utils/trace.go:340 creates), surface status/output."""
    from ..agent.client import AgentClient
    from ..gadgets.trace_resource import OPERATION_ANNOTATION
    from .deploy import local_targets
    try:
        targets = parse_targets(args.remote) if args.remote else local_targets()
    except ParamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not targets:
        print("no agents (use deploy --local N or --remote)", file=sys.stderr)
        return 2
    params = {}
    if args.verb == "start":
        for kv in args.param:
            if "=" not in kv:
                print(f"error: bad -p {kv!r}: expected k=v", file=sys.stderr)
                return 2
            k, v = kv.split("=", 1)
            params[k] = v
    rc = 0
    for node, target in targets.items():
        client = AgentClient(target, node_name=node)
        try:
            if args.verb == "list":
                for doc in client.list_traces():
                    st = doc.get("status", {})
                    print(f"{node:12s} {doc['metadata']['name']:20s} "
                          f"{doc['spec'].get('gadget', ''):24s} "
                          f"{st.get('state', '')}"
                          + (f"  error: {st['operationError']}"
                             if st.get("operationError") else ""))
                continue
            if args.verb == "delete":
                print(f"{node}: deleted={client.delete_trace(args.name)}")
                continue
            if args.verb == "get":
                doc = client.get_trace(args.name)
            else:  # start/stop/generate ride the operation annotation
                doc = {
                    "metadata": {"name": args.name,
                                 "annotations": {OPERATION_ANNOTATION: args.verb}},
                    "spec": ({"gadget": args.gadget, "node": args.node,
                              "parameters": params}
                             if args.verb == "start" else {}),
                }
                doc = client.apply_trace(doc)
            st = doc.get("status", {})
            if st.get("operationError"):
                print(f"{node}: error: {st['operationError']}", file=sys.stderr)
                rc = 1
            elif args.verb in ("generate", "get") and st.get("output"):
                print(f"=== {node} ===")
                print(st["output"], end="" if st["output"].endswith("\n") else "\n")
            else:
                print(f"{node}: {doc['metadata']['name']} {st.get('state', '')}")
        except Exception as e:  # noqa: BLE001 — per-node isolation
            print(f"{node}: error: {e}", file=sys.stderr)
            rc = 1
        finally:
            client.close()
    return rc


def main(argv: list[str] | None = None) -> int:
    if _early_interrupt:
        return 0
    if _prev_sigint is not None:
        signal.signal(signal.SIGINT, _prev_sigint)
    if argv is None:
        argv = sys.argv[1:]
    # `agent` forwards verbatim (argparse REMAINDER can't pass through
    # leading --flags it doesn't own, e.g. `agent --metrics-addr :9100`)
    if argv and argv[0] == "agent":
        from ..agent.main import main as agent_main
        return agent_main(["serve", *argv[1:]])
    ap = build_parser()
    args = ap.parse_args(argv)
    if not hasattr(args, "func"):
        ap.print_help()
        return 0
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
