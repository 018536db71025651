"""`ig-tpu alerts` verbs: list | rules | test.

- list:  the active-alert table — this process's, plus every agent's via
         the DumpState RPC when --remote (or a local fleet) is given.
- rules: parse + validate a rule file and print what each rule means;
         exit 2 on any validation error (the same loud-load contract the
         operator enforces at run start).
- test:  replay harvested summaries (JSON lines) through a fresh engine
         and print the transitions they would cause — dry-running a rule
         file against recorded traffic before deploying it.

The port's copy of ``inspektor_gadget_tpu/cli/alerts.py``.
"""

from __future__ import annotations

import json
import os
import sys

from ..alerts import ACTIVE, AlertEngine, RuleError
from ..alerts.rules import load_rules_file


def add_alerts_parser(sub) -> None:
    ap = sub.add_parser("alerts", help="sketch-to-signal alerting plane: "
                        "active alerts, rule validation, rule dry-runs")
    asub = ap.add_subparsers(dest="alerts_verb", required=True)

    lp = asub.add_parser("list", help="active alerts (local + agents)")
    lp.add_argument("--remote", default="",
                    help="name=target[,...]; defaults to the local fleet")
    lp.add_argument("--active", action="store_true",
                    help="hide recently-resolved alerts")
    lp.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    lp.set_defaults(func=cmd_alerts_list)

    rp = asub.add_parser("rules", help="validate + describe a rule file")
    rp.add_argument("--file", required=True, help="YAML/JSON rule document")
    rp.set_defaults(func=cmd_alerts_rules)

    tp = asub.add_parser("test", help="dry-run rules against recorded "
                         "traffic (a capture journal, or the deprecated "
                         "JSON-lines summary format)")
    tp.add_argument("--file", required=True, help="YAML/JSON rule document")
    tp.add_argument("--journal", default="",
                    help="capture journal/recording/bundle to replay the "
                         "rules against (timing comes from the recorded "
                         "clock)")
    tp.add_argument("--summaries", default="",
                    help="DEPRECATED: JSON-lines file of summary dicts, "
                         "or '-' (stdin); prefer --journal")
    tp.add_argument("--interval", type=float, default=1.0,
                    help="simulated seconds between summaries "
                         "(--summaries path only; journals carry their "
                         "own clock)")
    tp.set_defaults(func=cmd_alerts_test)


def _fmt_row(a: dict) -> str:
    nodes = ",".join(a.get("nodes") or [])
    return (f"{a.get('rule', ''):<20s} {a.get('state', ''):<9s} "
            f"{a.get('severity', ''):<9s} {a.get('key', '') or '-':<18s} "
            f"{a.get('scope', ''):<8s} {a.get('value', 0.0):<12.4g} "
            f"{nodes}")


_HEADER = (f"{'RULE':<20s} {'STATE':<9s} {'SEVERITY':<9s} {'KEY':<18s} "
           f"{'SCOPE':<8s} {'VALUE':<12s} NODES")


def cmd_alerts_list(args) -> int:
    from ..params import ParamError
    from .main import _debug_targets
    try:
        targets = _debug_targets(args)
    except ParamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    tables: dict[str, list[dict]] = {
        "local": ACTIVE.active() if args.active else ACTIVE.all()}
    rc = 0
    for node, target in targets.items():
        from ..agent.client import AgentClient
        client = AgentClient(target, node_name=node)
        try:
            remote = client.dump_state().get("alerts", [])
            if args.active:
                remote = [a for a in remote
                          if a.get("state") in ("pending", "firing")]
            tables[node] = remote
        except Exception as e:  # noqa: BLE001 — per-node isolation
            print(f"{node}: error: {e}", file=sys.stderr)
            rc = 1
        finally:
            client.close()
    if args.output == "json":
        print(json.dumps(tables, indent=2, default=str))
        return rc
    printed = False
    for origin, alerts in tables.items():
        if not alerts:
            continue
        if not printed:
            print(_HEADER)
            printed = True
        for a in alerts:
            print(f"{_fmt_row(a)}  [{origin}]")
    if not printed:
        print("no alerts")
    return rc


def cmd_alerts_rules(args) -> int:
    try:
        rules = load_rules_file(args.file)
    except RuleError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"{len(rules)} rule(s) ok:")
    for r in rules:
        print(f"  {r.describe()}")
    return 0


def cmd_alerts_test(args) -> int:
    try:
        rules = load_rules_file(args.file)
    except RuleError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if bool(args.journal) == bool(args.summaries):
        print("error: set exactly one of --journal or --summaries",
              file=sys.stderr)
        return 2
    if args.journal:
        return _test_against_journal(args)
    print("warning: --summaries is a deprecated read path; record a "
          "capture journal and use --journal (see docs/capture.md)",
          file=sys.stderr)
    try:
        raw = (sys.stdin.read() if args.summaries == "-"
               else open(args.summaries, encoding="utf-8").read())
    except OSError as e:
        print(f"error: cannot read {args.summaries!r}: {e}", file=sys.stderr)
        return 2
    summaries = []
    for i, line in enumerate(raw.splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            summaries.append(json.loads(line))
        except json.JSONDecodeError as e:
            print(f"error: {args.summaries}:{i + 1}: bad JSON: {e}",
                  file=sys.stderr)
            return 2
    if not summaries:
        print("error: no summaries to replay", file=sys.stderr)
        return 2
    # a private engine + synthetic clock; dry_run keeps the replay out of
    # the process-wide table and the live telemetry gauges
    engine = AlertEngine(rules, node="dry-run", dry_run=True)
    transitions = 0
    now = 0.0
    for i, s in enumerate(summaries):
        for ev in engine.observe(s, now=now):
            transitions += 1
            print(f"summary #{i}: {ev.rule} -> {ev.transition}"
                  + (f" key={ev.key}" if ev.key else "")
                  + f" (value={ev.value:.6g}, threshold={ev.threshold:g})")
        now += args.interval
    print(f"{len(summaries)} summaries, {transitions} transition(s), "
          f"{len(engine.firing())} still firing")
    return 0


def _test_against_journal(args) -> int:
    """Dry-run a rule file against recorded journals: the journal's
    EV_SUMMARY records drive a private engine on the RECORDED clock, so
    for/cooldown decisions match what the rules would have done live."""
    from ..agent import wire
    from ..capture import JournalReader, ReplayClock, iter_journals
    rules = load_rules_file(args.file)
    if not os.path.isdir(args.journal):
        print(f"error: {args.journal}: not a directory", file=sys.stderr)
        return 2
    journals = list(iter_journals(args.journal))
    if not journals:
        print(f"error: no journals under {args.journal}", file=sys.stderr)
        return 2
    total_summaries = 0
    total_transitions = 0
    still_firing = 0
    for jpath in journals:
        reader = JournalReader(jpath)
        engine = AlertEngine(rules, node="dry-run", dry_run=True)
        clock = ReplayClock()
        n = 0
        for header, payload in reader.records(types=(wire.EV_SUMMARY,)):
            clock.advance_to(float(header.get("ts", 0.0)))
            summary = wire.decode_summary(header, payload)
            for ev in engine.observe(summary, now=clock.now()):
                total_transitions += 1
                print(f"{os.path.basename(jpath)} epoch "
                      f"{summary.get('epoch')}: {ev.rule} -> {ev.transition}"
                      + (f" key={ev.key}" if ev.key else "")
                      + f" (value={ev.value:.6g}, "
                        f"threshold={ev.threshold:g})")
            n += 1
        for loss in reader.losses:
            print(f"warning: {jpath}: torn tail dropped "
                  f"({loss.reason}, {loss.dropped_bytes} bytes)",
                  file=sys.stderr)
        total_summaries += n
        still_firing += len(engine.firing())
    print(f"{len(journals)} journal(s), {total_summaries} summaries, "
          f"{total_transitions} transition(s), {still_firing} still firing")
    return 0
