"""`ig-tpu history` — tiered-history lifecycle verbs.

    ig-tpu-torch history tiers [--history DIR] [-o json]
    ig-tpu-torch history compact --schedule 1m@24h,10m@7d,1h@inf [--history DIR]
    ig-tpu-torch history archive --archive-dir PATH [--level N] [--history DIR]

`tiers` renders the per-store, per-level footprint (windows, bytes,
oldest/newest timestamps) plus the archive tier's usage and cache
health — the "how much resolution do I still have for last Tuesday"
view. `compact` runs one compaction pass per store against a schedule;
`archive` offloads fully-compacted cold segments to the archive
backend. Both print what moved and exit nonzero only on hard errors —
"nothing aged enough" is a clean no-op, not a failure.

The port's copy of ``inspektor_gadget_tpu/cli/history.py``, on the local
store, and ``tiers --remote`` on the agents' DumpState.
"""

from __future__ import annotations

import json
import os
import sys
import time



def add_history_parser(sub) -> None:
    from ..history.lifecycle import DEFAULT_SCHEDULE
    hp = sub.add_parser(
        "history", help="tiered-history lifecycle: per-level tier stats, "
        "time-decayed compaction, archive offload")
    hsub = hp.add_subparsers(dest="history_cmd", required=True)

    tp = hsub.add_parser("tiers", help="windows/bytes per compaction "
                         "level and archive usage, per store")
    tp.add_argument("--history", default="",
                    help="history directory (default: the node area, "
                         "$IG_HISTORY_DIR)")
    tp.add_argument("--remote", default="",
                    help="read agents' tier stats via DumpState: "
                         "name=target[,...]")
    tp.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    tp.set_defaults(func=cmd_history_tiers)

    cp = hsub.add_parser("compact", help="one compaction pass: aged "
                         "windows merge into coarser super-windows")
    cp.add_argument("--history", default="",
                    help="history directory (default: the node area)")
    cp.add_argument("--schedule", default=DEFAULT_SCHEDULE,
                    help="resolution schedule res@horizon[,...]; last "
                         "horizon must be inf")
    cp.add_argument("--store", default="",
                    help="restrict to one store directory name")
    cp.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    cp.set_defaults(func=cmd_history_compact)

    ap = hsub.add_parser("archive", help="offload fully-compacted cold "
                         "segments to the archive backend")
    ap.add_argument("--history", default="",
                    help="history directory (default: the node area)")
    ap.add_argument("--archive-dir", required=True,
                    help="archive root (filesystem backend)")
    ap.add_argument("--cache-bytes", type=int, default=64 << 20,
                    help="rehydration cache budget (LRU by bytes)")
    ap.add_argument("--level", type=int, default=None,
                    help="minimum window level a segment must be fully "
                         "at to offload (default: the schedule's final "
                         "level)")
    ap.add_argument("--schedule", default=DEFAULT_SCHEDULE,
                    help="used only to derive the default --level")
    ap.add_argument("-o", "--output", default="table",
                    choices=["table", "json"])
    ap.set_defaults(func=cmd_history_archive)


def _ts(v) -> str:
    if not v:
        return "-"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(float(v)))


def cmd_history_tiers(args) -> int:
    from ..history import HISTORY
    from ..params import ParamError
    if args.remote:
        from .main import parse_targets
        try:
            targets = parse_targets(args.remote)
        except ParamError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        from ..agent.client import AgentClient
        per_node = {}
        rc = 0
        for node, target in targets.items():
            client = AgentClient(target, node)
            try:
                per_node[node] = client.dump_state().get(
                    "history_tiers") or {}
            except Exception as e:  # noqa: BLE001 — per-node isolation
                per_node[node] = {"error": str(e)}
                rc = 1
            finally:
                client.close()
        if args.output == "json":
            print(json.dumps(per_node, indent=2, default=str))
            return rc
        for node, tiers in per_node.items():
            print(f"== {node} ==")
            _print_tiers(tiers)
        return rc
    stats = HISTORY.stats(args.history or None)
    tiers = HISTORY.tier_stats(args.history or None)
    if args.output == "json":
        print(json.dumps({"tiers": tiers, "stores": stats["stores"]},
                         indent=2, default=str))
        return 0
    _print_tiers(tiers)
    for name, srow in stats["stores"].items():
        lvl_s = ", ".join(
            f"L{lvl}:{row['windows']}w/{row['bytes']}B"
            for lvl, row in (srow.get("levels") or {}).items()) or "empty"
        print(f"  {name}: {lvl_s}")
    return 0


def _print_tiers(tiers: dict) -> None:
    if tiers.get("error"):
        print(f"  error: {tiers['error']}")
        return
    print(f"{tiers.get('stores', 0)} store(s), "
          f"{tiers.get('bytes', 0)} bytes local")
    for lvl, row in (tiers.get("levels") or {}).items():
        print(f"  level {lvl}: {row['windows']} window(s), "
              f"{row['bytes']} bytes, "
              f"{_ts(row['oldest_ts'])} .. {_ts(row['newest_ts'])}")
    arch = tiers.get("archived") or {}
    if arch.get("segments"):
        cache = tiers.get("archive_cache") or {}
        print(f"  archive: {arch['segments']} segment(s), "
              f"{arch['windows']} window(s), {arch['bytes']} bytes "
              f"(cache {cache.get('bytes', 0)}/{cache.get('budget', 0)} "
              f"bytes, {cache.get('hits', 0)} hit(s) / "
              f"{cache.get('misses', 0)} miss(es))")


def cmd_history_compact(args) -> int:
    from ..history import HISTORY, CompactionEngine, parse_schedule
    try:
        parse_schedule(args.schedule)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    _warn_if_cross_process()
    engine = CompactionEngine(args.schedule)
    base = args.history or None
    results = []
    for store_dir in HISTORY.store_dirs(base):
        if args.store and os.path.basename(store_dir) != args.store:
            continue
        try:
            results.append(engine.compact_store(store_dir))
        except (OSError, ValueError) as e:
            results.append({"store": store_dir, "error": str(e)})
    if args.output == "json":
        print(json.dumps(results, indent=2, default=str))
    else:
        if not results:
            print("no history stores found")
        for r in results:
            if r.get("error"):
                print(f"{r['store']}: error: {r['error']}",
                      file=sys.stderr)
                continue
            print(f"{r['store']}: {r['source_windows']} window(s) -> "
                  f"{r['super_windows']} super-window(s), "
                  f"{r['segments_deleted']} segment(s) GC'd, "
                  f"{r['bytes_reclaimed']} bytes reclaimed")
    return 1 if any(r.get("error") for r in results) else 0


def _warn_if_cross_process() -> None:
    """compact/archive WRITE through a fresh journal writer whose lock
    is in-process only: running them against a store a live run is
    still sealing into is not coordinated (the run's own compaction,
    --tpusketch-history-compact, is the sanctioned live path)."""
    print("note: compacting/archiving writes to the store — run against "
          "a quiesced store; a live run should use its own "
          "--tpusketch-history-compact pass instead",
          file=sys.stderr)


def cmd_history_archive(args) -> int:
    _warn_if_cross_process()

    from ..history import (ArchiveTier, FilesystemArchive, HISTORY,
                           history_base_dir, parse_schedule)
    base = history_base_dir(args.history or None)
    min_level = args.level
    if min_level is None:
        try:
            min_level = len(parse_schedule(args.schedule)) - 1
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    tier = ArchiveTier(FilesystemArchive(args.archive_dir),
                       cache_dir=os.path.join(base, ".archive-cache"),
                       cache_bytes=args.cache_bytes)
    results = []
    for store_dir in HISTORY.store_dirs(args.history or None):
        try:
            writer = HISTORY.writer_for_dir(store_dir)
            results.append(tier.archive_store(store_dir,
                                              min_level=min_level,
                                              writer=writer))
        except (OSError, ValueError) as e:
            results.append({"store": store_dir, "error": str(e)})
    if args.output == "json":
        print(json.dumps(results, indent=2, default=str))
    else:
        if not results:
            print("no history stores found")
        for r in results:
            if r.get("error"):
                print(f"{r['store']}: error: {r['error']}",
                      file=sys.stderr)
                continue
            print(f"{r['store']}: {r['segments']} segment(s) archived "
                  f"({r['windows']} window(s), {r['bytes']} bytes)")
    return 1 if any(r.get("error") for r in results) else 0
