"""HistoryStore — the per-node sealed-window sketch store.

Live sketch state is cumulative and volatile; this store is where the
tpusketch operator seals one window of it at each boundary, giving the
node a durable, range-readable history. The on-disk format IS the
capture journal format (capture/journal.py): every sealed window is one
EV_WINDOW frame appended with a single O_APPEND write, CRC-framed, so a
node killed mid-seal leaves exactly one torn window at the active
segment's tail — dropped-and-accounted on read, never half-decoded.
Size/age rotation seals segments into index.jsonl; retention GC deletes
the oldest sealed segments and never the active one; the manifest
stamps the same provenance (git sha, resolved params, platform/degraded
probe outcome) a capture journal carries.

The history-specific additions on top of the journal machinery:

- index rows carry the union of subpopulation keys and the window count
  of the segment they seal, so range queries with a ``--key`` filter
  skip whole segments without decoding them;
- history traffic accounts into its own ``ig_history_*`` counters, not
  the capture plane's;
- one store directory per (node, gadget) identity under the base area
  (``--history-dir`` / $IG_HISTORY_DIR / ~/.ig-tpu/history), so
  concurrent runs of one gadget share a window timeline the way they
  share a checkpoint key — and in-process agent fleets (tests, the
  deploy --local path) never interleave two nodes' windows in one
  journal.

Layout:

    <base>/[<node>--]<gadget-key>/
      manifest.json   index.jsonl   seg-*.igj   # EV_WINDOW frames

The port's copy of ``inspektor_gadget_tpu/history/store.py``: the same
bytes on disk, so a node running either package writes windows the other
reads, compacts, archives and merges. Its ``ig_history_*`` metrics live on
the port's registry.
"""

from __future__ import annotations

import os
import threading
from typing import Iterator

from ..agent import wire
from ..capture.journal import (
    JournalMetrics,
    JournalReader,
    JournalWriter,
    _seg_name,
    build_manifest,
    is_journal,
)
from ..telemetry import counter, gauge
from ..utils.logger import get_logger
from .window import SealedWindow, encode_window, header_overlaps

HISTORY_SCHEMA = "ig-tpu/sketch-history/v1"

DEFAULT_SEGMENT_BYTES = 8 << 20
DEFAULT_SEGMENT_AGE = 300.0
DEFAULT_RETENTION_BYTES = 512 << 20
DEFAULT_RETENTION_SEGMENTS = 0

log = get_logger("ig-tpu.history")

HISTORY_METRICS = JournalMetrics(
    records=counter("ig_history_windows_total",
                    "sealed sketch windows appended to history stores",
                    ("type",)),
    bytes=counter("ig_history_bytes_total",
                  "bytes appended to history stores"),
    drops=counter("ig_history_drops_total",
                  "history windows lost (torn tails, failed appends)",
                  ("reason",)),
    gc=counter("ig_history_gc_total",
               "sealed history segments deleted by retention GC"),
    active=gauge("ig_history_active_stores", "open history store writers"),
)


def history_base_dir(path: str | None = None) -> str:
    """The node-wide window area: $IG_HISTORY_DIR, else
    ~/.ig-tpu/history (agents override with --history-dir)."""
    return (path or os.environ.get("IG_HISTORY_DIR")
            or os.path.join(os.path.expanduser("~"), ".ig-tpu", "history"))


def validate_store_name(name: str) -> str:
    """Store (gadget-key) names resolve under the base dir from
    client-supplied RPC fields — same escape surface as recording ids,
    same check."""
    if (not name or name != os.path.basename(name)
            or name in (".", "..")):
        raise ValueError(f"bad history store name {name!r}")
    return name


class _WindowJournal(JournalWriter):
    """JournalWriter that accumulates, per active segment, the union of
    subpopulation keys and the window count, sealing both into the
    segment's index row (the Hydra-style pruning index).

    The outer _win_mu serializes append+key-accounting against rotation
    and close: without it, a concurrent run sharing this writer could
    seal the segment's index row between another run's frame landing
    and its keys being recorded — and a missing key prunes that window
    out of every ``--key`` query."""

    def __init__(self, *args, **kwargs):
        self._win_mu = threading.Lock()
        self._seg_keys: set[str] = set()
        self._seg_windows = 0
        super().__init__(*args, **kwargs)

    def _index_extra_locked(self) -> dict:
        row = {"keys": sorted(self._seg_keys),
               "windows": self._seg_windows}
        self._seg_keys = set()
        self._seg_windows = 0
        return row

    def append_window_frame(self, header: dict, payload: bytes,
                            keys: list[str], ts: float | None) -> int:
        with self._win_mu:
            # rotation inside append() seals the PREVIOUS segment first
            # (this frame hasn't landed yet, so its keys belong to the
            # fresh segment the accounting below annotates)
            seq = self.append(wire.EV_WINDOW, header, payload, ts=ts)
            self._seg_keys.update(keys)
            self._seg_windows += 1
            return seq

    def rotate(self) -> None:
        with self._win_mu:
            super().rotate()

    def sync(self) -> None:
        """fsync the active segment — the compaction engine's durability
        barrier: a super-window frame must survive a crash BEFORE any of
        its source segments is GC'd, or coverage is lost."""
        with self._win_mu, self._mu:
            try:
                fd = os.open(self._active_path(), os.O_RDONLY)
            except OSError:
                return  # nothing appended yet: nothing to make durable
            try:
                os.fsync(fd)
            finally:
                os.close(fd)

    def remove_segments(self, names: list[str], *,
                        count_gc: bool = False
                        ) -> tuple[int, int]:
        """Delete sealed segments by name under the writer lock — the
        one door compaction/archive GC and retention GC share, so the
        two can never double-free a file or race the active segment
        (which is refused here unconditionally). Returns
        (removed, bytes_freed); missing files are skipped, not errors
        (a concurrent retention pass may have won the race)."""
        removed, freed = 0, 0
        with self._win_mu, self._mu:
            active = _seg_name(self._seg_n)
            for name in names:
                if not name or name == active \
                        or name != os.path.basename(name):
                    continue
                path = os.path.join(self.path, name)
                try:
                    size = os.path.getsize(path)
                    os.remove(path)
                except OSError:
                    continue
                removed += 1
                freed += size
                if count_gc:
                    self._m.gc.inc()
        return removed, freed

    def close(self) -> dict:
        with self._win_mu:
            return super().close()


class HistoryStore:
    """Process-wide singleton (HISTORY) the tpusketch operator seals
    into — the role RECORDINGS plays for the capture plane."""

    def __init__(self):
        self._mu = threading.Lock()
        self._base: str | None = None
        self._writers: dict[tuple[str, str], _WindowJournal] = {}
        # archive tiers are a property of a history AREA (base dir), not
        # of the process: one tier per base, so a run pointing at its
        # own --history-dir cannot rewire another area's rehydration
        self._archives: dict[str, "object"] = {}

    # -- configuration ------------------------------------------------------

    def set_base_dir(self, path: str | None) -> None:
        """Agent --history-dir / test override of the default area."""
        with self._mu:
            self._base = path or None

    def base_dir(self) -> str:
        with self._mu:
            return history_base_dir(self._base)

    def configured(self) -> bool:
        """True when an explicit base was set (agent flag / operator
        param) — sealing stays off until someone opts the node in, like
        recording stays off until armed."""
        with self._mu:
            return self._base is not None

    def set_archive(self, archive_dir: str | None,
                    cache_bytes: int | None = None,
                    base_dir: str | None = None) -> None:
        """Configure (or clear) the archive tier for ONE history area
        (base_dir; default the current base): a FilesystemArchive
        rooted at archive_dir, with the rehydration cache under that
        area (bounded LRU by cache_bytes). Agents opt in via
        --history-archive-dir / operator history-archive-dir."""
        base = os.path.abspath(history_base_dir(base_dir)
                               if base_dir else self.base_dir())
        if not archive_dir:
            with self._mu:
                self._archives.pop(base, None)
            return
        from .archive import ArchiveTier, FilesystemArchive
        tier = ArchiveTier(
            FilesystemArchive(archive_dir),
            cache_dir=os.path.join(base, ".archive-cache"),
            cache_bytes=cache_bytes or (64 << 20))
        with self._mu:
            self._archives[base] = tier

    def archive(self, base_dir: str | None = None):
        """The ArchiveTier configured for one history area (default
        the current base), or None."""
        base = os.path.abspath(base_dir or self.base_dir())
        with self._mu:
            return self._archives.get(base)

    # -- writing ------------------------------------------------------------

    def writer_for(self, gadget: str, *, node: str = "", run_id: str = "",
                   params: dict[str, str] | None = None,
                   base_dir: str | None = None,
                   max_segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                   max_segment_age: float = DEFAULT_SEGMENT_AGE,
                   retention_bytes: int = DEFAULT_RETENTION_BYTES,
                   retention_segments: int = DEFAULT_RETENTION_SEGMENTS,
                   platform: str = "unprobed",
                   ) -> _WindowJournal:
        """The (lazily opened, reopen-tolerant) window journal for one
        (node, gadget) identity. Reopening an existing store recovers
        the journal's way: torn tail truncated and accounted, seq continues."""
        gadget_key = validate_store_name(gadget.replace("/", "-"))
        key_name = (validate_store_name(f"{node}--{gadget_key}") if node
                    else gadget_key)
        base = base_dir or self.base_dir()
        key = (base, key_name)
        with self._mu:
            w = self._writers.get(key)
            if w is None:
                manifest = build_manifest(
                    journal_id=key_name, node=node, gadget=gadget,
                    run_id=run_id, params=params, platform=platform,
                    extra={"schema": HISTORY_SCHEMA})
                w = _WindowJournal(
                    os.path.join(base, key_name),
                    manifest=manifest,
                    max_segment_bytes=max_segment_bytes,
                    max_segment_age=max_segment_age,
                    retention_bytes=retention_bytes,
                    retention_segments=retention_segments,
                    metrics=HISTORY_METRICS)
                self._writers[key] = w
        return w

    def writer_for_dir(self, store_dir: str) -> _WindowJournal:
        """The (cached) writer for an existing store directory — the
        compaction engine resolves stores by path, not identity. The
        (node, gadget) identity is recovered from the directory name,
        so the engine and a live sealer of the same store share ONE
        writer (and its lock)."""
        base = os.path.dirname(os.path.abspath(store_dir))
        name = os.path.basename(os.path.abspath(store_dir))
        node, sep, gadget_key = name.partition("--")
        if not sep:
            node, gadget_key = "", name
        return self.writer_for(gadget_key, node=node, base_dir=base)

    def append_window(self, win: SealedWindow, *,
                      writer: _WindowJournal) -> int:
        """Seal one window: ONE frame, ONE O_APPEND write. Returns the
        store seq; on failure the loss is counted, logged, and re-raised
        (the caller decides whether a failed seal stops the run — the
        operator logs and continues, like a failed checkpoint)."""
        header, payload = encode_window(win)
        seq = writer.append_window_frame(header, payload, win.slice_keys,
                                         win.end_ts or None)
        win.seq = seq
        return seq

    def release(self, writer: _WindowJournal) -> None:
        """A run using this store ended: force-seal the active segment
        so its windows get index rows (fan-out pruning), but keep the
        writer open for the next run of the same identity."""
        writer.rotate()

    def close_all(self) -> None:
        with self._mu:
            writers = list(self._writers.values())
            self._writers.clear()
        for w in writers:
            w.close()

    # -- reading ------------------------------------------------------------

    def store_dirs(self, base_dir: str | None = None) -> list[str]:
        base = base_dir or self.base_dir()
        out = []
        if os.path.isdir(base):
            for name in sorted(os.listdir(base)):
                p = os.path.join(base, name)
                if is_journal(p):
                    out.append(p)
        return out

    def list_windows(self, *, base_dir: str | None = None,
                     gadget: str = "", node: str = "",
                     start_ts: float | None = None,
                     end_ts: float | None = None,
                     start_seq: int | None = None,
                     end_seq: int | None = None,
                     key: str | None = None,
                     losses: list | None = None) -> list[dict]:
        """Window HEADER rows across this node's stores, oldest first,
        restricted to the range/slice. Torn tails are accounted into
        `losses` when a list is passed. No payload bytes leave this
        call, but the scan still inflates whole frames to read headers
        — a header-only side index is the known optimization when store
        sizes grow (the next arc's perf pass owns it)."""
        out: list[dict] = []
        for h, _payload in self._iter_frames(
                base_dir=base_dir, gadget=gadget, node=node,
                start_ts=start_ts,
                end_ts=end_ts, start_seq=start_seq, end_seq=end_seq,
                key=key, losses=losses, with_payload=False):
            out.append(h)
        return out

    def fetch_windows(self, *, base_dir: str | None = None,
                      gadget: str = "", node: str = "",
                      start_ts: float | None = None,
                      end_ts: float | None = None,
                      start_seq: int | None = None,
                      end_seq: int | None = None,
                      key: str | None = None,
                      losses: list | None = None
                      ) -> Iterator[tuple[dict, bytes]]:
        """(header, payload) pairs for every matching window."""
        return self._iter_frames(
            base_dir=base_dir, gadget=gadget, node=node, start_ts=start_ts,
            end_ts=end_ts, start_seq=start_seq, end_seq=end_seq,
            key=key, losses=losses, with_payload=True)

    def _iter_frames(self, *, base_dir, gadget, start_ts, end_ts,
                     start_seq, end_seq, key, losses,
                     with_payload, node="") -> Iterator[tuple[dict, bytes]]:
        # gadget filtering matches each window header's exact gadget id
        # (store dir names are node-qualified); the basename check only
        # prunes stores that cannot match
        want_suffix = gadget.replace("/", "-") if gadget else ""
        for store in self.store_dirs(base_dir):
            base_name = os.path.basename(store)
            if want_suffix and not (
                    base_name == want_suffix
                    or base_name.endswith(f"--{want_suffix}")):
                continue
            try:
                reader = JournalReader(store, metrics=HISTORY_METRICS)
            except FileNotFoundError:
                continue
            # the per-segment index rows carry the union of slice keys:
            # a --key query skips sealed segments that never saw it
            skip_files = set()
            if key:
                for row in reader.index:
                    if "keys" in row and key not in (row.get("keys") or []):
                        skip_files.add(row.get("file"))
            # the frame ts is the window's END ts, so the reader-level
            # start_ts filter is safe (end < start cannot overlap) but an
            # end_ts filter is NOT: a window straddling the range end has
            # frame ts > end_ts yet overlaps. The end bound is applied
            # only by header_overlaps below, on start_ts.
            for header, payload in reader.records(
                    start_seq=start_seq, end_seq=end_seq,
                    start_ts=start_ts,
                    types=(wire.EV_WINDOW,)):
                if skip_files and self._seg_of(reader, header) in skip_files:
                    continue
                if gadget and header.get("gadget") != gadget:
                    continue
                if node and header.get("node") != node:
                    # an agent serves only the windows ITS runs sealed —
                    # in-process fleets (tests, deploy --local) share one
                    # base area, and a fan-out that got every node's
                    # windows from every node would double-count merges
                    continue
                if not header_overlaps(header, start_ts=start_ts,
                                       end_ts=end_ts, start_seq=start_seq,
                                       end_seq=end_seq, key=key):
                    continue
                yield header, (payload if with_payload else b"")
            if losses is not None and reader.losses:
                for loss in reader.losses:
                    losses.append({"store": os.path.basename(store),
                                   **loss.__dict__})
            # archive tier: ranges overlapping offloaded segments
            # rehydrate through the manifest (digest-verified; a
            # corrupted object lands in `losses`, never in the fold)
            arch = self.archive(os.path.dirname(store))
            if arch is not None:
                for header, payload in arch.frames_for_range(
                        store, start_ts=start_ts, end_ts=end_ts,
                        start_seq=start_seq, end_seq=end_seq, key=key,
                        losses=losses):
                    if gadget and header.get("gadget") != gadget:
                        continue
                    if node and header.get("node") != node:
                        continue
                    if not header_overlaps(
                            header, start_ts=start_ts, end_ts=end_ts,
                            start_seq=start_seq, end_seq=end_seq, key=key):
                        continue
                    yield header, (payload if with_payload else b"")

    @staticmethod
    def _seg_of(reader: JournalReader, header: dict) -> str | None:
        seq = header.get("seq")
        for row in reader.index:
            first, last = row.get("first_seq"), row.get("last_seq")
            if first is not None and last is not None \
                    and first <= seq <= last:
                return row.get("file")
        return None

    def stats(self, base_dir: str | None = None) -> dict:
        """Per-store window counts + disk usage (doctor / top windows /
        `ig-tpu history tiers`), broken down per compaction level and
        per tier: each level reports windows, payload bytes, and its
        oldest/newest window timestamps, so "how much resolution do I
        still have for last Tuesday" reads straight off the store."""
        from ..capture.journal import dir_stats
        base = base_dir or self.base_dir()
        arch = self.archive(base)
        stores = {}
        for store in self.store_dirs(base):
            reader = JournalReader(store, metrics=HISTORY_METRICS)
            windows = 0
            levels: dict[int, dict] = {}
            for header, payload in reader.records(
                    types=(wire.EV_WINDOW,)):
                windows += 1
                lvl = int(header.get("level", 0))
                row = levels.setdefault(
                    lvl, {"windows": 0, "bytes": 0,
                          "oldest_ts": None, "newest_ts": None,
                          "source_windows": 0})
                row["windows"] += 1
                row["bytes"] += len(payload)
                start = float(header.get("start_ts", 0.0))
                end = float(header.get("end_ts", 0.0))
                row["oldest_ts"] = (start if row["oldest_ts"] is None
                                    else min(row["oldest_ts"], start))
                row["newest_ts"] = (end if row["newest_ts"] is None
                                    else max(row["newest_ts"], end))
                row["source_windows"] += (
                    len(header.get("compacted_from") or []) or 1)
            stores[os.path.basename(store)] = {
                "path": store,
                "windows": windows,
                "levels": {str(k): v for k, v in sorted(levels.items())},
                "segments": len(reader._segment_files()),
                "losses": [loss.__dict__ for loss in reader.losses],
                "archive": (arch.stats(store) if arch is not None
                            else None),
            }
        segments, total_bytes = dir_stats(base) if os.path.isdir(base) \
            else (0, 0)
        return {"base": base, "stores": stores,
                "segments": segments, "bytes": total_bytes}

    def tier_stats(self, base_dir: str | None = None, *,
                   ttl: float = 0.0) -> dict:
        """The fleet-facing tier summary (DumpState / doctor
        history_tiers): windows+bytes per level across every store,
        plus the archive tier's footprint and cache health. The walk
        decodes every store frame, so hot polled surfaces (DumpState —
        fleet health/runs/alerts all ride it) pass a ttl and reuse the
        last answer instead of re-scanning a possibly-large store on
        every poll."""
        import time as _time
        base = os.path.abspath(base_dir or self.base_dir())
        if ttl > 0:
            with self._mu:
                cached = getattr(self, "_tier_cache", None)
            if cached is not None and cached[0] == base \
                    and _time.monotonic() - cached[1] < ttl:
                return cached[2]
        full = self.stats(base_dir)
        by_level: dict[str, dict] = {}
        archived = {"segments": 0, "bytes": 0, "windows": 0}
        cache = None
        for srow in full["stores"].values():
            for lvl, row in (srow.get("levels") or {}).items():
                agg = by_level.setdefault(
                    lvl, {"windows": 0, "bytes": 0,
                          "oldest_ts": None, "newest_ts": None})
                agg["windows"] += row["windows"]
                agg["bytes"] += row["bytes"]
                for k, fn in (("oldest_ts", min), ("newest_ts", max)):
                    if row[k] is not None:
                        agg[k] = (row[k] if agg[k] is None
                                  else fn(agg[k], row[k]))
            a = srow.get("archive")
            if a:
                archived["segments"] += a["segments"]
                archived["bytes"] += a["bytes"]
                archived["windows"] += a["windows"]
                cache = a["cache"]
        out = {"base": full["base"], "stores": len(full["stores"]),
               "bytes": full["bytes"], "levels": by_level,
               "archived": archived, "archive_cache": cache}
        with self._mu:
            self._tier_cache = (base, _time.monotonic(), out)
        return out


# the process-wide singleton the tpusketch operator seals into
HISTORY = HistoryStore()

__all__ = ["DEFAULT_RETENTION_BYTES", "DEFAULT_SEGMENT_AGE",
           "DEFAULT_SEGMENT_BYTES", "HISTORY", "HISTORY_METRICS",
           "HISTORY_SCHEMA", "HistoryStore", "history_base_dir",
           "validate_store_name"]
