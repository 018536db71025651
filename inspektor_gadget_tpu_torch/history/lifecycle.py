"""Tiered history lifecycle: time-decayed compaction of sealed windows.

The history plane seals windows at ONE resolution forever — fine
for hours, wrong for months: store size grows without bound and every
fleet query pays O(windows). Following the resolution-over-time idea in
"Sketch Disaggregation Across Time and Space" (arxiv 2503.13515) — old
data keeps answering queries, just at coarser resolution — retention
becomes a *policy*: a resolution schedule like

    1m@24h,10m@7d,1h@inf

reads "keep native (~1m) windows for 24h; older than that, merge into
10m super-windows; older than 7d, into 1h super-windows; the last level
is kept forever (or until the archive tier offloads it)". Each entry is
``<resolution>@<horizon>``; both sides are Go-style durations (plus a
``d`` day suffix), the final horizon must be ``inf``/``∞``.

The CompactionEngine walks a store's SEALED segments (the active one is
never touched) against the schedule and, per aged source window, folds
it into the super-window of its target-level time bucket via the
existing merge algebra — CMS/entropy add, HLL max, candidate union,
slice-key union — so compaction adds NO error beyond the coarser time
resolution itself (the sketches are homomorphic). Crash discipline is
the journal's, extended one step:

1. every super-window is ONE appended frame (CRC'd, O_APPEND) through
   the store's own writer, carrying a ``compacted_from`` provenance
   list (one {digest, seq, ts-range} row per source window);
2. the active segment is fsync'd, then force-rotated so super-windows
   get their own index row;
3. ONLY then are the source segments deleted (under the writer lock,
   never the active segment).

A SIGKILL anywhere in that sequence loses no coverage: sources survive
until step 3, and a query that sees both a super-window and its
not-yet-GC'd sources dedups by digest (history/query.py
dedupe_compacted) — exactly-once by construction. The next compaction
pass recognizes covered sources and finishes the GC without re-merging.

The port's copy of ``inspektor_gadget_tpu/history/lifecycle.py``: given
the same store and clock, its passes write the reference's bytes. The
schedule grammar's one copy in the port lives here; the tpusketch
operator's ``history-schedule`` param validates with `validate_schedule`.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import threading
import time
from typing import Callable

from ..params.validators import parse_duration
from ..telemetry import counter
from ..utils.logger import get_logger

log = get_logger("ig-tpu.history.lifecycle")

DEFAULT_SCHEDULE = "1m@24h,10m@7d,1h@inf"

_tm_compactions = counter(
    "ig_history_compactions_total",
    "compaction passes that rewrote aged windows into super-windows "
    "(or finished a crashed pass's source GC)")
_tm_compacted = counter(
    "ig_history_compacted_windows_total",
    "source windows folded into coarser super-windows, by target level",
    ("level",))
_tm_reclaimed = counter(
    "ig_history_compaction_reclaimed_bytes_total",
    "bytes of source segments deleted after their super-windows became "
    "durable")

_INF = ("inf", "infinite", "∞")
_DAYS = re.compile(r"^(\d+(?:\.\d+)?)d(.*)$")


def _parse_span(s: str) -> float:
    """Duration grammar of the schedule: parse_duration plus a leading
    ``<n>d`` day term (retention policies speak in days) and ``inf``."""
    s = s.strip()
    if s.lower() in _INF:
        return math.inf
    total = 0.0
    m = _DAYS.match(s)
    if m:
        total += float(m.group(1)) * 86400.0
        s = m.group(2)
        if not s:
            return total
    return total + parse_duration(s)


@dataclasses.dataclass(frozen=True)
class ScheduleLevel:
    """One tier: windows live at `resolution` until `horizon` old."""
    resolution: float    # target super-window length, seconds
    horizon: float       # age past which this level compacts upward


def parse_schedule(spec: str) -> list[ScheduleLevel]:
    """``res@horizon[,res@horizon...]`` → validated levels. Loud on
    every malformation: this is the params-layer validator, and a bad
    retention policy must fail the run before the first seal, not eat
    history later."""
    entries = [e.strip() for e in (spec or "").split(",") if e.strip()]
    if not entries:
        raise ValueError(f"empty resolution schedule {spec!r}")
    levels: list[ScheduleLevel] = []
    for i, entry in enumerate(entries):
        res_s, sep, hor_s = entry.partition("@")
        if not sep or not res_s.strip() or not hor_s.strip():
            raise ValueError(
                f"schedule entry {entry!r} is not <resolution>@<horizon>")
        try:
            res = _parse_span(res_s)
            hor = _parse_span(hor_s)
        except ValueError as e:
            raise ValueError(f"schedule entry {entry!r}: {e}") from None
        if not math.isfinite(res) or res <= 0:
            raise ValueError(
                f"schedule entry {entry!r}: resolution must be a finite "
                "positive duration")
        if hor <= 0:
            raise ValueError(
                f"schedule entry {entry!r}: horizon must be > 0")
        levels.append(ScheduleLevel(resolution=res, horizon=hor))
    for a, b in zip(levels, levels[1:]):
        if b.resolution <= a.resolution:
            raise ValueError(
                f"schedule {spec!r}: resolutions must strictly coarsen "
                f"({b.resolution:g}s after {a.resolution:g}s)")
        if b.horizon <= a.horizon:
            raise ValueError(
                f"schedule {spec!r}: horizons must strictly grow "
                f"({b.horizon:g}s after {a.horizon:g}s)")
    if math.isfinite(levels[-1].horizon):
        raise ValueError(
            f"schedule {spec!r}: the last horizon must be inf — data "
            "either lives forever at the coarsest level or moves to the "
            "archive tier, it never silently vanishes")
    for lvl in levels[:-1]:
        if not math.isfinite(lvl.horizon):
            raise ValueError(
                f"schedule {spec!r}: only the last horizon may be inf")
    return levels


def validate_schedule(value: str) -> None:
    """ParamDesc validator shim (raises ValueError, returns nothing)."""
    parse_schedule(value)


class CompactionEngine:
    """Background compactor for history stores. One engine serves any
    number of stores; a per-store lock serializes passes against each
    other, and every mutation of store files goes through the store's
    own _WindowJournal writer lock so compaction coexists with the
    active sealer and with retention GC (which runs under that same
    lock inside append)."""

    def __init__(self, schedule: str | list[ScheduleLevel]
                 = DEFAULT_SCHEDULE, *,
                 store=None, clock: Callable[[], float] = time.time):
        self.schedule = (parse_schedule(schedule)
                         if isinstance(schedule, str) else list(schedule))
        self._store = store
        self.clock = clock
        self._mu = threading.Lock()
        self._locks: dict[str, threading.Lock] = {}
        self._last_pass: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # test-only crash-injection point: called after super-windows are
        # durable (fsync + rotate) and BEFORE source GC — the widest
        # window in which a SIGKILL leaves both tiers on disk
        self._before_gc: Callable[[], None] | None = None

    @property
    def store(self):
        if self._store is None:
            from .store import HISTORY
            self._store = HISTORY
        return self._store

    def _lock_for(self, store_dir: str) -> threading.Lock:
        with self._mu:
            return self._locks.setdefault(os.path.abspath(store_dir),
                                          threading.Lock())

    # -- one pass over one store -------------------------------------------

    def compact_store(self, store_dir: str) -> dict:
        """Fold every fully-aged sealed segment's windows into coarser
        super-windows, then GC the sources. Returns the pass stats. A
        sealed segment is compactable only when EVERY window in it is
        past its level's horizon (and below the final level) or already
        covered by a durable super-window — partial segments wait, so a
        source segment is deleted exactly once and only whole."""
        from ..agent import wire
        from ..capture.journal import JournalReader, scan_segment
        from .store import HISTORY_METRICS
        from .window import (decode_window, encode_window, merge_windows,
                             merged_to_sealed, provenance_row)
        stats = {"store": os.path.basename(store_dir), "source_windows": 0,
                 "super_windows": 0, "segments_deleted": 0,
                 "bytes_reclaimed": 0, "levels": {}}
        final = len(self.schedule) - 1
        if final < 1:
            return stats  # single-level schedule: nothing ever compacts
        with self._lock_for(store_dir):
            reader = JournalReader(store_dir, metrics=HISTORY_METRICS)
            sealed = {str(row.get("file", "")) for row in reader.index}
            # digests already covered by a durable super-window anywhere
            # in the store (crash recovery: their sources just need GC)
            covered: set[str] = set()
            for header, _p in reader.records(types=(wire.EV_WINDOW,)):
                for row in header.get("compacted_from") or []:
                    if row.get("digest"):
                        covered.add(row["digest"])
            now = self.clock()
            candidates: list[tuple[str, list]] = []  # (segname, to_merge)
            for seg in reader._segment_files():
                name = os.path.basename(seg)
                if name not in sealed:
                    continue  # the active segment is NEVER compacted
                records, loss = scan_segment(seg)
                if loss is not None or not records:
                    continue  # torn sealed segment: readers account it
                to_merge = []
                eligible = True
                for h, p in records:
                    if h.get("type") != wire.EV_WINDOW:
                        eligible = False
                        break
                    if h.get("digest") in covered:
                        continue  # already folded by a crashed pass
                    lvl = int(h.get("level", 0))
                    if lvl >= final:
                        eligible = False  # coarsest tier: archive's job
                        break
                    horizon = self.schedule[min(lvl, final)].horizon
                    if now - float(h.get("end_ts", 0.0)) <= horizon:
                        eligible = False  # still inside its level's life
                        break
                    to_merge.append((h, p))
                if eligible:
                    candidates.append((name, to_merge))
            if not candidates:
                return stats
            writer = self.store.writer_for_dir(store_dir)
            # bucket by (target level, time bucket, sketch geometry):
            # geometry rides the key so merge_windows never has to skip
            # a window inside a bucket — a skipped window would lose
            # coverage when its segment is GC'd
            buckets: dict[tuple, list] = {}
            for _name, to_merge in candidates:
                for h, p in to_merge:
                    win = decode_window(h, p)
                    win.seq = int(h.get("seq", 0))
                    tgt = min(win.level + 1, final)
                    res = self.schedule[tgt].resolution
                    bucket = math.floor(win.start_ts / res)
                    geom = (win.cms.shape, win.hll.shape, win.ent.shape)
                    buckets.setdefault((tgt, bucket, geom), []).append(win)
            folded: set[str] = set()   # digests durably merged this pass
            for (tgt, bucket, _geom), wins in sorted(
                    buckets.items(), key=lambda kv: kv[0][:2]):
                merged = merge_windows(wins)
                if merged.skipped:
                    # the bucket key covers the MAIN sketch geometry but
                    # a slice plane can still mismatch (windows sealed
                    # by a build with different slice constants). A
                    # partial merge would silently drop that slice's
                    # coverage when the sources are GC'd — leave the
                    # whole bucket at its current level and report.
                    for note in merged.skipped:
                        log.warning("compaction skipped a bucket: %s",
                                    note)
                    stats["skipped_buckets"] = \
                        stats.get("skipped_buckets", 0) + 1
                    continue
                sw = merged_to_sealed(
                    merged, gadget=wins[0].gadget, node=wins[0].node,
                    level=tgt, window=bucket, run_id="compaction",
                    compacted_from=[provenance_row(w) for w in wins])
                header, payload = encode_window(sw)
                writer.append_window_frame(header, payload, sw.slice_keys,
                                           sw.end_ts or None)
                stats["super_windows"] += 1
                stats["source_windows"] += len(wins)
                stats["levels"][tgt] = stats["levels"].get(tgt, 0) + 1
                _tm_compacted.labels(level=str(tgt)).inc(len(wins))
                folded.update(w.digest for w in wins if w.digest)
            # durability barrier: the super-window frames (and their
            # index row) must survive a crash BEFORE any source vanishes
            writer.sync()
            writer.rotate()
            if self._before_gc is not None:
                self._before_gc()
            # a segment is deletable only when EVERY window it holds is
            # now covered: previously covered, or folded into a durable
            # super-window this pass (a skipped bucket keeps its
            # sources' segments whole)
            deletable = [
                name for name, to_merge in candidates
                if all(h.get("digest") in folded for h, _p in to_merge)]
            deleted, freed = writer.remove_segments(deletable)
            stats["segments_deleted"] = deleted
            stats["bytes_reclaimed"] = freed
            _tm_reclaimed.inc(freed)
            _tm_compactions.inc()
            log.info("compacted %s: %d window(s) -> %d super-window(s), "
                     "%d segment(s) GC'd, %d bytes reclaimed",
                     stats["store"], stats["source_windows"],
                     stats["super_windows"], deleted, freed)
            return stats

    def compact_all(self, base_dir: str | None = None) -> list[dict]:
        """One pass over every store under the base area."""
        out = []
        for store_dir in self.store.store_dirs(base_dir):
            try:
                out.append(self.compact_store(store_dir))
            except (OSError, ValueError) as e:  # per-store isolation
                log.warning("compaction pass failed for %s: %r",
                            store_dir, e)
                out.append({"store": os.path.basename(store_dir),
                            "error": str(e)})
        return out

    def maybe_compact(self, store_dir: str,
                      min_interval: float = 30.0) -> dict | None:
        """Seal-path hook: run a pass at most every min_interval
        (wall-gated on monotonic time — the aging clock may be a
        replay/sim clock and must not gate pass cadence)."""
        key = os.path.abspath(store_dir)
        now = time.monotonic()
        with self._mu:
            last = self._last_pass.get(key, -math.inf)
            if now - last < min_interval:
                return None
            self._last_pass[key] = now
        return self.compact_store(store_dir)

    # -- background loop ----------------------------------------------------

    def start_background(self, interval: float = 60.0,
                         base_dir: str | None = None) -> None:
        """Agent-side background compactor; idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                self.compact_all(base_dir)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="ig-history-compactor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None


__all__ = ["CompactionEngine", "DEFAULT_SCHEDULE", "ScheduleLevel",
           "parse_schedule", "validate_schedule"]
