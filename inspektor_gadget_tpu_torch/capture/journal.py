"""Segmented on-disk event journal — the durable record half of the
capture/replay plane.

The reference keeps per-container overwritable syscall rings (traceloop)
so an incident can be inspected after the fact; this journal is the
framework-native durable analogue: typed wire records (the same EV_*
types the agent streams — batches, summaries, alerts, marks) framed into
append-only segment files that a crash can tear only at the very tail.

Layout of one journal directory:

    <journal>/
      manifest.json        # provenance: who/what/where recorded this
      index.jsonl          # one line per SEALED segment (seq/ts ranges)
      seg-00000001.igj     # frames; the highest-numbered file is active
      seg-00000002.igj

Frame format (all little-endian):

    u32 length  | u32 crc32(zpayload) | zpayload
    zpayload = zlib.compress(wire.encode_msg(header, payload))
    header carries at least {"type": EV_*, "seq": n, "ts": epoch-seconds}

Each frame is written with ONE O_APPEND write (utils/journal.py
append_bytes — short writes completed or raised), so concurrent writers
cannot interleave and a crash mid-write leaves exactly one torn frame at
the segment tail. Readers drop the torn tail and account the loss (the
perf-ledger stance applied to binary records): a truncated length
prefix, a frame shorter than its length, a CRC mismatch, or an
undecompressable payload all end that segment's read — everything before
is good, everything after is counted as dropped bytes.

Rotation seals the active segment (its seq/ts range goes into
index.jsonl) when it exceeds max_segment_bytes or max_segment_age;
retention GC then deletes the oldest sealed segments beyond
retention_bytes/retention_segments. The active segment is never GC'd.

The port's copy of ``inspektor_gadget_tpu/capture/journal.py``: the same
bytes on disk, so either package reads, appends to and recovers the
other's journals. The manifest's ``platform`` is the process's acquired
platform (`utils.platform_probe.last_acquire()`), as the reference takes
it; where the process never probed, the torch device type of the run
that opened the writer (``cuda`` or ``cpu``), else ``unprobed``. It is
never degraded: a run that asks for the card and finds none raises
instead.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import threading
import time
import zlib
from typing import Any, Callable, Iterator

from ..agent import wire
from ..telemetry import counter, gauge
from ..utils.journal import append_bytes, append_line, read_json_file, read_jsonl

JOURNAL_SCHEMA = "ig-tpu/capture-journal/v1"
MANIFEST = "manifest.json"
INDEX = "index.jsonl"
SEG_PREFIX = "seg-"
SEG_SUFFIX = ".igj"
FRAME_HEADER = 8  # u32 length + u32 crc32

DEFAULT_SEGMENT_BYTES = 4 << 20
DEFAULT_SEGMENT_AGE = 60.0
DEFAULT_RETENTION_BYTES = 256 << 20
DEFAULT_RETENTION_SEGMENTS = 0  # 0 = unlimited count (bytes still bound)

@dataclasses.dataclass(frozen=True)
class JournalMetrics:
    """The counter family one journal plane accounts into. The capture
    plane owns ig_capture_*; the sketch-history store (history/store.py)
    reuses the whole writer/reader machinery but must not launder its
    window traffic through capture's counters, so it passes its own."""
    records: Any    # counter("...", labels=("type",))
    bytes: Any      # counter
    drops: Any      # counter("...", labels=("reason",))
    gc: Any         # counter
    active: Any     # gauge


CAPTURE_METRICS = JournalMetrics(
    records=counter("ig_capture_records_total",
                    "records appended to capture journals", ("type",)),
    bytes=counter("ig_capture_bytes_total",
                  "bytes appended to capture journals"),
    drops=counter("ig_capture_drops_total",
                  "capture records lost (torn tails on reopen, failed "
                  "appends)", ("reason",)),
    gc=counter("ig_capture_gc_total",
               "sealed segments deleted by retention GC"),
    active=gauge("ig_capture_active_journals", "open journal writers"),
)

def capture_base_dir(path: str | None = None) -> str:
    """The node-wide default recording area: $IG_CAPTURE_DIR, else
    ~/.ig-tpu/capture (agents override with --capture-dir)."""
    return (path or os.environ.get("IG_CAPTURE_DIR")
            or os.path.join(os.path.expanduser("~"), ".ig-tpu", "capture"))


def is_journal(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST))


def _seg_name(n: int) -> str:
    return f"{SEG_PREFIX}{n:08d}{SEG_SUFFIX}"


def _seg_number(name: str) -> int:
    return int(os.path.basename(name)[len(SEG_PREFIX):-len(SEG_SUFFIX)])


def _list_segments(path: str) -> list[str]:
    return sorted(glob.glob(os.path.join(path, f"{SEG_PREFIX}*{SEG_SUFFIX}")),
                  key=_seg_number)


def build_manifest(*, journal_id: str = "", node: str = "", gadget: str = "",
                   run_id: str = "", params: dict[str, str] | None = None,
                   platform: str = "unprobed", extra: dict | None = None) -> dict:
    """Provenance block every journal carries: git sha, node id, gadget
    id, resolved params, and the platform the process acquired (or, where
    it never probed, `platform`: the torch device type the run's state
    lives on) — a journal read months later still answers 'what produced
    this' without trusting surrounding prose."""
    from ..perf.provenance import git_provenance, host_fingerprint
    from ..utils.platform_probe import last_acquire
    acq = last_acquire()
    if acq is not None and acq["ok"]:
        platform = acq["platform"]
    sha, dirty = git_provenance()
    return {
        "schema": JOURNAL_SCHEMA,
        "journal_id": journal_id,
        "node": node,
        "gadget": gadget,
        "run_id": run_id,
        "created_ts": time.time(),
        "git_sha": sha,
        "git_dirty": dirty,
        "host": host_fingerprint(),
        "platform": platform,
        "degraded": False,
        "params": dict(params or {}),
        **(extra or {}),
    }


@dataclasses.dataclass
class SegmentLoss:
    """Loss accounting for one segment's torn tail."""
    segment: str
    offset: int          # byte offset the read stopped at
    dropped_bytes: int
    reason: str


class JournalWriter:
    """Appender for one journal directory. Thread-safe: rotation and the
    frame write happen under one lock (the O_APPEND write itself is
    atomic, but seq assignment and size accounting are not)."""

    def __init__(self, path: str, *,
                 manifest: dict | None = None,
                 max_segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 max_segment_age: float = DEFAULT_SEGMENT_AGE,
                 retention_bytes: int = DEFAULT_RETENTION_BYTES,
                 retention_segments: int = DEFAULT_RETENTION_SEGMENTS,
                 clock: Callable[[], float] = time.time,
                 metrics: JournalMetrics = CAPTURE_METRICS):
        self.path = path
        self._m = metrics
        self.max_segment_bytes = max(int(max_segment_bytes), 1 << 12)
        self.max_segment_age = float(max_segment_age)
        self.retention_bytes = int(retention_bytes)
        self.retention_segments = int(retention_segments)
        self._clock = clock
        self._mu = threading.Lock()
        self._closed = False
        os.makedirs(path, exist_ok=True)
        mpath = os.path.join(path, MANIFEST)
        if os.path.exists(mpath):
            # reopening an existing journal (crash recovery / resumed
            # recording): continue after the last good record, and account
            # the torn tail the previous writer may have left
            doc, err = read_json_file(mpath)
            self.manifest = doc or build_manifest()
            if err:
                self._m.drops.labels(reason="manifest").inc()
            self._recover()
        else:
            self.manifest = manifest or build_manifest()
            tmp = f"{mpath}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.manifest, f, sort_keys=True)
            os.replace(tmp, mpath)
            self._seg_n = 1
            self._seg_bytes = 0
            self._seg_records = 0
            self._seg_opened = self._clock()
            self._seg_first_seq = None
            self._seg_first_ts = None
            self._seq = 0
            self._last_ts = 0.0
        self._m.active.inc()

    # -- recovery -----------------------------------------------------------

    def _recover(self) -> None:
        segs = _list_segments(self.path)
        self._seq = 0
        self._last_ts = 0.0
        sealed: set[str] = set()
        ipath = os.path.join(self.path, INDEX)
        idx = read_jsonl(ipath, on_bad="stop")
        if idx.skipped:
            # a crash mid-seal tore an index line; repair NOW (atomic
            # rewrite of the good rows) — otherwise every seal row this
            # writer appends lands after the tear and stays invisible to
            # on_bad="stop" readers forever
            tmp = f"{ipath}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                for row in idx.records:
                    f.write(json.dumps(row, sort_keys=True,
                                       separators=(",", ":")) + "\n")
            os.replace(tmp, ipath)
            self._m.drops.labels(reason="index").inc()
        for line in idx.records:
            self._seq = max(self._seq, int(line.get("last_seq", 0)))
            self._last_ts = max(self._last_ts,
                                float(line.get("last_ts") or 0.0))
            sealed.add(str(line.get("file", "")))
        tail = segs[-1] if segs else None
        if tail is not None and os.path.basename(tail) not in sealed:
            # an UNSEALED tail (crash mid-segment): resume it after
            # dropping any torn frame on disk, so the next append starts
            # on a clean boundary instead of extending junk
            records, loss = scan_segment(tail)
            if loss is not None:
                with open(tail, "r+b") as f:
                    f.truncate(loss.offset)
                self._m.drops.labels(reason="torn_tail").inc()
            self._seg_n = _seg_number(tail)
            self._seg_bytes = os.path.getsize(tail)
            self._seg_records = len(records)
            if records:
                self._seq = max(self._seq,
                                int(records[-1][0].get("seq", 0)))
                self._last_ts = max(self._last_ts,
                                    float(records[-1][0].get("ts", 0.0)))
            self._seg_first_seq = (int(records[0][0].get("seq", 0))
                                   if records else None)
            self._seg_first_ts = (float(records[0][0].get("ts", 0.0))
                                  if records else None)
        else:
            # fresh journal, or the tail is already SEALED (clean close,
            # or crash between seal and next append): appending into a
            # sealed file would silently invalidate its index row, so
            # start the next segment instead
            self._seg_n = _seg_number(tail) + 1 if tail is not None else 1
            self._seg_bytes = 0
            self._seg_records = 0
            self._seg_first_seq = None
            self._seg_first_ts = None
        self._seg_opened = self._clock()

    # -- append -------------------------------------------------------------

    def append(self, ev_type: int, header: dict | None = None,
               payload: bytes = b"", ts: float | None = None) -> int:
        """Frame + append one typed record; returns its seq. One
        O_APPEND write; never partially applied from the reader's view
        (a torn write is dropped at read time, not half-decoded)."""
        with self._mu:
            if self._closed:
                raise ValueError(f"journal {self.path} is closed")
            self._maybe_rotate_locked()
            self._seq += 1
            seq = self._seq
            now = self._clock() if ts is None else float(ts)
            h = {**(header or {}), "type": ev_type, "seq": seq, "ts": now}
            zpayload = zlib.compress(wire.encode_msg(h, payload), 1)
            frame = (len(zpayload).to_bytes(4, "little")
                     + (zlib.crc32(zpayload) & 0xFFFFFFFF).to_bytes(4, "little")
                     + zpayload)
            try:
                append_bytes(self._active_path(), frame)
            except OSError:
                self._seq -= 1
                self._m.drops.labels(reason="append").inc()
                raise
            if self._seg_first_seq is None:
                self._seg_first_seq = seq
                self._seg_first_ts = now
            self._seg_bytes += len(frame)
            self._seg_records += 1
            self._last_ts = now
            self._m.records.labels(type=str(ev_type)).inc()
            self._m.bytes.inc(len(frame))
            return seq

    def mark(self, mark: str, **fields) -> int:
        """Append an EV_JOURNAL_MARK lifecycle record (recording
        start/stop, rotation causes, replay anchors)."""
        return self.append(wire.EV_JOURNAL_MARK, {"mark": mark, **fields})

    def _active_path(self) -> str:
        return os.path.join(self.path, _seg_name(self._seg_n))

    # -- rotation + retention ----------------------------------------------

    def _maybe_rotate_locked(self) -> None:
        if self._seg_records == 0:
            self._seg_opened = self._clock()
            return
        aged = (self.max_segment_age > 0
                and self._clock() - self._seg_opened >= self.max_segment_age)
        if self._seg_bytes < self.max_segment_bytes and not aged:
            return
        self._seal_locked()
        self._gc_locked()

    def _index_extra_locked(self) -> dict:
        """Subclass hook: extra fields merged into the seal row of the
        segment being sealed (the history store adds the subpopulation
        keys its windows carry, so range queries can skip whole segments
        by slice key). Called under _mu; must also reset any per-segment
        accumulation it maintains."""
        return {}

    def _seal_locked(self) -> None:
        append_line(os.path.join(self.path, INDEX), {
            "file": _seg_name(self._seg_n),
            "records": self._seg_records,
            "bytes": self._seg_bytes,
            "first_seq": self._seg_first_seq,
            "last_seq": self._seq,
            "first_ts": self._seg_first_ts,
            "last_ts": self._last_ts,
            "sealed_ts": self._clock(),
            **self._index_extra_locked(),
        })
        self._seg_n += 1
        self._seg_bytes = 0
        self._seg_records = 0
        self._seg_opened = self._clock()
        self._seg_first_seq = None
        self._seg_first_ts = None

    def _gc_locked(self) -> None:
        """Delete the oldest sealed segments beyond the retention bounds.
        The active segment and the index rows of surviving segments are
        untouched; GC'd rows stay in the index flagged nowhere — readers
        treat a missing sealed file as GC'd history, not corruption."""
        sealed = []
        total = self._seg_bytes
        for s in _list_segments(self.path):
            if _seg_number(s) >= self._seg_n:
                continue
            try:
                # a compaction/archive pass (history stores share this
                # writer machinery) may GC a sealed segment between the
                # listing and the stat — treat it as already gone
                total += os.path.getsize(s)
            except OSError:
                continue
            sealed.append(s)
        removed = 0
        for s in sealed:
            over_bytes = (self.retention_bytes > 0
                          and total > self.retention_bytes)
            over_count = (self.retention_segments > 0
                          and len(sealed) - removed > self.retention_segments)
            if not over_bytes and not over_count:
                break
            try:
                size = os.path.getsize(s)
                os.remove(s)
            except OSError:
                break  # a racing reader on a shared FS: stop, retry next GC
            total -= size
            removed += 1
            self._m.gc.inc()

    # -- lifecycle ----------------------------------------------------------

    def rotate(self) -> None:
        """Force-seal the active segment (tests; recording stop)."""
        with self._mu:
            if self._seg_records:
                self._seal_locked()
                self._gc_locked()

    def stats(self) -> dict:
        with self._mu:
            return {
                "path": self.path,
                "next_seq": self._seq,
                "active_segment": _seg_name(self._seg_n),
                "active_bytes": self._seg_bytes,
                "active_records": self._seg_records,
                "segments": len(_list_segments(self.path)),
            }

    def close(self) -> dict:
        """Seal the tail, finalize the manifest (closed_ts + totals);
        idempotent. Returns the final stats."""
        with self._mu:
            if self._closed:
                return {"path": self.path, "closed": True}
            if self._seg_records:
                self._seal_locked()
            self._closed = True
        self._m.active.dec()
        mpath = os.path.join(self.path, MANIFEST)
        doc, _err = read_json_file(mpath)
        doc = doc or dict(self.manifest)
        doc["closed_ts"] = self._clock()
        doc["last_seq"] = self._seq
        tmp = f"{mpath}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, sort_keys=True)
            os.replace(tmp, mpath)
        except OSError:
            self._m.drops.labels(reason="manifest").inc()
        return {"path": self.path, "records": self._seq,
                "segments": len(_list_segments(self.path))}


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _frame_at(data: bytes, off: int) -> tuple[int, bytes, str]:
    """(end, zpayload, reason) for the frame starting at `off` — the ONE
    owner of the frame layout every reader (scan, digest, stats) walks
    with; a non-empty reason marks the torn tail."""
    n = len(data)
    if n - off < FRAME_HEADER:
        return 0, b"", "truncated frame header"
    length = int.from_bytes(data[off:off + 4], "little")
    crc = int.from_bytes(data[off + 4:off + 8], "little")
    end = off + FRAME_HEADER + length
    if length == 0 or end > n:
        return 0, b"", (f"frame shorter than its length prefix "
                        f"({length} bytes)")
    zpayload = data[off + FRAME_HEADER:end]
    if (zlib.crc32(zpayload) & 0xFFFFFFFF) != crc:
        return 0, b"", "crc mismatch"
    return end, zpayload, ""


def _decode_frame(zpayload: bytes) -> tuple[dict, bytes] | None:
    try:
        return wire.decode_msg(zlib.decompress(zpayload))
    except (zlib.error, ValueError, KeyError, json.JSONDecodeError):
        return None


def scan_segment(path: str) -> tuple[list[tuple[dict, bytes]],
                                     SegmentLoss | None]:
    """Decode every whole frame of one segment file. Returns (records,
    loss): records are (header, payload) pairs; loss is the torn tail
    (None when the file ends exactly on a frame boundary)."""
    records: list[tuple[dict, bytes]] = []
    try:
        data = open(path, "rb").read()
    except OSError as e:
        return records, SegmentLoss(os.path.basename(path), 0, 0,
                                    f"unreadable: {e.strerror or e}")
    off = 0
    n = len(data)
    while off < n:
        end, zpayload, reason = _frame_at(data, off)
        if reason:
            return records, SegmentLoss(
                os.path.basename(path), off, n - off, reason)
        decoded = _decode_frame(zpayload)
        if decoded is None:
            return records, SegmentLoss(
                os.path.basename(path), off, n - off, "undecodable frame")
        records.append(decoded)
        off = end
    return records, None


class JournalReader:
    """Range-capable reader over one journal directory. The index lets
    seq/time range reads skip whole sealed segments; the (possibly torn)
    active segment is always scanned directly."""

    def __init__(self, path: str, *,
                 metrics: JournalMetrics = CAPTURE_METRICS):
        if not is_journal(path):
            raise FileNotFoundError(f"{path}: not a capture journal "
                                    f"(no {MANIFEST})")
        self.path = path
        self._m = metrics
        doc, err = read_json_file(os.path.join(path, MANIFEST))
        self.manifest: dict = doc or {}
        self.manifest_error = err
        idx = read_jsonl(os.path.join(path, INDEX), on_bad="stop")
        self.index = idx.records
        self.index_skipped = idx.skipped
        self.losses: list[SegmentLoss] = []
        self.missing_segments: list[str] = []   # GC'd sealed history

    def _segment_files(self) -> list[str]:
        return _list_segments(self.path)

    def _index_row(self, name: str) -> dict | None:
        for row in self.index:
            if row.get("file") == name:
                return row
        return None

    def records(self, *, start_seq: int | None = None,
                end_seq: int | None = None,
                start_ts: float | None = None,
                end_ts: float | None = None,
                types: tuple[int, ...] | None = None
                ) -> Iterator[tuple[dict, bytes]]:
        """Yield (header, payload) in seq order, restricted to the given
        seq/ts range and record types. Loss accounting accumulates in
        self.losses as segments are scanned."""
        self.losses = []
        self.missing_segments = []
        present = {os.path.basename(p) for p in self._segment_files()}
        for row in self.index:
            if row.get("file") not in present:
                self.missing_segments.append(row.get("file", "?"))
        for seg in self._segment_files():
            row = self._index_row(os.path.basename(seg))
            if row is not None:
                # sealed segment: the index bounds let range reads skip it
                if start_seq is not None and row.get("last_seq") is not None \
                        and row["last_seq"] < start_seq:
                    continue
                if end_seq is not None and row.get("first_seq") is not None \
                        and row["first_seq"] > end_seq:
                    continue
                if start_ts is not None and row.get("last_ts") is not None \
                        and row["last_ts"] < start_ts:
                    continue
                if end_ts is not None and row.get("first_ts") is not None \
                        and row["first_ts"] > end_ts:
                    continue
            records, loss = scan_segment(seg)
            if loss is not None:
                self.losses.append(loss)
                self._m.drops.labels(reason="torn_tail").inc()
            for header, payload in records:
                seq = header.get("seq", 0)
                ts = header.get("ts", 0.0)
                if start_seq is not None and seq < start_seq:
                    continue
                if end_seq is not None and seq > end_seq:
                    continue
                if start_ts is not None and ts < start_ts:
                    continue
                if end_ts is not None and ts > end_ts:
                    continue
                if types is not None and header.get("type") not in types:
                    continue
                yield header, payload

    def stats(self) -> dict:
        """One inspection pass over every segment: counts by type,
        seq/ts bounds, losses, AND the content digest — computed in the
        same walk, so inspecting a multi-GiB bundle reads each segment
        exactly once."""
        by_type: dict[str, int] = {}
        first_seq = last_seq = None
        first_ts = last_ts = None
        total = 0
        losses: list[SegmentLoss] = []
        h = hashlib.sha256()
        for seg in self._segment_files():
            try:
                data = open(seg, "rb").read()
            except OSError as e:
                losses.append(SegmentLoss(os.path.basename(seg), 0, 0,
                                          f"unreadable: {e.strerror or e}"))
                continue
            off = 0
            while off < len(data):
                end, zpayload, reason = _frame_at(data, off)
                decoded = None if reason else _decode_frame(zpayload)
                if reason or decoded is None:
                    losses.append(SegmentLoss(
                        os.path.basename(seg), off, len(data) - off,
                        reason or "undecodable frame"))
                    break
                h.update(data[off:off + FRAME_HEADER])
                header, _payload = decoded
                total += 1
                t = str(header.get("type", 0))
                by_type[t] = by_type.get(t, 0) + 1
                seq = header.get("seq", 0)
                ts = header.get("ts", 0.0)
                first_seq = seq if first_seq is None else min(first_seq, seq)
                last_seq = seq if last_seq is None else max(last_seq, seq)
                first_ts = ts if first_ts is None else min(first_ts, ts)
                last_ts = ts if last_ts is None else max(last_ts, ts)
                off = end
        self.losses = losses
        present = {os.path.basename(p) for p in self._segment_files()}
        self.missing_segments = [row.get("file", "?") for row in self.index
                                 if row.get("file") not in present]
        return {
            "path": self.path,
            "records": total,
            "by_type": by_type,
            "first_seq": first_seq, "last_seq": last_seq,
            "first_ts": first_ts, "last_ts": last_ts,
            "segments": len(present),
            "gc_missing_segments": list(self.missing_segments),
            "losses": [dataclasses.asdict(loss) for loss in losses],
            "digest": h.hexdigest(),
        }

    def digest(self) -> str:
        """Content digest of every surviving frame (in order), cheap and
        stable: sha256 over each frame's (length, crc) header. Identifies
        replay inputs in PerfRecord provenance and verifies a fetched
        bundle matches the node's journal. Walks frames through the same
        _frame_at the decoder uses — a layout change cannot silently
        diverge the digest from what decodes."""
        h = hashlib.sha256()
        for seg in self._segment_files():
            try:
                data = open(seg, "rb").read()
            except OSError:
                continue
            off = 0
            while off < len(data):
                end, zpayload, reason = _frame_at(data, off)
                if reason or _decode_frame(zpayload) is None:
                    break  # same stop rule as scan_segment/stats
                h.update(data[off:off + FRAME_HEADER])
                off = end
        return h.hexdigest()


def dir_stats(path: str) -> tuple[int, int]:
    """(segment files, total bytes of ALL files) under a capture tree —
    the one helper the doctor row and top/recordings share, keyed off
    this module's format constants so a layout change can't silently
    zero their reports."""
    segments = 0
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                continue
            if f.startswith(SEG_PREFIX) and f.endswith(SEG_SUFFIX):
                segments += 1
    return segments, total


def summary_digest(summary: dict) -> str:
    """Canonical digest of one harvested summary — the unit the replay
    determinism contract is asserted over. Excludes `names` (label
    sampling resolves through the live gadget's vocab, which a replay
    does not have) and `anomaly` model scores' dict ordering is
    canonicalized by sort_keys."""
    doc = {
        "events": int(summary.get("events", 0)),
        "drops": int(summary.get("drops", 0)),
        "distinct": float(summary.get("distinct", 0.0)),
        "entropy": float(summary.get("entropy",
                                     summary.get("entropy_bits", 0.0))),
        "epoch": int(summary.get("epoch", 0)),
        "heavy_hitters": [[int(k), int(c)]
                          for k, c in (summary.get("heavy_hitters") or [])],
    }
    anomaly = summary.get("anomaly")
    if anomaly:
        doc["anomaly"] = {str(k): float(v) for k, v in anomaly.items()}
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def summary_to_dict(summary: Any) -> dict:
    """SketchSummary (or its wire dict) → the canonical journal/digest
    dict shape (the wire decode_summary shape)."""
    if isinstance(summary, dict):
        return summary
    return {
        "events": summary.events,
        "drops": summary.drops,
        "distinct": summary.distinct,
        "entropy": summary.entropy_bits,
        "epoch": summary.epoch,
        "anomaly": summary.anomaly,
        "names": {str(k): v for k, v in (summary.names or {}).items()},
        "heavy_hitters": [(int(k), int(c)) for k, c in summary.heavy_hitters],
    }


__all__ = ["CAPTURE_METRICS", "DEFAULT_RETENTION_BYTES",
           "DEFAULT_SEGMENT_AGE", "DEFAULT_SEGMENT_BYTES", "INDEX",
           "JOURNAL_SCHEMA", "JournalMetrics", "JournalReader",
           "JournalWriter", "MANIFEST", "SegmentLoss", "build_manifest",
           "capture_base_dir", "dir_stats", "is_journal", "scan_segment",
           "summary_digest", "summary_to_dict"]
