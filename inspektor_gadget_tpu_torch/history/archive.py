"""Archive tier: cold history segments offloaded to an object store.

The compaction schedule bounds *resolution*; this tier bounds *local
disk*: fully-compacted segments (every window at the schedule's final
level) are offloaded whole to an object-store-shaped backend and
recorded in a per-store manifest (``archive.jsonl``), so retention
becomes a policy instead of a disk size ("Sketchy With a Chance of
Adoption", arxiv 2012.06001: telemetry that cannot bound its own
footprint does not survive production).

The ``ArchiveBackend`` protocol (put/get/list/delete) is the subsystem
boundary — the filesystem implementation below is what ships today; an
S3/GCS one slots in without touching the store, the query plane, or the
manifest format. Queries overlapping an archived range rehydrate the
segment through the manifest into a bounded local cache (LRU by bytes,
hit/miss counted) and verify the content digest on the way back in: a
corrupted or truncated archive object is REPORTED into the query's loss
accounting and never merged.

Manifest row (one JSON line per offloaded segment):

    {"object", "file", "bytes", "digest", "level", "windows",
     "first_seq", "last_seq", "first_ts", "last_ts", "keys",
     "archived_ts"}

The seq/ts ranges and slice-key union make the manifest a pruning
index: a query that doesn't overlap an archived range never touches
the backend.

The port's copy of ``inspektor_gadget_tpu/history/archive.py``: the
objects and manifest rows are the reference's, so either package
rehydrates the other's archive.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Callable, Iterator, Protocol

from ..telemetry import counter, gauge
from ..utils.journal import append_line, read_jsonl
from ..utils.logger import get_logger

log = get_logger("ig-tpu.history.archive")

ARCHIVE_MANIFEST = "archive.jsonl"
ARCHIVE_SCHEMA = "ig-tpu/history-archive/v1"

_tm_archived = counter(
    "ig_history_archived_segments_total",
    "cold (fully-compacted) history segments offloaded to the archive "
    "backend")
_tm_archived_bytes = counter(
    "ig_history_archive_bytes_total",
    "bytes offloaded to the archive backend")
_tm_rehydrations = counter(
    "ig_history_rehydrations_total",
    "archived-segment reads by local-cache outcome", ("result",))
_tm_archive_errors = counter(
    "ig_history_archive_errors_total",
    "archive objects refused (digest mismatch, unreadable backend, "
    "torn manifest rows)", ("reason",))
_tm_cache_bytes = gauge(
    "ig_history_archive_cache_bytes",
    "bytes currently held in the rehydration cache")


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class ArchiveBackend(Protocol):
    """Object-store shape the archive tier writes through. Names are
    ``<store>/<segment>`` keys; implementations own their own atomicity
    (put must never leave a half-object readable under the name)."""

    def put(self, name: str, data: bytes) -> None: ...
    def get(self, name: str) -> bytes: ...
    def list(self, prefix: str = "") -> list[str]: ...
    def delete(self, name: str) -> None: ...


class FilesystemArchive:
    """The shipping ArchiveBackend: objects are files under one root,
    written atomically (tmp + rename). The interface — not this class —
    is the subsystem boundary."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, name: str) -> str:
        # object names come from manifest rows a compromised agent could
        # have written: same traversal guard as every other
        # client-supplied path component
        norm = os.path.normpath(name)
        if not norm or os.path.isabs(norm) or norm.startswith(".."):
            raise ValueError(f"bad archive object name {name!r}")
        return os.path.join(self.root, norm)

    def put(self, name: str, data: bytes) -> None:
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def get(self, name: str) -> bytes:
        with open(self._path(name), "rb") as f:
            return f.read()

    def list(self, prefix: str = "") -> list[str]:
        out = []
        for root, _dirs, files in os.walk(self.root):
            for f in files:
                rel = os.path.relpath(os.path.join(root, f), self.root)
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def delete(self, name: str) -> None:
        os.remove(self._path(name))


class ArchiveTier:
    """Manifest-driven offload + rehydration for history stores."""

    def __init__(self, backend: ArchiveBackend, *, cache_dir: str,
                 cache_bytes: int = 64 << 20,
                 clock: Callable[[], float] = time.time):
        self.backend = backend
        self.cache_dir = os.path.abspath(cache_dir)
        self.cache_bytes = int(cache_bytes)
        self.clock = clock
        self._mu = threading.Lock()
        # LRU by bytes over the cache dir: path → size, oldest first
        self._lru: dict[str, int] = {}
        self._lru_loaded = False
        self.hits = 0
        self.misses = 0

    # -- offload ------------------------------------------------------------

    def archive_store(self, store_dir: str, *, min_level: int,
                      writer=None) -> dict:
        """Offload every sealed segment whose windows are ALL at
        min_level or beyond. The object is durable in the backend and
        its manifest row appended BEFORE the local segment is deleted
        (under the writer lock when one is passed) — a crash between
        the two leaves both copies, and reads prefer the local one."""
        from ..agent import wire
        from ..capture.journal import JournalReader, scan_segment
        from .store import HISTORY_METRICS
        stats = {"store": os.path.basename(store_dir), "segments": 0,
                 "bytes": 0, "windows": 0}
        reader = JournalReader(store_dir, metrics=HISTORY_METRICS)
        sealed = {str(row.get("file", "")) for row in reader.index}
        already = {row.get("file") for row in self.manifest_rows(store_dir)}
        for seg in reader._segment_files():
            name = os.path.basename(seg)
            if name not in sealed or name in already:
                continue
            records, loss = scan_segment(seg)
            if loss is not None or not records:
                continue
            if any(h.get("type") != wire.EV_WINDOW
                   or int(h.get("level", 0)) < min_level
                   for h, _p in records):
                continue
            try:
                with open(seg, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            obj = f"{os.path.basename(store_dir)}/{name}"
            keys: set[str] = set()
            for h, _p in records:
                keys.update(h.get("keys") or [])
            row = {
                "schema": ARCHIVE_SCHEMA,
                "object": obj,
                "file": name,
                "bytes": len(data),
                "digest": _digest(data),
                "level": max(int(h.get("level", 0)) for h, _p in records),
                "windows": len(records),
                "first_seq": min(int(h.get("seq", 0)) for h, _p in records),
                "last_seq": max(int(h.get("seq", 0)) for h, _p in records),
                "first_ts": min(float(h.get("start_ts", 0.0))
                                for h, _p in records),
                "last_ts": max(float(h.get("end_ts", 0.0))
                               for h, _p in records),
                "keys": sorted(keys),
                "archived_ts": self.clock(),
            }
            self.backend.put(obj, data)
            append_line(os.path.join(store_dir, ARCHIVE_MANIFEST), row)
            if writer is not None:
                writer.remove_segments([name], count_gc=False)
            else:
                try:
                    os.remove(seg)
                except OSError:
                    pass
            stats["segments"] += 1
            stats["bytes"] += len(data)
            stats["windows"] += len(records)
            _tm_archived.inc()
            _tm_archived_bytes.inc(len(data))
        if stats["segments"]:
            log.info("archived %s: %d segment(s), %d window(s), %d bytes",
                     stats["store"], stats["segments"], stats["windows"],
                     stats["bytes"])
        return stats

    # -- manifest + rehydration --------------------------------------------

    def manifest_rows(self, store_dir: str) -> list[dict]:
        path = os.path.join(store_dir, ARCHIVE_MANIFEST)
        res = read_jsonl(path, on_bad="stop")
        if res.skipped:
            # a crash/ENOSPC tore a manifest line; repair NOW (atomic
            # rewrite of the good rows — the journal index's _recover
            # discipline) so rows appended after the tear don't stay
            # invisible to on_bad="stop" readers forever. The torn
            # row's object survives in the backend under a listable
            # name; only its index line is lost, and that loss is
            # counted.
            import json
            _tm_archive_errors.labels(reason="manifest").inc()
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    for row in res.records:
                        f.write(json.dumps(row, sort_keys=True,
                                           separators=(",", ":")) + "\n")
                os.replace(tmp, path)
            except OSError as e:
                log.warning("archive manifest repair failed for %s: %r",
                            store_dir, e)
        return res.records

    def _cache_path(self, store_dir: str, name: str) -> str:
        return os.path.join(self.cache_dir,
                            os.path.basename(store_dir), name)

    def _load_lru_locked(self) -> None:
        if self._lru_loaded:
            return
        entries = []
        for root, _dirs, files in os.walk(self.cache_dir):
            for f in files:
                p = os.path.join(root, f)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, p, st.st_size))
        for _mt, p, size in sorted(entries):
            self._lru[p] = size
        self._lru_loaded = True
        _tm_cache_bytes.set(sum(self._lru.values()))

    def _touch_locked(self, path: str, size: int) -> None:
        self._lru.pop(path, None)
        self._lru[path] = size       # dict order = LRU order, newest last
        used = sum(self._lru.values())
        # evict oldest beyond the budget — never the entry just touched
        # (a single over-budget object would otherwise thrash forever)
        for old in list(self._lru):
            if used <= self.cache_bytes or old == path:
                break
            used -= self._lru.pop(old)
            try:
                os.remove(old)
            except OSError:
                pass
        _tm_cache_bytes.set(sum(self._lru.values()))

    def rehydrate(self, store_dir: str, row: dict,
                  losses: list | None = None) -> str | None:
        """One archived segment back onto local disk (cache), digest-
        verified. Returns the cached path, or None with the refusal
        accounted — a corrupted archive object is reported, never
        merged."""
        name = str(row.get("file", ""))
        cpath = self._cache_path(store_dir, name)
        with self._mu:
            self._load_lru_locked()
            if os.path.isfile(cpath):
                self.hits += 1
                _tm_rehydrations.labels(result="hit").inc()
                self._touch_locked(cpath, os.path.getsize(cpath))
                return cpath
        self.misses += 1
        _tm_rehydrations.labels(result="miss").inc()
        try:
            data = self.backend.get(str(row.get("object", "")))
        except (OSError, ValueError) as e:
            _tm_archive_errors.labels(reason="get").inc()
            if losses is not None:
                losses.append({"store": os.path.basename(store_dir),
                               "segment": name, "offset": 0,
                               "dropped_bytes": int(row.get("bytes", 0)),
                               "reason": f"archive get failed: {e}"})
            return None
        if _digest(data) != row.get("digest"):
            _tm_archive_errors.labels(reason="digest").inc()
            if losses is not None:
                losses.append({"store": os.path.basename(store_dir),
                               "segment": name, "offset": 0,
                               "dropped_bytes": len(data),
                               "reason": "archive object digest mismatch "
                                         "(corrupted; refused)"})
            return None
        os.makedirs(os.path.dirname(cpath), exist_ok=True)
        tmp = f"{cpath}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, cpath)
        with self._mu:
            self._load_lru_locked()
            self._touch_locked(cpath, len(data))
        return cpath

    def frames_for_range(self, store_dir: str, *,
                         start_ts: float | None = None,
                         end_ts: float | None = None,
                         start_seq: int | None = None,
                         end_seq: int | None = None,
                         key: str | None = None,
                         losses: list | None = None
                         ) -> Iterator[tuple[dict, bytes]]:
        """EV_WINDOW frames of archived segments overlapping the range,
        rehydrated through the manifest. Manifest ranges prune before
        any backend traffic; segments still present locally are skipped
        (the store scan already served them)."""
        from ..agent import wire
        from ..capture.journal import scan_segment
        for row in self.manifest_rows(store_dir):
            name = str(row.get("file", ""))
            if not name or os.path.isfile(os.path.join(store_dir, name)):
                continue
            if start_ts is not None and float(row.get("last_ts") or 0.0) \
                    < start_ts:
                continue
            if end_ts is not None and float(row.get("first_ts") or 0.0) \
                    > end_ts:
                continue
            if start_seq is not None and int(row.get("last_seq") or 0) \
                    < start_seq:
                continue
            if end_seq is not None and int(row.get("first_seq") or 0) \
                    > end_seq:
                continue
            if key and (row.get("keys") is not None
                        and key not in row["keys"]):
                continue
            cpath = self.rehydrate(store_dir, row, losses)
            if cpath is None:
                continue
            records, loss = scan_segment(cpath)
            if loss is not None and losses is not None:
                losses.append({"store": os.path.basename(store_dir),
                               **loss.__dict__})
            for header, payload in records:
                if header.get("type") != wire.EV_WINDOW:
                    continue
                yield header, payload

    def stats(self, store_dir: str) -> dict:
        rows = self.manifest_rows(store_dir)
        rows = [r for r in rows
                if not os.path.isfile(os.path.join(store_dir,
                                                   str(r.get("file", ""))))]
        with self._mu:
            self._load_lru_locked()
            cache_used = sum(self._lru.values())
        return {
            "segments": len(rows),
            "bytes": sum(int(r.get("bytes", 0)) for r in rows),
            "windows": sum(int(r.get("windows", 0)) for r in rows),
            "cache": {"bytes": cache_used, "budget": self.cache_bytes,
                      "hits": self.hits, "misses": self.misses},
        }


__all__ = ["ARCHIVE_MANIFEST", "ARCHIVE_SCHEMA", "ArchiveBackend",
           "ArchiveTier", "FilesystemArchive"]
