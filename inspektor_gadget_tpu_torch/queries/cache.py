"""Digest-keyed standing-query result cache.

Window digests are content-addressed (history/window.py:window_digest
hashes the sketch planes themselves), so cache invalidation here is
EXACT, not heuristic: an entry is keyed on the frozenset of sealed-window
digests the materialized answer covers. If a reader's coverage matches,
the bytes are exactly right — bit-identical to refolding those windows.
If coverage moved (a seal tick landed, eviction dropped the tail,
compaction rewrote the range), the key no longer matches and the entry
is provably stale; there is no TTL, no "probably fine" window.

Accounting is loud: hit / miss / invalidation counters (per query id)
plus a resident-bytes gauge, all in the process registry so `top
metrics`, doctor, and the Prometheus endpoint see the same numbers.

The port's copy of ``inspektor_gadget_tpu/queries/cache.py`` (numpy only).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..telemetry import registry as tm

_tm_hits = tm.counter(
    "ig_query_cache_hits_total",
    "standing-query result-cache hits (coverage matched exactly)",
    labels=("query",))
_tm_misses = tm.counter(
    "ig_query_cache_misses_total",
    "standing-query result-cache misses (no entry for this coverage)",
    labels=("query",))
_tm_invalidations = tm.counter(
    "ig_query_cache_invalidations_total",
    "standing-query cache entries dropped because coverage moved",
    labels=("query",))
_tm_bytes = tm.gauge(
    "ig_query_cache_bytes",
    "resident bytes across all standing-query cache entries")


class ResultCache:
    """LRU-by-bytes cache of encoded materialized answers.

    Key: (query id, frozenset of covered window digests). A put for a
    query id whose coverage differs from the cached one *replaces* the
    old entry and counts an invalidation — per query there is exactly
    one live coverage, the current one.
    """

    def __init__(self, max_bytes: int = 8 << 20):
        if max_bytes <= 0:
            raise ValueError(f"cache max_bytes must be > 0, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self._mu = threading.Lock()
        # query id -> (coverage, header, payload, nbytes); OrderedDict
        # gives LRU order (move_to_end on hit).
        self._entries: "OrderedDict[str, tuple[frozenset, dict, bytes, int]]" = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._invalidations = 0

    # -- internals (call with _mu held) -------------------------------------

    def _drop(self, qid: str, *, invalidation: bool) -> None:
        _cov, _hdr, _payload, n = self._entries.pop(qid)
        self._bytes -= n
        if invalidation:
            self._invalidations += 1
            _tm_invalidations.labels(query=qid).inc()

    # -- public --------------------------------------------------------------

    def get(self, qid: str, coverage: frozenset) -> tuple[dict, bytes] | None:
        """Return (header, payload) iff the cached entry covers exactly
        `coverage`; a coverage mismatch drops the stale entry (counted
        as an invalidation) and reads as a miss."""
        with self._mu:
            ent = self._entries.get(qid)
            if ent is not None and ent[0] == coverage:
                self._entries.move_to_end(qid)
                self._hits += 1
                _tm_hits.labels(query=qid).inc()
                return ent[1], ent[2]
            if ent is not None:  # present but provably stale
                self._drop(qid, invalidation=True)
                _tm_bytes.set(self._bytes)
            self._misses += 1
            _tm_misses.labels(query=qid).inc()
            return None

    def put(self, qid: str, coverage: frozenset, header: dict,
            payload: bytes) -> None:
        nbytes = len(payload) + 512  # header + key bookkeeping estimate
        with self._mu:
            if qid in self._entries:
                stale = self._entries[qid][0] != coverage
                self._drop(qid, invalidation=stale)
            self._entries[qid] = (coverage, dict(header), payload, nbytes)
            self._bytes += nbytes
            # LRU eviction by bytes; never evict the entry just written
            self._entries.move_to_end(qid)
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                victim = next(iter(self._entries))
                if victim == qid:
                    break
                self._drop(victim, invalidation=False)
            _tm_bytes.set(self._bytes)

    def stats(self) -> dict:
        with self._mu:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "hits": self._hits,
                "misses": self._misses,
                "invalidations": self._invalidations,
            }


__all__ = ["ResultCache"]
