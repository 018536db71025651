"""Seal-tick incremental evaluation of standing queries.

The core move: the merge algebra (history/window.py) makes a range
answer a FOLD, and folds over a sliding window need not be recomputed —
each seal tick merges ONE new window into a running materialized
answer. Because HLL registers merge by max, the monoid is not
invertible (you cannot subtract the window that just slid out), so
eviction uses the two-stack sliding-window aggregation trick: a back
list accumulating new windows left-to-right and a front stack of
suffix aggregates built when the front drains. Every push/evict is
amortized O(1) merges — refresh cost is independent of range length,
which is the whole economic argument for standing queries.

Exactness: every plane is exact integer arithmetic (CMS/entropy/
invertible/quantile adds, HLL max, candidate sums), so pairwise
association changes nothing, and merged_to_sealed orders candidates by
(-count, key) — a pure function of content. The standing answer is
therefore BYTE-IDENTICAL (same window digest) to an ad-hoc
answer_query fold over the same sealed windows, and the tests assert
exactly that. Plane refusal (a window missing the invertible/quantile
plane poisons the range) is an AND over windows — associative — so
refusal outcomes match too; only the human-readable skipped NOTES are
fold-shape-dependent, and notes are not state.

Eviction mirrors `header_overlaps`: a window leaves the fold when
`end_ts < cutoff`, exactly the predicate fetch_windows uses to exclude
it from an ad-hoc range query — standing coverage and recompute
coverage can never disagree at a boundary. Coverage only moves at seal
ticks, so a read between ticks is stale by at most one seal interval.

The port's copy of ``inspektor_gadget_tpu/queries/engine.py`` (numpy only).
"""

from __future__ import annotations

import hashlib
import threading

from ..history.query import pack_frames
from ..history.window import (SealedWindow, encode_window, merge_windows,
                              merged_to_sealed)
from ..telemetry import registry as tm
from .cache import ResultCache
from .spec import QUERY_SCHEMA, StandingQuery

_tm_folds = tm.counter(
    "ig_query_folds_total",
    "window merges performed by the standing-query plane (cache hits "
    "perform zero)")
_tm_refreshes = tm.counter(
    "ig_query_refresh_total",
    "standing-query materializations (one per query per seal tick)",
    labels=("query",))
_tm_published = tm.counter(
    "ig_query_published_total",
    "materialized answers published over the summary tier",
    labels=("query",))
_tm_windows = tm.gauge(
    "ig_query_windows",
    "sealed windows currently inside a standing query's sliding range",
    labels=("query",))


class SlidingFold:
    """Two-stack sliding-window aggregation over the window monoid.

    Entries are normalized at push (merge of one window → int64 lanes,
    window ordinal 0) so every aggregate — and the final answer — has
    the exact dtype/shape an ad-hoc fold produces. Not thread-safe;
    the owning engine serializes access.
    """

    def __init__(self, *, gadget: str, node: str):
        self.gadget = gadget
        self.node = node
        # back: arrival order, back_agg = fold(back) oldest-first
        self._back: list[tuple[dict, SealedWindow]] = []
        self._back_agg: SealedWindow | None = None
        # front: stack of (meta, win, agg-of-this-and-all-younger-front)
        # with the OLDEST entry on top (popped first)
        self._front: list[tuple[dict, SealedWindow, SealedWindow]] = []
        self.folds = 0   # merge_windows calls — the cost being amortized

    def _seal(self, wins: list[SealedWindow]) -> SealedWindow:
        self.folds += 1
        _tm_folds.inc()
        return merged_to_sealed(merge_windows(wins), gadget=self.gadget,
                                node=self.node, window=0, run_id="")

    def push(self, win: SealedWindow) -> None:
        meta = {"digest": win.digest, "window": int(win.window),
                "level": int(win.level), "start_ts": float(win.start_ts),
                "end_ts": float(win.end_ts), "events": int(win.events)}
        norm = self._seal([win])
        self._back.append((meta, norm))
        self._back_agg = (norm if self._back_agg is None
                         else self._seal([self._back_agg, norm]))

    def _flip(self) -> None:
        agg: SealedWindow | None = None
        for meta, w in reversed(self._back):
            agg = w if agg is None else self._seal([w, agg])
            self._front.append((meta, w, agg))
        self._back = []
        self._back_agg = None

    def evict_older_than(self, cutoff: float) -> int:
        """Drop windows with end_ts < cutoff — the exact complement of
        header_overlaps(start_ts=cutoff). Returns evicted count."""
        n = 0
        while True:
            if not self._front:
                if not self._back:
                    break
                self._flip()
            meta = self._front[-1][0]
            if meta["end_ts"] >= cutoff:
                break
            self._front.pop()
            n += 1
        return n

    def __len__(self) -> int:
        return len(self._front) + len(self._back)

    def metas(self) -> list[dict]:
        """Covered windows, oldest first."""
        return ([e[0] for e in reversed(self._front)]
                + [e[0] for e in self._back])

    def coverage(self) -> frozenset:
        return frozenset(m["digest"] for m in self.metas())

    def value(self) -> SealedWindow | None:
        """Materialized fold of every covered window — ≤ 1 merge on top
        of the maintained aggregates."""
        front_agg = self._front[-1][2] if self._front else None
        if front_agg is None:
            return self._back_agg
        if self._back_agg is None:
            return front_agg
        return self._seal([front_agg, self._back_agg])


class StandingQueryEngine:
    """Per-run registry of standing queries: one SlidingFold per query,
    refreshed on every seal tick, fronted by the digest-keyed cache."""

    def __init__(self, specs: list[StandingQuery], *, gadget: str,
                 node: str = "", cache_bytes: int = 8 << 20):
        self.gadget = gadget
        self.node = node
        self.specs = {q.id: q for q in specs}
        self.cache = ResultCache(max_bytes=cache_bytes)
        self._folds = {q.id: SlidingFold(gadget=gadget, node=node)
                       for q in specs}
        self._mu = threading.Lock()
        self._ticks = 0
        self._published = {q.id: 0 for q in specs}
        self._refreshed = {q.id: 0 for q in specs}

    # -- internals (call with _mu held) -------------------------------------

    def _materialize(self, q: StandingQuery,
                     fold: SlidingFold) -> tuple[dict, bytes] | None:
        norm = fold.value()
        if norm is None:
            return None
        metas = fold.metas()
        cov = hashlib.sha256(
            "\n".join(sorted(m["digest"] for m in metas)).encode()
        ).hexdigest()
        header = {
            "schema": QUERY_SCHEMA,
            "id": q.id,
            "gadget": self.gadget,
            "node": self.node,
            "stats": list(q.stats),
            "key": q.key,
            "top": int(q.top),
            "range_s": float(q.range_s),
            "windows": len(metas),
            "levels": sorted({m["level"] for m in metas}),
            "coverage_digest": cov,
            "tick": self._ticks,
            "start_ts": float(norm.start_ts),
            "end_ts": float(norm.end_ts),
            "events": int(norm.events),
            "drops": int(norm.drops),
        }
        return header, pack_frames([encode_window(norm)])

    # -- seal-tick feed ------------------------------------------------------

    def on_seal(self, win: SealedWindow,
                now: float) -> list[tuple[dict, bytes]]:
        """Fold one just-sealed window into every standing query; cache
        the refreshed answers; return the (header, payload) pairs due
        for publication this tick (per-query `every` cadence)."""
        out: list[tuple[dict, bytes]] = []
        with self._mu:
            self._ticks += 1
            for qid, q in self.specs.items():
                fold = self._folds[qid]
                fold.push(win)
                fold.evict_older_than(now - q.range_s)
                _tm_windows.labels(query=qid).set(len(fold))
                mat = self._materialize(q, fold)
                if mat is None:
                    continue
                self._refreshed[qid] += 1
                _tm_refreshes.labels(query=qid).inc()
                self.cache.put(qid, fold.coverage(), mat[0], mat[1])
                if self._ticks % q.every == 0:
                    self._published[qid] += 1
                    _tm_published.labels(query=qid).inc()
                    out.append(mat)
        return out

    # -- read path -----------------------------------------------------------

    def read(self, qid: str) -> tuple[dict, bytes, bool] | None:
        """(header, payload, from_cache) for one query, or None when the
        range is empty. The repeat-read contract: within one coverage
        (i.e. between seal ticks) the second read is a cache hit and
        performs ZERO window folds."""
        with self._mu:
            q = self.specs.get(qid)
            if q is None:
                raise KeyError(f"no standing query {qid!r} "
                               f"(registered: {sorted(self.specs)})")
            fold = self._folds[qid]
            cov = fold.coverage()
            if not cov:
                return None
            hit = self.cache.get(qid, cov)
            if hit is not None:
                return hit[0], hit[1], True
            mat = self._materialize(q, fold)
            if mat is None:
                return None
            self.cache.put(qid, cov, mat[0], mat[1])
            return mat[0], mat[1], False

    def stats(self) -> list[dict]:
        """One accounting row per query (dump_state / doctor / watch)."""
        with self._mu:
            cache = self.cache.stats()
            rows = []
            for qid, q in sorted(self.specs.items()):
                fold = self._folds[qid]
                metas = fold.metas()
                rows.append({
                    "id": qid,
                    "gadget": self.gadget,
                    "stats": list(q.stats),
                    "key": q.key,
                    "range_s": float(q.range_s),
                    "every": int(q.every),
                    "windows": len(metas),
                    "events": sum(m["events"] for m in metas),
                    "ticks": self._ticks,
                    "refreshed": self._refreshed[qid],
                    "published": self._published[qid],
                    "folds": fold.folds,
                    "cache": cache,
                })
            return rows


# -- process-wide registry ---------------------------------------------------
# run_id → engine, mirroring operators/tpusketch.py's `_live` so the
# agent's DumpState, doctor, and `ig-tpu watch --local` can read
# standing-query state without importing the operator (or jax).

_LIVE: dict[str, StandingQueryEngine] = {}
_LIVE_MU = threading.Lock()


def register(run_id: str, engine: StandingQueryEngine) -> None:
    with _LIVE_MU:
        _LIVE[run_id] = engine


def unregister(run_id: str) -> None:
    with _LIVE_MU:
        _LIVE.pop(run_id, None)


def live_engines() -> list[tuple[str, StandingQueryEngine]]:
    with _LIVE_MU:
        return sorted(_LIVE.items())


def live_stats() -> list[dict]:
    """Flat accounting rows across every live engine, run_id attached."""
    rows = []
    for run_id, eng in live_engines():
        for row in eng.stats():
            rows.append({"run_id": run_id, **row})
    return rows


__all__ = ["SlidingFold", "StandingQueryEngine", "register",
           "unregister", "live_engines", "live_stats"]
