"""Standing-query registration grammar.

A standing query is a CONTINUOUS question — "top-k over the last 15
minutes", "cardinality of tenant X over the last hour" — registered
once and answered incrementally at every seal tick instead of re-folded
per request. The grammar deliberately reuses the vocabulary the rest of
the plane already speaks: statistics are `answer_query`'s blocks
(top-k / cardinality / entropy / heavy-flow decode / quantiles), slice
keys are the history plane's (``mntns:<ns>``, ``kind:<k>``, crossed),
and validation is the alert-rule discipline (alerts/rules.py): every
misconfig raises a typed QueryError at LOAD time, before the first seal
tick, never mid-stream.

A query document is JSON (or YAML when pyyaml is present): a list of
query objects, or ``{"queries": [...]}``::

    [{"id": "hot-tenants", "stats": ["topk", "cardinality"],
      "range": "15m", "top": 10},
     {"id": "tail-latency", "stats": ["quantiles"], "range": "1h",
      "every": 6}]

The port's copy of ``inspektor_gadget_tpu/queries/spec.py`` (numpy only).
"""

from __future__ import annotations

import dataclasses
import json
import re

from ..params.validators import parse_duration

QUERY_SCHEMA = "ig-tpu/standing-query/v1"

# the statistic vocabulary IS answer_query's block list: each name maps
# to one block of the materialized answer (history/query.py renders all
# of them from the same merged window, so `stats` selects what the
# consumer asked to watch, not what gets folded)
STATISTICS = ("topk", "cardinality", "entropy", "heavy_flows",
              "quantiles")

_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")

TOP_MAX = 1024


class QueryError(ValueError):
    """A standing-query document failed validation (load-time, loud)."""


@dataclasses.dataclass(frozen=True)
class StandingQuery:
    """One validated continuous query."""

    id: str
    stats: tuple[str, ...]         # subset of STATISTICS, order kept
    range_s: float                 # sliding window length (seconds)
    key: str = ""                  # optional subpopulation slice
    top: int = 10                  # heavy hitters / flows to materialize
    every: int = 1                 # publish every N seal ticks

    def identity(self) -> str:
        """Canonical spec identity — half of the result-cache key (the
        other half is the covered digest set)."""
        return json.dumps({
            "schema": QUERY_SCHEMA, "id": self.id,
            "stats": list(self.stats), "range_s": self.range_s,
            "key": self.key, "top": self.top, "every": self.every,
        }, sort_keys=True, separators=(",", ":"))

    def describe(self) -> str:
        rng = (f"{self.range_s:g}s" if self.range_s < 120
               else f"{self.range_s / 60:g}m")
        parts = [f"{'/'.join(self.stats)} over last {rng}"]
        if self.key:
            parts.append(f"slice {self.key}")
        if self.every > 1:
            parts.append(f"every {self.every} seals")
        return f"{self.id}: " + ", ".join(parts)


_KNOWN_KEYS = frozenset({"id", "stats", "range", "key", "top", "every"})


def _parse_query(raw: object, idx: int, *, default_every: int = 1,
                 max_range_s: float | None = None) -> StandingQuery:
    if not isinstance(raw, dict):
        raise QueryError(f"query #{idx}: expected an object, got "
                         f"{type(raw).__name__}")
    qid = raw.get("id")
    if not isinstance(qid, str) or not _ID_RE.match(qid):
        raise QueryError(f"query #{idx}: id must match "
                         f"{_ID_RE.pattern!r}, got {qid!r}")
    unknown = sorted(set(raw) - _KNOWN_KEYS)
    if unknown:
        raise QueryError(f"query {qid!r}: unknown key(s) {unknown} "
                         f"(expected {sorted(_KNOWN_KEYS)})")
    stats = raw.get("stats")
    if not isinstance(stats, list) or not stats:
        raise QueryError(f"query {qid!r}: stats must be a non-empty "
                         f"list from {STATISTICS}")
    seen: list[str] = []
    for s in stats:
        if s not in STATISTICS:
            raise QueryError(f"query {qid!r}: unknown statistic {s!r} "
                             f"(one of {STATISTICS})")
        if s in seen:
            raise QueryError(f"query {qid!r}: duplicate statistic {s!r}")
        seen.append(s)
    rng = raw.get("range")
    if rng is None:
        raise QueryError(f"query {qid!r}: missing 'range' (the sliding "
                         "window length, e.g. \"15m\")")
    if isinstance(rng, bool) or not isinstance(rng, (int, float, str)):
        raise QueryError(f"query {qid!r}: range must be seconds or a "
                         f"duration string, got {rng!r}")
    try:
        range_s = (float(rng) if isinstance(rng, (int, float))
                   else parse_duration(rng))
    except ValueError as e:
        raise QueryError(f"query {qid!r}: bad range {rng!r}: {e}") from None
    if range_s <= 0:
        raise QueryError(f"query {qid!r}: range must be > 0 seconds, "
                         f"got {range_s!r}")
    if max_range_s is not None and range_s > max_range_s:
        raise QueryError(f"query {qid!r}: range {range_s:g}s exceeds the "
                         f"configured cap of {max_range_s:g}s "
                         "(query-max-range)")
    key = raw.get("key", "")
    if not isinstance(key, str):
        raise QueryError(f"query {qid!r}: key must be a string slice "
                         f"like 'mntns:4026531840', got {key!r}")
    top = raw.get("top", 10)
    if isinstance(top, bool) or not isinstance(top, int) \
            or not 1 <= top <= TOP_MAX:
        raise QueryError(f"query {qid!r}: top must be an int in "
                         f"[1, {TOP_MAX}], got {top!r}")
    every = raw.get("every", default_every)
    if isinstance(every, bool) or not isinstance(every, int) or every < 1:
        raise QueryError(f"query {qid!r}: every must be an int >= 1 "
                         f"(publish cadence in seal ticks), got {every!r}")
    return StandingQuery(id=qid, stats=tuple(seen), range_s=range_s,
                         key=key, top=top, every=every)


def _parse_doc(text: str, source: str) -> object:
    text = text.strip()
    if not text:
        raise QueryError(f"{source}: empty query document")
    try:
        import yaml
        try:
            return yaml.safe_load(text)
        except yaml.YAMLError as e:
            raise QueryError(f"{source}: unparseable YAML/JSON: "
                             f"{e}") from None
    except ImportError:
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise QueryError(f"{source}: unparseable JSON (pyyaml not "
                             f"installed): {e}") from None


def load_queries(text: str, source: str = "<queries>", *,
                 default_every: int = 1,
                 max_range_s: float | None = None) -> list[StandingQuery]:
    """Parse + validate a query document; raises QueryError on anything
    off (the rules.py load-time discipline)."""
    doc = _parse_doc(text, source)
    if isinstance(doc, dict):
        extra = sorted(set(doc) - {"queries"})
        if extra:
            raise QueryError(f"{source}: unknown top-level key(s) {extra} "
                             "(expected 'queries')")
        doc = doc.get("queries")
    if doc is None or doc == []:
        raise QueryError(f"{source}: no queries defined")
    if not isinstance(doc, list):
        raise QueryError(f"{source}: expected a list of queries, got "
                         f"{type(doc).__name__}")
    queries = [_parse_query(q, i, default_every=default_every,
                            max_range_s=max_range_s)
               for i, q in enumerate(doc)]
    seen: dict[str, int] = {}
    for i, q in enumerate(queries):
        if q.id in seen:
            raise QueryError(f"{source}: duplicate query id {q.id!r} "
                             f"(queries #{seen[q.id]} and #{i})")
        seen[q.id] = i
    return queries


def load_queries_file(path: str, **kw) -> list[StandingQuery]:
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        raise QueryError(f"cannot read query file {path!r}: {e}") from None
    return load_queries(text, source=path, **kw)


__all__ = ["QUERY_SCHEMA", "STATISTICS", "TOP_MAX", "QueryError",
           "StandingQuery", "load_queries", "load_queries_file"]
