"""The aggregation-tier fold: AggregatorNode + fold_tree (the port's copy
of ``inspektor_gadget_tpu/fleet/aggregator.py``).

One rule makes the whole tier trustworthy: every tier folds child
summaries through the SAME algebra the flat client-side fold uses —
`merge_windows` (total-coverage refusal for the invertible/quantile/
shadow planes, unconditional approx-taint OR, geometry-skip with a
note) sealed by `merged_to_sealed` (canonical (-count, key) candidate
order, int64 count lanes). Because that algebra is associative and
commutative on every plane, any fold SHAPE over the same leaf windows
seals byte-identical summaries — a zone folding its four nodes and the
root folding the zones produces exactly the bytes of one flat fold over
all leaves. `flat_summary` is that anchor; order is pinned twice so
reply ARRIVAL order can never leak into the sealed bytes (the last-wins
label-map update and the merge-base choice are the two order-sensitive
spots): leaf-set folds sort by `canonical_order` (node id), and every
aggregator folds its children in TOPOLOGY order — which for the
auto-balanced tree equals canonical leaf order at every tier, making
even the digest-exempt label map identical to the flat fold's.

Failure is accounted, never fatal: an unreachable leaf becomes an
`errors` row with path ``unreachable``; an unreachable or mid-fold-
crashed aggregator trips the fallback counter and its subtree is
re-folded flat from the leaves (path ``flat-fallback``), with a
`folded`-leaf guard making double-counting structurally impossible —
each leaf's summary enters the fold exactly once per query no matter
how many re-folds the chaos causes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

from ..agent import wire
from ..history.window import (
    SealedWindow,
    merge_windows,
    merged_to_sealed,
)
from ..telemetry import counter, gauge
from .topology import Topology, TreeNode

# live-fold depth: set while a tree fold is in flight, back to 0 when it
# returns — the scrape answers "is an aggregation running, how tall"
_tm_depth = gauge("ig_fleet_merge_depth",
                  "depth of the merge tree currently being folded "
                  "(0 = no tree fold in flight)")
_tm_folds = counter("ig_fleet_subtree_folds_total",
                    "aggregator subtree folds by result (ok = sealed "
                    "and republished, failed = fold crashed and the "
                    "subtree fell back flat)", ("result",))
_tm_fallback = counter("ig_fleet_fallback_total",
                       "subtrees answered by the flat per-leaf fold "
                       "because their aggregator was unreachable or "
                       "crashed mid-fold")


def canonical_order(windows: Iterable[SealedWindow]) -> list[SealedWindow]:
    """The fold order both the flat path and the tree pin: sorted by
    (node, level, window, seq, digest) — a pure function of the window
    set, so reply arrival order cannot reach the merge (where the
    label-map last-wins update and the merge-base geometry choice would
    otherwise leak it into the sealed bytes)."""
    return sorted(windows, key=lambda w: (w.node, int(w.level),
                                          int(w.window), int(w.seq),
                                          w.digest))


def flat_summary(windows: Iterable[SealedWindow], *, gadget: str = "fleet",
                 node: str = "fleet") -> SealedWindow | None:
    """ONE flat fold over every window, sealed — the byte-identity
    anchor the tree-merged summary is asserted against."""
    ws = canonical_order(windows)
    if not ws:
        return None
    return merged_to_sealed(merge_windows(ws), gadget=gadget, node=node)


class AggregatorNode:
    """The aggregator role: holds the latest summary window per child
    (fed by the summary pub/sub or a fetch sweep), folds them on
    demand, republishes ONE sealed window + a FleetAggregate accounting
    header (wire.FLEET_AGGREGATE_FIELDS — the proto-documented shape).

    Stateless across publishes by design: `publish()` re-folds the
    current child set from scratch, so a crash mid-fold loses nothing
    but the attempt — the next publish over the same child summaries
    seals identical bytes, and a child observed twice simply replaces
    its previous summary (exactly-once per publish by construction)."""

    def __init__(self, id: str, children: Iterable[str], *,
                 gadget: str = "fleet"):
        self.id = id
        self.children = list(children)
        self.gadget = gadget
        self._latest: dict[str, SealedWindow] = {}

    def observe(self, child: str, window: SealedWindow) -> None:
        if child not in self.children:
            raise ValueError(f"{child!r} is not a child of aggregator "
                             f"{self.id!r} ({', '.join(self.children)})")
        self._latest[child] = window

    def discard(self, child: str) -> None:
        """Drop a departed child's summary (churn): its contribution
        leaves the next publish instead of going stale-forever."""
        self._latest.pop(child, None)

    def publish(self) -> tuple[SealedWindow | None, dict]:
        """(sealed merged window or None, FleetAggregate accounting)."""
        # fold in TOPOLOGY child order, not observation order: the
        # children list is fixed at construction, so reply arrival can
        # never leak into the sealed bytes — and for auto-balanced
        # trees child order IS canonical leaf order at every tier,
        # which is what keeps the republished summary byte-identical
        # to the flat fold (label map included)
        ws = [self._latest[c] for c in self.children
              if c in self._latest]
        missing = [c for c in self.children if c not in self._latest]
        if not ws:
            _tm_folds.labels(result="ok").inc()
            return None, self._aggregate(None, 0, missing, [])
        try:
            merged = merge_windows(ws)
            sealed = merged_to_sealed(merged, gadget=self.gadget,
                                      node=self.id)
        except Exception:
            _tm_folds.labels(result="failed").inc()
            raise
        _tm_folds.labels(result="ok").inc()
        return sealed, self._aggregate(sealed, len(ws), missing,
                                       list(merged.skipped))

    def _aggregate(self, sealed: SealedWindow | None, folded: int,
                   missing: list[str], skipped: list[str]) -> dict:
        return {
            "schema": wire.FLEET_AGGREGATE_SCHEMA,
            "aggregator": self.id,
            "gadget": self.gadget,
            "children": list(self.children),
            "folded": folded,
            "missing": missing,
            "skipped": skipped,
            "approx": bool(sealed.approx) if sealed is not None else False,
            "digest": sealed.digest if sealed is not None else "",
        }


@dataclasses.dataclass
class TreeFold:
    """One tree-routed fleet fold: the root summary plus the exact
    accounting the flat fold produces (levels/dropped/errors/paths), so
    `answer_query` renders either path identically."""

    window: SealedWindow | None
    levels: dict[int, int]
    dropped: list[str]
    errors: dict[str, str]
    paths: dict[str, str]          # per leaf: tree | flat-fallback |
                                   # unreachable
    fallback: list[str]            # aggregator ids answered flat
    depth: int
    subtree_folds: int
    aggregate: dict                # root FleetAggregate accounting


def fold_tree(topology: Topology,
              fetch_leaf: Callable[[str], dict], *,
              fetch_subtree: Callable[[TreeNode], dict] | None = None,
              gadget: str = "fleet") -> TreeFold:
    """Fold the fleet through `topology`.

    `fetch_leaf(node_id)` returns the per-agent summary dict the
    QueryWindows pushdown reply decodes to — ``{"window":
    SealedWindow|None, "levels": {level: n}, "dropped": [note],
    "losses": [loss]}`` — and raises on an unreachable agent.

    `fetch_subtree(tree_node)`, when given, asks a deployed
    AggregatorNode for its whole subtree in one hop (same reply shape);
    when it raises — the aggregator is partitioned away or crashed
    mid-fold — that subtree falls back to the flat per-leaf fold, the
    fallback counter trips, and the re-fold starts from zero folded
    leaves (the `folded` guard: a leaf summary enters this query's fold
    exactly once, crash-and-refold included)."""
    levels: dict[int, int] = {}
    dropped: list[str] = []
    errors: dict[str, str] = {}
    paths: dict[str, str] = {}
    fallback: list[str] = []
    # exactly-once core: one fetch and one accounting pass per leaf per
    # query, cached — a crash-and-refold reuses the cached summary
    # instead of re-fetching (no double-count) or re-accounting
    folded: set[str] = set()
    leaf_cache: dict[str, SealedWindow | None] = {}
    counts = {"subtree_folds": 0}

    def account(who: str, res: dict) -> None:
        for lvl, n in (res.get("levels") or {}).items():
            levels[int(lvl)] = levels.get(int(lvl), 0) + int(n)
        for note in res.get("dropped") or ():
            dropped.append(f"{who}: {note}")
        for loss in res.get("losses") or ():
            dropped.append(f"{who}: torn window tail "
                           f"({loss.get('reason', '?')}, "
                           f"{loss.get('dropped_bytes', 0)} bytes)")

    def fetch_one(leaf: str, path: str) -> SealedWindow | None:
        if leaf in folded:
            if leaf not in leaf_cache:
                return None  # consumed by a remote subtree reply
            if paths.get(leaf) != "unreachable":
                paths[leaf] = path  # a refold relabels how it answered
            return leaf_cache[leaf]
        folded.add(leaf)
        try:
            res = fetch_leaf(leaf)
        except Exception as e:  # noqa: BLE001 — per-node isolation
            errors[leaf] = str(e)
            paths[leaf] = "unreachable"
            leaf_cache[leaf] = None
            return None
        paths[leaf] = path
        account(leaf, res)
        leaf_cache[leaf] = res.get("window")
        return leaf_cache[leaf]

    def flat_fold(node: TreeNode) -> SealedWindow | None:
        """The fallback: fold this subtree's leaves with no
        intermediate tiers — exactly the pre-tree client loop (cached
        summaries are reused, so a refold never re-counts a leaf)."""
        ws = [w for leaf in Topology(node).leaves()
              if (w := fetch_one(leaf, "flat-fallback")) is not None]
        if not ws:
            return None
        merged = merge_windows(canonical_order(ws))
        for note in merged.skipped:
            dropped.append(f"{node.id}: {note}")
        return merged_to_sealed(merged, gadget=gadget, node=node.id)

    def fold(node: TreeNode) -> SealedWindow | None:
        if node.is_leaf:
            return fetch_one(node.id, "tree")
        if fetch_subtree is not None:
            try:
                res = fetch_subtree(node)
            except Exception as e:  # noqa: BLE001 — subtree isolation
                _tm_fallback.inc()
                fallback.append(node.id)
                dropped.append(f"{node.id}: aggregator unreachable "
                               f"({e}) — subtree re-folded flat")
                return flat_fold(node)
            counts["subtree_folds"] += 1
            account(node.id, res)
            for leaf in Topology(node).leaves():
                if leaf not in folded:
                    folded.add(leaf)
                    paths[leaf] = "tree"
            return res.get("window")
        # client-driven tier: this process performs the aggregator's
        # fold — same algebra, same seal, same accounting. Children
        # merge in TOPOLOGY order (deterministic; for auto trees equal
        # to canonical leaf order at every tier) — sorting by node id
        # here would mis-order a promoted remainder chunk, whose id
        # carries a different depth label than its siblings
        ws = [w for c in node.children if (w := fold(c)) is not None]
        if not ws:
            return None
        try:
            merged = merge_windows(ws)
            # a refusal at THIS tier (geometry mismatch, partial plane
            # coverage) must reach the answer's dropped_windows — the
            # sealed window it produces carries no trace of it, and
            # answer_query only re-merges what it is handed
            for note in merged.skipped:
                dropped.append(f"{node.id}: {note}")
            sealed = merged_to_sealed(merged, gadget=gadget,
                                      node=node.id)
        except Exception as e:  # noqa: BLE001 — crash mid-fold
            _tm_folds.labels(result="failed").inc()
            _tm_fallback.inc()
            fallback.append(node.id)
            dropped.append(f"{node.id}: aggregator fold crashed ({e}) — "
                           "subtree re-folded flat")
            return flat_fold(node)
        _tm_folds.labels(result="ok").inc()
        counts["subtree_folds"] += 1
        return sealed

    depth = topology.depth()
    _tm_depth.set(float(depth))
    try:
        root_win = fold(topology.root)
    finally:
        _tm_depth.set(0.0)
    aggregate = {
        "schema": wire.FLEET_AGGREGATE_SCHEMA,
        "aggregator": topology.root.id,
        "gadget": gadget,
        "children": [c.id for c in topology.root.children],
        "folded": sum(levels.values()),
        "missing": sorted(errors),
        "skipped": list(dropped),
        "approx": bool(root_win.approx) if root_win is not None else False,
        "digest": root_win.digest if root_win is not None else "",
    }
    return TreeFold(window=root_win, levels=levels, dropped=dropped,
                    errors=errors, paths=paths, fallback=fallback,
                    depth=depth, subtree_folds=counts["subtree_folds"],
                    aggregate=aggregate)


__all__ = ["AggregatorNode", "TreeFold", "canonical_order",
           "flat_summary", "fold_tree"]
