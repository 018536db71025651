"""Historical range queries over sealed windows.

The query side of the disaggregation design: windows were sealed
per-node with zero coordination; answering "cardinality of tenant X,
2–3pm, across nodes" is (1) prune — only windows whose [start_ts,
end_ts] overlap the range and whose key set contains the slice, (2)
pull — fetch just those windows' frames, (3) fold — the merge algebra
in history/window.py. This module owns (3) plus the frame packing the
FetchWindows RPC ships pulled windows in.

Error bounds are the constituent sketches' (documented in
docs/observability.md): CMS overestimates by ≤ N·e/width per row-min,
HLL standard error ≈ 1.04/√m, entropy biased down slightly by bucket
collisions; merging sealed windows adds NO further error (the sketches
are homomorphic: update-then-merge ≡ merge-then-update).

The port's copy of ``inspektor_gadget_tpu/history/query.py`` (numpy
only), over the port's `history.window` merge algebra.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Iterable

from ..agent import wire
from .window import SealedWindow, decode_window, merge_windows

# one packed frame = u32 length | u32 crc32(zpayload) | zpayload — the
# exact journal segment framing, so a fetched byte stream tolerates a
# truncated tail the same way a segment file does
_FRAME_HEADER = 8


def pack_frames(frames: Iterable[tuple[dict, bytes]]) -> bytes:
    out = bytearray()
    for header, payload in frames:
        zp = zlib.compress(wire.encode_msg(header, payload), 1)
        out += len(zp).to_bytes(4, "little")
        out += (zlib.crc32(zp) & 0xFFFFFFFF).to_bytes(4, "little")
        out += zp
    return bytes(out)


def unpack_frames(data: bytes) -> tuple[list[tuple[dict, bytes]], int]:
    """(frames, dropped_bytes): a short/undecodable tail is dropped and
    accounted, never half-decoded — the torn-window read contract."""
    from ..capture.journal import _decode_frame, _frame_at
    frames: list[tuple[dict, bytes]] = []
    off, n = 0, len(data)
    while off < n:
        end, zpayload, reason = _frame_at(data, off)
        decoded = None if reason else _decode_frame(zpayload)
        if reason or decoded is None:
            return frames, n - off
        frames.append(decoded)
        off = end
    return frames, 0


@dataclasses.dataclass
class QueryAnswer:
    """One rendered range-query result (ig-tpu query's output shape)."""

    windows: int
    nodes: list[str]
    start_ts: float
    end_ts: float
    events: int
    drops: int
    distinct: float
    entropy_bits: float
    heavy_hitters: list[tuple[int, int, str]]   # (key32, count, label)
    slices: dict[str, dict]
    dropped_windows: list[str]      # merges refused (geometry) + torn tails
    errors: dict[str, str]          # per-node fetch errors (never fatal)
    # tier accounting (history/lifecycle.py): windows folded per
    # compaction level — a nonzero level>0 count means part of this
    # answer came from compacted (coarser-resolution) super-windows,
    # and the CLI says so rather than surprising the user with
    # resolution loss. paths records HOW each node answered:
    # "pushdown" (QueryWindows folded node-side), "fetch" (list+fetch
    # fallback for old agents), or "local".
    levels: dict[int, int] = dataclasses.field(default_factory=dict)
    paths: dict[str, str] = dataclasses.field(default_factory=dict)
    # invertible-plane decode of the merged range: exact
    # (key32, count, label) rows recovered from merged state alone, the
    # subset of them the candidate ring missed (decoded_only — the
    # observable win over tracked candidates), and the decode's
    # completeness accounting; all empty/None when the range's windows
    # don't (all) carry the plane
    heavy_flows: list[tuple[int, int, str]] = dataclasses.field(
        default_factory=list)
    decoded_only: list[tuple[int, int, str]] = dataclasses.field(
        default_factory=list)
    inv: dict | None = None
    # latency quantile plane: {p50, p90, p99, p999, zeros,
    # total, underflow, alpha} read off the merged DDSketch fold, plus
    # the log2 histogram render input; both None when the range's
    # windows don't (all) carry the plane with one bucket geometry
    quantiles: dict | None = None
    histogram: list[int] | None = None
    # accuracy audit plane: the per-stat error envelope —
    # analytic bounds ALWAYS (derived client-side from the merged
    # geometry + observed mass, so even plane-off history answers carry
    # them), observed error only when every consulted window carried the
    # shadow sample. `approx` is the candidate-overflow taint: True
    # when ANY consulted window overflowed its top-k candidate ring.
    accuracy: dict | None = None
    approx: bool = False
    # fleet aggregation tier: present only when the query was
    # routed through a merge tree — {depth, fan_in, subtree_folds,
    # fallback: [aggregator ids answered flat], aggregate: the root
    # FleetAggregate accounting header}. The answer numbers themselves
    # are byte-identical to the flat fold's (that is the tier's
    # contract); this block records HOW the tree answered.
    fleet: dict | None = None

    def compacted_windows(self) -> int:
        """How many folded windows were coarser than native resolution."""
        return sum(n for lvl, n in self.levels.items() if lvl > 0)

    def to_dict(self) -> dict:
        return {
            "windows": self.windows,
            "nodes": self.nodes,
            "start_ts": self.start_ts,
            "end_ts": self.end_ts,
            "events": self.events,
            "drops": self.drops,
            "distinct": self.distinct,
            "entropy_bits": self.entropy_bits,
            "heavy_hitters": [
                {"key": f"0x{k:08x}", "count": c, "label": label}
                for k, c, label in self.heavy_hitters],
            "heavy_flows": [
                {"key": f"0x{k:08x}", "count": c, "label": label}
                for k, c, label in self.heavy_flows],
            "decoded_only": [
                {"key": f"0x{k:08x}", "count": c, "label": label}
                for k, c, label in self.decoded_only],
            "inv": self.inv,
            "quantiles": self.quantiles,
            "histogram": self.histogram,
            "slices": self.slices,
            "dropped_windows": self.dropped_windows,
            "errors": self.errors,
            "levels": {str(k): v for k, v in sorted(self.levels.items())},
            "compacted_windows": self.compacted_windows(),
            "paths": dict(self.paths),
            "accuracy": self.accuracy,
            "approx": self.approx,
            "fleet": self.fleet,
        }


def dedupe_compacted(windows: Iterable[SealedWindow]
                     ) -> tuple[list[SealedWindow], list[str]]:
    """Exactly-once coverage across tiers: drop (1) any window whose
    digest a present super-window's compacted_from lists — a crash
    between super-window append and source GC leaves both on disk, and
    merging both would double-count — and (2) exact duplicate digests.
    Returns (kept, notes); every drop is reported, never silent."""
    wins = list(windows)
    # dedup is PER NODE: a tier ladder lives inside one node's store,
    # and two nodes ingesting identical traffic legitimately seal
    # byte-identical (same-digest) windows that must BOTH fold
    covered: dict[tuple[str, str], str] = {}
    for w in wins:
        for row in w.compacted_from:
            d = row.get("digest")
            if d:
                covered[(w.node, d)] = \
                    f"{w.node}/{w.gadget} L{w.level} super-window"
    kept: list[SealedWindow] = []
    notes: list[str] = []
    seen: set[tuple[str, str]] = set()
    for w in wins:
        who = f"{w.node}/{w.gadget} window {w.window} (L{w.level})"
        if w.digest and (w.node, w.digest) in covered:
            notes.append(f"{who}: superseded by "
                         f"{covered[(w.node, w.digest)]} "
                         "(compaction source not yet GC'd)")
            continue
        if w.digest and (w.node, w.digest) in seen:
            notes.append(f"{who}: duplicate digest, folded once")
            continue
        if w.digest:
            seen.add((w.node, w.digest))
        kept.append(w)
    return kept, notes


def level_counts(windows: Iterable[SealedWindow]) -> dict[int, int]:
    """Windows folded per compaction level — the consultation
    accounting a query answer carries so resolution loss is visible."""
    out: dict[int, int] = {}
    for w in windows:
        out[w.level] = out.get(w.level, 0) + 1
    return out


def answer_query(windows: Iterable[SealedWindow], *,
                 key: str | None = None, top: int = 20,
                 dropped: list[str] | None = None,
                 errors: dict[str, str] | None = None,
                 levels: dict[int, int] | None = None,
                 paths: dict[str, str] | None = None) -> QueryAnswer:
    """Fold sealed windows into one QueryAnswer. With `key`, the global
    numbers still cover the whole merged traffic and `slices` is
    restricted to that one subpopulation; without it, every observed
    slice is answered. Windows covered by a present super-window are
    deduped (exactly-once across tiers) before the fold; `levels`
    overrides the per-level accounting when the caller already folded
    node-side (pushdown) and holds better counts than the one merged
    window per node left here."""
    kept, dedup_notes = dedupe_compacted(windows)
    merged = merge_windows(kept)
    labels = merged.names
    hh = [(k, c, labels.get(k, f"0x{k:08x}"))
          for k, c in merged.heavy_hitters(top)]
    # invertible plane: decode the merged range (exact counts, no
    # per-key storage) and report what the candidate ring missed
    flows: list[tuple[int, int, str]] = []
    decoded_only: list[tuple[int, int, str]] = []
    inv_info = None
    dec = merged.heavy_flow_decode()
    if dec is not None:
        flows = [(k, c, labels.get(k, f"0x{k:08x}"))
                 for k, c in dec.top(top)]
        ring = set(merged.candidates)
        decoded_only = [(k, c, labels.get(k, f"0x{k:08x}"))
                        for k, c in dec.keys if k not in ring][:top]
        inv_info = {"recovered": dec.recovered,
                    "complete": dec.complete,
                    "residual_events": dec.residual_events}
    # quantile plane: one read off the merged fold — dd_merge is
    # lossless, so this equals the read of the union stream
    qt_out = merged.quantile_answer()
    hist = merged.histogram_log2()
    slices: dict[str, dict] = {}
    for skey in ([key] if key else sorted(merged.slices)):
        ans = merged.slice_answer(skey)
        if ans is None:
            continue
        ans["heavy_hitters"] = [
            {"key": f"0x{k:08x}", "count": c,
             "label": labels.get(k, f"0x{k:08x}")}
            for k, c in ans["heavy_hitters"][:top]]
        slices[skey] = ans
    return QueryAnswer(
        # `windows` reports how many sealed windows the answer
        # CONSULTED: under pushdown the caller's per-node accounting
        # (levels) holds that number — the one merged window per node
        # that reached this fold would under-report it
        windows=(sum(levels.values()) if levels is not None
                 else merged.windows),
        nodes=merged.nodes,
        start_ts=merged.start_ts,
        end_ts=merged.end_ts,
        events=merged.events,
        drops=merged.drops,
        distinct=merged.distinct(),
        entropy_bits=merged.entropy_bits(),
        heavy_hitters=hh,
        slices=slices,
        dropped_windows=(list(merged.skipped) + dedup_notes
                         + list(dropped or [])),
        errors=dict(errors or {}),
        levels=dict(levels) if levels is not None else level_counts(kept),
        paths=dict(paths or {}),
        heavy_flows=flows,
        decoded_only=decoded_only,
        inv=inv_info,
        quantiles=qt_out,
        histogram=(hist.tolist() if hist is not None else None),
        accuracy=merged.accuracy(heavy=[(k, c) for k, c, _ in hh]),
        approx=bool(merged.approx),
    )


def decode_frames(frames: Iterable[tuple[dict, bytes]]
                  ) -> list[SealedWindow]:
    return [decode_window(h, p) for h, p in frames]


__all__ = ["QueryAnswer", "answer_query", "decode_frames",
           "dedupe_compacted", "level_counts", "pack_frames",
           "unpack_frames"]
