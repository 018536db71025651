"""SealedWindow: the unit of the sketch-history plane (the port's copy
of ``inspektor_gadget_tpu/history/window.py``, numpy only).

Mergeable sketches sealed per time window are stored per node and merged
lazily at query time: count-min tables and entropy buckets add, HLL
registers max, top-k candidate lists union and re-query.

One sealed window carries:

- the window's global sketch state (count-min table, HLL registers,
  entropy buckets, top-k candidates) for whole-traffic range queries;
- subpopulation slices: for each bounded-cardinality slice key observed
  in the window (``mntns:<ns>``, ``kind:<syscall>`` and the
  ``mntns:<ns>|kind:<k>`` cross product), a small host HLL, an
  entropy-bucket vector and an exact truncated heavy-hitter table;
- a content digest over the decoded state (arrays hashed by value and
  dtype, wall timestamps excluded), identical to the reference's for the
  same state, so windows sealed by GPU and TPU nodes merge and verify.

Encoding is a JSON header plus one npz payload, framed into history
segments by history/store.py with the capture journal's disciplines.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
from typing import Iterable

import numpy as np

# the host murmur3 twin (bit-identical to the device fmix32), shared with
# the invertible decode so the two never fork their hash family
from ..ops.hashing import fmix32_np as _fmix32_np

WINDOW_SCHEMA = "ig-tpu/sketch-window/v1"

# slice-plane geometry: small on purpose — a window carries up to
# max-slices of these, and the store holds hours of windows
SLICE_HLL_P = 8            # 256 one-byte registers per slice
SLICE_ENT_LOG2_WIDTH = 6   # 64 buckets per slice
SLICE_HH_K = 32            # exact truncated heavy-hitter table per slice

@dataclasses.dataclass
class SliceSketch:
    """One subpopulation's per-window state (host-side, numpy-only)."""

    events: int = 0
    hll: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1 << SLICE_HLL_P, dtype=np.uint8))
    ent: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1 << SLICE_ENT_LOG2_WIDTH,
                                         dtype=np.int64))
    hh: dict[int, int] = dataclasses.field(default_factory=dict)

    def update(self, hh_keys: np.ndarray, distinct_keys: np.ndarray,
               dist_keys: np.ndarray) -> None:
        self.events += len(hh_keys)
        # HLL scatter-max over leading-zero ranks (numpy twin of ops.hll)
        h = _fmix32_np(distinct_keys.astype(np.uint32))
        p = SLICE_HLL_P
        idx = (h >> np.uint32(32 - p)).astype(np.int64)
        rest = ((h << np.uint32(p)) | np.uint32((1 << p) - 1)).astype(np.uint32)
        # rank = leading zeros + 1 = 32 - floor(log2(rest)); rest is never
        # 0 (low p bits are padded with ones), and float64 is exact below
        # 2^32, so the vectorized log2 is the exact clz
        rank = (np.uint32(32) - np.floor(np.log2(
            rest.astype(np.float64))).astype(np.uint32)).astype(np.uint8)
        rank = np.minimum(rank, np.uint8(32 - p + 1))
        np.maximum.at(self.hll, idx, rank)
        # entropy buckets over the distribution stream
        eh = _fmix32_np(dist_keys.astype(np.uint32))
        eidx = (eh >> np.uint32(32 - SLICE_ENT_LOG2_WIDTH)).astype(np.int64)
        np.add.at(self.ent, eidx, 1)
        # exact heavy-hitter counts (truncated to SLICE_HH_K at seal)
        uniq, counts = np.unique(hh_keys.astype(np.uint32),
                                 return_counts=True)
        for k, c in zip(uniq.tolist(), counts.tolist()):
            if k:
                self.hh[k] = self.hh.get(k, 0) + c

    def sealed_hh(self) -> list[tuple[int, int]]:
        return sorted(self.hh.items(), key=lambda kv: -kv[1])[:SLICE_HH_K]


def slice_hll_estimate(registers: np.ndarray) -> float:
    """Standard HLL estimate over one (or a max-merged stack of) slice
    register vector(s) — numpy twin of ops.hll.hll_estimate."""
    m = registers.shape[-1]
    regs = registers.astype(np.float64)
    alpha = 0.7213 / (1 + 1.079 / m) if m > 64 else \
        {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1 + 1.079 / m))
    raw = alpha * m * m / np.sum(np.exp2(-regs))
    zeros = float(np.sum(registers == 0))
    if raw <= 2.5 * m and zeros > 0:
        return float(m * np.log(m / max(zeros, 1.0)))
    return float(raw)


def entropy_bits(counts: np.ndarray) -> float:
    """Shannon entropy (bits) of one bucket-count vector."""
    c = counts.astype(np.float64)
    n = c.sum()
    if n <= 0:
        return 0.0
    nz = c[c > 0]
    return float(np.log2(n) - np.sum(nz * np.log2(nz)) / n)


@dataclasses.dataclass
class SealedWindow:
    """One decoded window. Arrays mirror the device bundle's per-window
    state; slices carry the Hydra-lite subpopulation sketches."""

    gadget: str
    node: str
    run_id: str
    window: int                    # per-run window ordinal, 1-based
    start_ts: float
    end_ts: float
    events: int
    drops: int
    cms: np.ndarray                # (depth, width) int32
    hll: np.ndarray                # (m,) int32 — device HLL registers
    ent: np.ndarray                # (w,) float32 — entropy buckets
    topk_keys: np.ndarray          # (k,) uint32
    topk_counts: np.ndarray        # (k,) int64
    slices: dict[str, dict]        # key → {events, hll, ent, hh}
    names: dict[int, str] = dataclasses.field(default_factory=dict)
    slices_dropped: int = 0        # subpopulations over the per-window cap
    seq: int = 0                   # store seq once appended
    digest: str = ""
    # -- tier plane (history/lifecycle.py) --------------------------------
    # level 0 = sealed at native resolution by the operator; level N>0 =
    # a super-window the compaction engine merged from aged level-(N-1)
    # windows per the resolution schedule. compacted_from is the sealed
    # provenance list: one row per source window ({digest, seq, window,
    # run_id, start_ts, end_ts, level}) so coverage is auditable and a
    # crash between super-window append and source GC is deduplicatable
    # at query time (the source's digest is in exactly one list).
    level: int = 0
    compacted_from: list[dict] = dataclasses.field(default_factory=list)
    # -- invertible heavy-key plane -----------------------------------------
    # Per-window deltas of the bundle's invertible lanes (count int32,
    # keysum/fpsum uint32, all (rows, buckets)); None for configs without
    # the plane, and absent fields never enter the digest, so
    # plane-off window digests are unchanged. Merge is elementwise add (wrap is
    # the algebra), so decoding a MERGED range recovers the range's
    # heavy keys exactly like live merged state does.
    inv_count: np.ndarray | None = None
    inv_keysum: np.ndarray | None = None
    inv_fpsum: np.ndarray | None = None
    # -- latency quantile plane -----------------------------------------
    # Per-window DDSketch delta: bucket counts plus the zero/total
    # accounting, all exact integer subtractions of cumulative state.
    # alpha/min_value pin the bucket boundaries — two windows merge only
    # when they agree (different alpha = different log base = adding
    # apples to oranges). None (the default) for plane-off configs, and
    # absent fields never enter the digest — pre-plane window digests
    # are byte-identical.
    qt_counts: np.ndarray | None = None
    qt_zeros: int = 0
    qt_total: int = 0
    qt_alpha: float = 0.01
    qt_min_value: float = 1.0
    # -- accuracy audit plane -----------------------------------------
    # `approx` is the TopK candidate-ring overflow flag carried past the
    # seal boundary: True means some window of this state overflowed its
    # candidate ring, so merged top-k answers are approximate. It enters
    # the digest only when True, keeping every pre-existing digest
    # byte-identical. rs_keys/rs_weights are the per-window deterministic
    # bottom-k shadow-sample delta (ops/accuracy.ShadowSample lanes;
    # priorities recompute from keys, so they are never persisted):
    # None = plane off (absent from digest/encoding), empty = plane on
    # but nothing sampled this window.
    approx: bool = False
    rs_keys: np.ndarray | None = None
    rs_weights: np.ndarray | None = None
    rs_capacity: int = 0

    @property
    def slice_keys(self) -> list[str]:
        return sorted(self.slices)


def window_digest(win: SealedWindow) -> str:
    """Content digest of one sealed window: sha256 over the canonical
    JSON of the decoded state with every array hashed by VALUE. Wall
    timestamps are excluded — a deterministic replay reproduces the
    same device math at a different wall time, and the contract is
    byte-identical digests for byte-identical state."""
    def arr(a: np.ndarray) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    doc = {
        "schema": WINDOW_SCHEMA,
        "gadget": win.gadget,
        "window": int(win.window),
        "events": int(win.events),
        "drops": int(win.drops),
        "slices_dropped": int(win.slices_dropped),
        # resolution identity: the same merged state at a different tier
        # is a different window (compacted_from stays OUT — provenance
        # lists are trimmed/audited without changing state identity).
        # Level 0 omits the field so pre-tier digests stay reproducible.
        **({"level": int(win.level)} if win.level else {}),
        # invertible plane: present only when sealed with it, so digests
        # of plane-off configs (and all pre-plane history) are unchanged
        **({"inv_count": arr(win.inv_count),
            "inv_keysum": arr(win.inv_keysum),
            "inv_fpsum": arr(win.inv_fpsum)}
           if win.inv_count is not None else {}),
        # quantile plane: same conditional discipline — plane-off
        # windows digest as windows sealed without it
        **({"qt_counts": arr(win.qt_counts),
            "qt_zeros": int(win.qt_zeros),
            "qt_total": int(win.qt_total),
            "qt_alpha": float(win.qt_alpha),
            "qt_min_value": float(win.qt_min_value)}
           if win.qt_counts is not None else {}),
        # accuracy plane: approx enters only when True and the shadow
        # lanes only when the audit plane sealed them — plane-off
        # digests are byte-identical
        **({"approx": True} if win.approx else {}),
        **({"rs_keys": arr(win.rs_keys),
            "rs_weights": arr(win.rs_weights),
            "rs_capacity": int(win.rs_capacity)}
           if win.rs_keys is not None else {}),
        "cms": arr(win.cms),
        "hll": arr(win.hll),
        "ent": arr(win.ent),
        "topk_keys": arr(win.topk_keys),
        "topk_counts": arr(win.topk_counts),
        "slices": {
            key: {
                "events": int(s["events"]),
                "hll": arr(s["hll"]),
                "ent": arr(s["ent"]),
                "hh": [[int(k), int(c)] for k, c in s["hh"]],
            }
            for key, s in sorted(win.slices.items())
        },
    }
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def encode_window(win: SealedWindow) -> tuple[dict, bytes]:
    """SealedWindow → (frame header, npz payload). The header carries
    everything a ListWindows reply needs (range pruning, slice keys,
    digest) so listing never ships payload bytes."""
    arrays: dict[str, np.ndarray] = {
        "cms": win.cms,
        "hll": win.hll,
        "ent": win.ent,
        "topk_keys": win.topk_keys,
        "topk_counts": win.topk_counts,
    }
    if win.inv_count is not None:
        arrays["inv_count"] = win.inv_count
        arrays["inv_keysum"] = win.inv_keysum
        arrays["inv_fpsum"] = win.inv_fpsum
    if win.qt_counts is not None:
        arrays["qt_counts"] = win.qt_counts
    if win.rs_keys is not None:
        arrays["rs_keys"] = win.rs_keys
        arrays["rs_weights"] = win.rs_weights
    skeys = win.slice_keys
    if skeys:
        arrays["slice_events"] = np.array(
            [win.slices[k]["events"] for k in skeys], dtype=np.int64)
        arrays["slice_hll"] = np.stack(
            [win.slices[k]["hll"] for k in skeys]).astype(np.uint8)
        arrays["slice_ent"] = np.stack(
            [win.slices[k]["ent"] for k in skeys]).astype(np.int64)
        hh_keys = np.zeros((len(skeys), SLICE_HH_K), dtype=np.uint32)
        hh_counts = np.zeros((len(skeys), SLICE_HH_K), dtype=np.int64)
        for i, k in enumerate(skeys):
            pairs = win.slices[k]["hh"][:SLICE_HH_K]
            for j, (key32, c) in enumerate(pairs):
                hh_keys[i, j] = key32
                hh_counts[i, j] = c
        arrays["slice_hh_keys"] = hh_keys
        arrays["slice_hh_counts"] = hh_counts
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    header = {
        "schema": WINDOW_SCHEMA,
        "gadget": win.gadget,
        "node": win.node,
        "run_id": win.run_id,
        "window": int(win.window),
        "start_ts": float(win.start_ts),
        "end_ts": float(win.end_ts),
        "events": int(win.events),
        "drops": int(win.drops),
        "slices_dropped": int(win.slices_dropped),
        "keys": skeys,
        "names": {str(k): v for k, v in (win.names or {}).items()},
        "digest": win.digest or window_digest(win),
    }
    if win.level:
        header["level"] = int(win.level)
    if win.compacted_from:
        header["compacted_from"] = list(win.compacted_from)
    if win.qt_counts is not None:
        # scalar accounting + bucket-boundary identity ride the header
        # (range listings can report quantile coverage without payload
        # bytes); plane-off headers carry none of these keys, so the
        # pre-plane wire bytes are unchanged
        header["qt_zeros"] = int(win.qt_zeros)
        header["qt_total"] = int(win.qt_total)
        header["qt_alpha"] = float(win.qt_alpha)
        header["qt_min_value"] = float(win.qt_min_value)
    # accuracy plane headers ride only when carried, so plane-off wire
    # bytes (and the approx-false common case) are unchanged
    if win.approx:
        header["approx"] = True
    if win.rs_keys is not None:
        header["rs_capacity"] = int(win.rs_capacity)
    return header, buf.getvalue()


def decode_window(header: dict, payload: bytes) -> SealedWindow:
    with np.load(io.BytesIO(payload)) as z:
        arrays = {k: z[k] for k in z.files}
    skeys = list(header.get("keys") or [])
    slices: dict[str, dict] = {}
    if skeys and "slice_events" in arrays:
        for i, key in enumerate(skeys):
            hh_k = arrays["slice_hh_keys"][i]
            hh_c = arrays["slice_hh_counts"][i]
            slices[key] = {
                "events": int(arrays["slice_events"][i]),
                "hll": arrays["slice_hll"][i],
                "ent": arrays["slice_ent"][i],
                "hh": [(int(k), int(c)) for k, c in zip(hh_k, hh_c) if k],
            }
    return SealedWindow(
        gadget=header.get("gadget", ""),
        node=header.get("node", ""),
        run_id=header.get("run_id", ""),
        window=int(header.get("window", 0)),
        start_ts=float(header.get("start_ts", 0.0)),
        end_ts=float(header.get("end_ts", 0.0)),
        events=int(header.get("events", 0)),
        drops=int(header.get("drops", 0)),
        cms=arrays["cms"],
        hll=arrays["hll"],
        ent=arrays["ent"],
        topk_keys=arrays["topk_keys"],
        topk_counts=arrays["topk_counts"],
        slices=slices,
        names={int(k): v for k, v in (header.get("names") or {}).items()},
        slices_dropped=int(header.get("slices_dropped", 0)),
        seq=int(header.get("seq", 0)),
        digest=header.get("digest", ""),
        level=int(header.get("level", 0)),
        compacted_from=list(header.get("compacted_from") or []),
        inv_count=arrays.get("inv_count"),
        inv_keysum=arrays.get("inv_keysum"),
        inv_fpsum=arrays.get("inv_fpsum"),
        qt_counts=arrays.get("qt_counts"),
        qt_zeros=int(header.get("qt_zeros", 0)),
        qt_total=int(header.get("qt_total", 0)),
        qt_alpha=float(header.get("qt_alpha", 0.01)),
        qt_min_value=float(header.get("qt_min_value", 1.0)),
        approx=bool(header.get("approx", False)),
        rs_keys=arrays.get("rs_keys"),
        rs_weights=arrays.get("rs_weights"),
        rs_capacity=int(header.get("rs_capacity", 0)),
    )


def header_overlaps(header: dict, *, start_ts: float | None = None,
                    end_ts: float | None = None,
                    start_seq: int | None = None,
                    end_seq: int | None = None,
                    key: str | None = None) -> bool:
    """Does one ListWindows header row overlap the requested range/slice?
    The ONE overlap rule the agent RPC, the store's local reads, and the
    fan-out client all share — three copies would drift."""
    if start_ts is not None and float(header.get("end_ts", 0.0)) < start_ts:
        return False
    if end_ts is not None and float(header.get("start_ts", 0.0)) > end_ts:
        return False
    seq = int(header.get("seq", 0))
    if start_seq is not None and seq and seq < start_seq:
        return False
    if end_seq is not None and seq and seq > end_seq:
        return False
    if key and key not in (header.get("keys") or []):
        return False
    return True


# ---------------------------------------------------------------------------
# Merge algebra (query time)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MergedWindows:
    """Lazy-merged view over N sealed windows — the disaggregation
    paper's query-side fold. All fields are plain host state so answers
    render without device round-trips."""

    windows: int
    nodes: list[str]
    start_ts: float
    end_ts: float
    events: int
    drops: int
    cms: np.ndarray | None
    hll: np.ndarray | None
    ent: np.ndarray | None
    candidates: dict[int, int]       # key32 → summed top-k estimate
    slices: dict[str, dict]
    names: dict[int, str]
    skipped: list[str]               # windows dropped from the merge (why)
    # invertible plane fold (elementwise add); None when any folded
    # window lacked the plane or disagreed on geometry — the answer then
    # says so (skipped note) instead of decoding partial coverage
    inv_count: np.ndarray | None = None
    inv_keysum: np.ndarray | None = None
    inv_fpsum: np.ndarray | None = None
    # DDSketch fold (bucket-wise add); None when any folded window
    # lacked the plane or pinned different bucket boundaries
    # (alpha/min_value) — partial quantile coverage must not read as
    # total, so the answer drops the plane WITH a skipped note
    qt_counts: np.ndarray | None = None
    qt_zeros: int = 0
    qt_total: int = 0
    qt_alpha: float = 0.01
    qt_min_value: float = 1.0
    # accuracy plane: approx ORs over every consulted window (ANY
    # overflowed window taints the merged top-k — no coverage rule can
    # un-taint it); the shadow sample folds under the qt total-coverage
    # rule (merge is exact only while every window carries a matching
    # capacity)
    approx: bool = False
    rs: "object | None" = None       # ops.accuracy.ShadowSample

    def accuracy(self, heavy: list[tuple[int, int]] | None = None) -> dict | None:
        """The accuracy block for this merged range: analytic envelopes
        always (geometry is read off the merged arrays), observed error
        when the shadow plane folded with total coverage. None only for
        an empty merge (no geometry to derive bounds from)."""
        if self.cms is None or self.windows <= 0:
            return None
        from ..ops.accuracy import accuracy_block
        depth, width = self.cms.shape
        hh = heavy if heavy is not None else self.heavy_hitters(20)
        return accuracy_block(
            events=float(self.events),
            depth=int(depth), width=int(width),
            hll_p=int(np.log2(max(self.hll.shape[0], 2))),
            ent_log2_width=int(np.log2(max(self.ent.shape[0], 2))),
            distinct=self.distinct(),
            entropy_bits=self.entropy_bits(),
            hh_keys=np.array([k for k, _ in hh], np.uint32),
            hh_counts=np.array([c for _, c in hh], np.int64),
            qt_alpha=(float(self.qt_alpha) if self.qt_counts is not None
                      else None),
            shadow=self.rs,
        )

    def quantile(self, q) -> float | np.ndarray:
        """Value at quantile q over the merged range (<= alpha relative
        error — dd_merge is lossless, so the merged read is exactly the
        read of the union stream). NaN when the plane is absent."""
        if self.qt_counts is None:
            return float("nan") if np.ndim(q) == 0 else np.full(
                np.shape(q), np.nan)
        from ..ops.quantiles import dd_quantile_np
        out = dd_quantile_np(self.qt_counts, self.qt_zeros, self.qt_total,
                             q, alpha=self.qt_alpha,
                             min_value=self.qt_min_value)
        return float(out) if np.ndim(q) == 0 else out

    def quantile_answer(self) -> dict | None:
        """The standard quantile block (summary/CLI shape), or None when
        the plane is absent from the merged range."""
        if self.qt_counts is None:
            return None
        ps = self.quantile([0.50, 0.90, 0.99, 0.999])
        ps = np.nan_to_num(np.asarray(ps), nan=0.0)
        return {"p50": float(ps[0]), "p90": float(ps[1]),
                "p99": float(ps[2]), "p999": float(ps[3]),
                "zeros": int(self.qt_zeros), "total": int(self.qt_total),
                "underflow": int(self.qt_counts[0]),
                "alpha": float(self.qt_alpha)}

    def histogram_log2(self, n_slots: int = 32) -> np.ndarray | None:
        """biolatency-style log2 re-binning of the merged DDSketch row
        (ASCII render input): slot k counts values in [2^k, 2^(k+1)) of
        the lane's raw unit (ns for latency sources). None when the
        plane is absent."""
        if self.qt_counts is None:
            return None
        from ..ops.quantiles import dd_histogram_log2_np
        return dd_histogram_log2_np(self.qt_counts, alpha=self.qt_alpha,
                                    min_value=self.qt_min_value,
                                    n_slots=n_slots, unit_scale=1.0)

    def heavy_flows(self, top: int = 0,
                    min_count: int = 1) -> list[tuple[int, int]]:
        """Decode the merged invertible plane → exact (key32, count)
        pairs for the merged range, recovered from state alone (no
        candidate ring). Empty when the plane is absent/incomplete."""
        if self.inv_count is None:
            return []
        from ..ops.invertible import inv_decode
        dec = inv_decode((self.inv_count, self.inv_keysum,
                          self.inv_fpsum), min_count=min_count)
        return dec.keys[:top] if top else dec.keys

    def heavy_flow_decode(self):
        """Full decode result (keys + completeness accounting), or None
        when the plane is absent."""
        if self.inv_count is None:
            return None
        from ..ops.invertible import inv_decode
        return inv_decode((self.inv_count, self.inv_keysum,
                           self.inv_fpsum))

    def distinct(self) -> float:
        if self.hll is None:
            return 0.0
        return slice_hll_estimate(self.hll)

    def entropy_bits(self) -> float:
        if self.ent is None:
            return 0.0
        return entropy_bits(self.ent)

    def heavy_hitters(self, k: int = 20) -> list[tuple[int, int]]:
        # (-count, key) like merged_to_sealed: a stable -count sort
        # would break ties by dict insertion order, making the rendered
        # top-k depend on fold shape (flat vs incremental)
        order = sorted(self.candidates.items(),
                       key=lambda kv: (-kv[1], kv[0]))
        return [(key, int(c)) for key, c in order[:k] if key][:k]

    def slice_answer(self, key: str) -> dict | None:
        s = self.slices.get(key)
        if s is None:
            return None
        return {
            "key": key,
            "events": int(s["events"]),
            "distinct": slice_hll_estimate(s["hll"]),
            "entropy_bits": entropy_bits(s["ent"]),
            "heavy_hitters": sorted(
                s["hh"].items(),
                key=lambda kv: (-kv[1], kv[0]))[:SLICE_HH_K],
        }


def merge_windows(windows: Iterable[SealedWindow]) -> MergedWindows:
    """Fold sealed windows into one answer: CMS/entropy add, HLL max,
    top-k candidates union with summed per-window estimates, slices
    merge key-wise with the same algebra. Windows whose sketch geometry
    disagrees with the first window's are skipped AND reported — a
    silent shape coercion would corrupt every estimate downstream."""
    out = MergedWindows(windows=0, nodes=[], start_ts=0.0, end_ts=0.0,
                        events=0, drops=0, cms=None, hll=None, ent=None,
                        candidates={}, slices={}, names={}, skipped=[])
    inv_dropped = False
    qt_dropped = False
    rs_dropped = False

    def qt_matches(win: SealedWindow) -> bool:
        return (win.qt_counts.shape == out.qt_counts.shape
                and float(win.qt_alpha) == float(out.qt_alpha)
                and float(win.qt_min_value) == float(out.qt_min_value))

    def rs_of(win: SealedWindow):
        from ..ops.accuracy import ShadowSample
        return ShadowSample(win.rs_capacity, win.rs_keys, win.rs_weights)

    for win in windows:
        if out.cms is not None and (
                win.cms.shape != out.cms.shape
                or win.hll.shape != out.hll.shape
                or win.ent.shape != out.ent.shape):
            out.skipped.append(
                f"{win.node}/{win.gadget} window {win.window}: sketch "
                f"geometry {win.cms.shape}/{win.hll.shape}/{win.ent.shape} "
                "differs from the merge base")
            continue
        if out.cms is None:
            out.cms = win.cms.astype(np.int64).copy()
            out.hll = win.hll.copy()
            out.ent = win.ent.astype(np.float64).copy()
            out.start_ts, out.end_ts = win.start_ts, win.end_ts
            if win.inv_count is not None:
                out.inv_count = win.inv_count.astype(np.int64).copy()
                out.inv_keysum = win.inv_keysum.astype(np.uint32).copy()
                out.inv_fpsum = win.inv_fpsum.astype(np.uint32).copy()
            if win.qt_counts is not None:
                out.qt_counts = win.qt_counts.astype(np.int64).copy()
                out.qt_zeros = int(win.qt_zeros)
                out.qt_total = int(win.qt_total)
                out.qt_alpha = float(win.qt_alpha)
                out.qt_min_value = float(win.qt_min_value)
            if win.rs_keys is not None:
                out.rs = rs_of(win)
        else:
            out.cms += win.cms.astype(np.int64)
            np.maximum(out.hll, win.hll, out=out.hll)
            out.ent += win.ent.astype(np.float64)
            out.start_ts = min(out.start_ts, win.start_ts)
            out.end_ts = max(out.end_ts, win.end_ts)
        # invertible plane: fold while EVERY window carries a matching
        # geometry; one window without it (or shaped differently) makes
        # decode-of-the-range meaningless, so the plane is dropped from
        # the answer WITH a note — partial coverage must not decode as
        # if it were total
        if out.windows > 0:
            if win.inv_count is None:
                if out.inv_count is not None and not inv_dropped:
                    inv_dropped = True
                    out.skipped.append(
                        f"{win.node}/{win.gadget} window {win.window}: no "
                        "invertible plane — heavy-flow decode disabled "
                        "for this range (partial coverage would lie)")
                out.inv_count = out.inv_keysum = out.inv_fpsum = None
            elif out.inv_count is not None:
                if win.inv_count.shape != out.inv_count.shape:
                    inv_dropped = True
                    out.skipped.append(
                        f"{win.node}/{win.gadget} window {win.window}: "
                        f"invertible geometry {win.inv_count.shape} "
                        "differs from the merge base — heavy-flow decode "
                        "disabled for this range")
                    out.inv_count = out.inv_keysum = out.inv_fpsum = None
                else:
                    out.inv_count += win.inv_count.astype(np.int64)
                    out.inv_keysum += win.inv_keysum.astype(np.uint32)
                    out.inv_fpsum += win.inv_fpsum.astype(np.uint32)
            elif not inv_dropped and win.inv_count is not None:
                inv_dropped = True
                out.skipped.append(
                    f"{win.node}/{win.gadget} window {win.window}: "
                    "invertible plane present but an earlier window "
                    "lacked it — heavy-flow decode disabled for this "
                    "range")
        # quantile plane: same total-coverage rule as the invertible
        # fold — bucket counts add only while EVERY window carries the
        # plane with the SAME bucket boundaries (alpha/min_value pin the
        # log base); anything else drops the plane from the answer WITH
        # a note, because a partial or mixed-base fold would render
        # confident-looking but wrong percentiles
        if out.windows > 0:
            if win.qt_counts is None:
                if out.qt_counts is not None and not qt_dropped:
                    qt_dropped = True
                    out.skipped.append(
                        f"{win.node}/{win.gadget} window {win.window}: no "
                        "quantile plane — latency quantiles disabled for "
                        "this range (partial coverage would lie)")
                out.qt_counts = None
            elif out.qt_counts is not None:
                if not qt_matches(win):
                    qt_dropped = True
                    out.skipped.append(
                        f"{win.node}/{win.gadget} window {win.window}: "
                        f"quantile geometry {win.qt_counts.shape}/"
                        f"alpha={win.qt_alpha}/min={win.qt_min_value} "
                        "differs from the merge base — latency quantiles "
                        "disabled for this range")
                    out.qt_counts = None
                else:
                    out.qt_counts += win.qt_counts.astype(np.int64)
                    out.qt_zeros += int(win.qt_zeros)
                    out.qt_total += int(win.qt_total)
            elif not qt_dropped:
                qt_dropped = True
                out.skipped.append(
                    f"{win.node}/{win.gadget} window {win.window}: "
                    "quantile plane present but an earlier window lacked "
                    "it — latency quantiles disabled for this range")
        # shadow-sample plane: the qt total-coverage rule — a ground
        # truth over part of the range must not audit answers over all
        # of it, so one window without the plane (or with a different
        # capacity) drops the observed-error audit WITH a note; the
        # analytic envelopes survive regardless (geometry still merges)
        if out.windows > 0:
            if win.rs_keys is None:
                if out.rs is not None and not rs_dropped:
                    rs_dropped = True
                    out.skipped.append(
                        f"{win.node}/{win.gadget} window {win.window}: no "
                        "shadow sample — observed-error audit disabled "
                        "for this range (partial ground truth would lie)")
                out.rs = None
            elif out.rs is not None:
                if int(win.rs_capacity) != int(out.rs.capacity):
                    rs_dropped = True
                    out.skipped.append(
                        f"{win.node}/{win.gadget} window {win.window}: "
                        f"shadow capacity {win.rs_capacity} differs from "
                        f"the merge base {out.rs.capacity} — "
                        "observed-error audit disabled for this range")
                    out.rs = None
                else:
                    out.rs = out.rs.merge(rs_of(win))
            elif not rs_dropped:
                rs_dropped = True
                out.skipped.append(
                    f"{win.node}/{win.gadget} window {win.window}: "
                    "shadow sample present but an earlier window lacked "
                    "it — observed-error audit disabled for this range")
        # candidate-overflow taint ORs unconditionally: one overflowed
        # window makes the merged top-k approximate no matter how many
        # clean windows join it
        out.approx = out.approx or bool(win.approx)
        out.windows += 1
        if win.node and win.node not in out.nodes:
            out.nodes.append(win.node)
        out.events += int(win.events)
        out.drops += int(win.drops)
        for key, c in zip(win.topk_keys.tolist(), win.topk_counts.tolist()):
            if key:
                out.candidates[key] = out.candidates.get(key, 0) + int(c)
        out.names.update(win.names or {})
        for skey, s in win.slices.items():
            dst = out.slices.get(skey)
            if dst is None:
                out.slices[skey] = {
                    "events": int(s["events"]),
                    "hll": np.array(s["hll"], dtype=np.uint8, copy=True),
                    "ent": s["ent"].astype(np.int64).copy(),
                    "hh": dict(s["hh"]),
                }
                continue
            if dst["hll"].shape != s["hll"].shape or \
                    dst["ent"].shape != s["ent"].shape:
                out.skipped.append(
                    f"{win.node}/{win.gadget} window {win.window}: slice "
                    f"{skey!r} geometry differs from the merge base")
                continue
            dst["events"] += int(s["events"])
            np.maximum(dst["hll"], s["hll"], out=dst["hll"])
            dst["ent"] += s["ent"].astype(np.int64)
            for k, c in s["hh"]:
                dst["hh"][k] = dst["hh"].get(k, 0) + c
    return out


def provenance_row(win: SealedWindow) -> dict:
    """One compacted_from entry: enough to audit that the source's
    seq/ts coverage landed in exactly one super-window, and to dedup a
    source that survived a crash between super-window append and GC."""
    return {"digest": win.digest, "seq": int(win.seq),
            "window": int(win.window), "run_id": win.run_id,
            "start_ts": float(win.start_ts), "end_ts": float(win.end_ts),
            "level": int(win.level)}


def merged_to_sealed(merged: MergedWindows, *, gadget: str, node: str,
                     level: int = 0, window: int = 0, run_id: str = "",
                     compacted_from: list[dict] | None = None,
                     ) -> SealedWindow:
    """MergedWindows → one SealedWindow — the shape both the compaction
    engine (a super-window per time bucket) and the QueryWindows
    pushdown reply (one merged window per node) seal a fold into. The
    candidate union is kept WHOLE (bounded by windows × top-k), so the
    additive planes and top-k estimates survive re-merging downstream
    with no extra truncation error at this boundary."""
    # tie-break by key, not just estimate: a stable -count sort would
    # leak dict insertion order into the sealed bytes, making the digest
    # depend on fold SHAPE (flat left-fold vs the standing-query plane's
    # pairwise incremental fold). (-count, key) is a pure function of
    # the candidate multiset, so every fold shape seals byte-identically.
    cand = sorted(merged.candidates.items(), key=lambda kv: (-kv[1], kv[0]))
    slices: dict[str, dict] = {}
    for skey, s in merged.slices.items():
        slices[skey] = {
            "events": int(s["events"]),
            "hll": s["hll"],
            "ent": s["ent"],
            "hh": sorted(s["hh"].items(), key=lambda kv: (-kv[1], kv[0])),
        }
    win = SealedWindow(
        gadget=gadget, node=node, run_id=run_id, window=int(window),
        start_ts=float(merged.start_ts), end_ts=float(merged.end_ts),
        events=int(merged.events), drops=int(merged.drops),
        cms=(merged.cms if merged.cms is not None
             else np.zeros((1, 1), np.int64)),
        hll=(merged.hll if merged.hll is not None
             else np.zeros(1, np.int32)),
        ent=(merged.ent if merged.ent is not None
             else np.zeros(1, np.float64)),
        topk_keys=np.array([k for k, _ in cand], dtype=np.uint32),
        topk_counts=np.array([c for _, c in cand], dtype=np.int64),
        slices=slices,
        names=dict(merged.names),
        level=int(level),
        compacted_from=list(compacted_from or []),
        # the count lane stays int64 on the compaction/pushdown write
        # path: a super-window can cover an unbounded range, and an
        # int32 downcast past 2^31 would wrap consistently with the
        # mod-2^32 key-sum/fingerprint lanes — decoding to a plausible
        # but WRONG "exact" count. int64 counts decode exactly (only
        # the sum lanes are modular); merge_windows already folds mixed
        # int32 (operator-sealed deltas) and int64 windows in int64.
        inv_count=(merged.inv_count if merged.inv_count is not None
                   else None),
        inv_keysum=(merged.inv_keysum if merged.inv_keysum is not None
                    else None),
        inv_fpsum=(merged.inv_fpsum if merged.inv_fpsum is not None
                   else None),
        # the quantile fold rides the same int64 write path: a
        # super-window's bucket counts can exceed int32 over an
        # unbounded range; merge_windows folds mixed int32/int64 in
        # int64 already
        qt_counts=(merged.qt_counts if merged.qt_counts is not None
                   else None),
        qt_zeros=int(merged.qt_zeros),
        qt_total=int(merged.qt_total),
        qt_alpha=float(merged.qt_alpha),
        qt_min_value=float(merged.qt_min_value),
        # accuracy plane survives re-sealing (compaction, pushdown,
        # standing-query folds): the taint flag rides through, and the
        # merged shadow — itself bit-identical to a single-pass sample
        # of the union stream — re-seals as this window's lanes
        approx=bool(merged.approx),
        rs_keys=(merged.rs.keys if merged.rs is not None else None),
        rs_weights=(merged.rs.weights if merged.rs is not None else None),
        rs_capacity=(int(merged.rs.capacity) if merged.rs is not None
                     else 0),
    )
    win.digest = window_digest(win)
    return win


__all__ = ["MergedWindows", "SLICE_ENT_LOG2_WIDTH", "SLICE_HH_K",
           "SLICE_HLL_P", "SealedWindow", "SliceSketch", "WINDOW_SCHEMA",
           "decode_window", "encode_window", "entropy_bits",
           "header_overlaps", "merge_windows", "merged_to_sealed",
           "provenance_row", "slice_hll_estimate", "window_digest"]
