"""The tpusketch operator's sketch plane on one device (PyTorch port of
``inspektor_gadget_tpu/operators/tpusketch.py``, `TpuSketchInstance`).

Event batches flow into a per-run `SketchBundle` on the device
(count-min, HLL, entropy, top-k, and optionally the invertible and
DDSketch planes) through the staged ingest step (K2 on the card). A
harvest reads the bundle back in one digest, decodes the invertible
plane, reads the quantiles, audits the estimates against a shadow
sample and scores every container with the anomaly scorer. With the
history plane on, a seal cuts one mergeable window out of the
cumulative state and hands it, encoded, to the run's ``window_sink``.
Checkpoints are the reference's files, so either package resumes the
other's bundle.

The gadget-framework shell (params, registration, ``GadgetContext``)
waits for its ROADMAP item (10b): an instance takes a `SketchConfig`
(the reference's instance params, ``-`` written ``_``) and a
`SketchContext` (what it reads from the gadget context). Sharded
ingest, standing queries and the history store's lifecycle raise,
naming the ROADMAP item that ports them.

The reference donates its bundle to each step; the port updates it in
place under ``_bundle_mu``, and every host snapshot that must outlive
the next step is a copy (on the CPU a tensor's ``.numpy()`` is the
live state). Spans are ``torch.profiler.record_function`` ranges named
as the reference's spans (without their attributes).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from ..device import resolve_device
from ..models.autoencoder import AEConfig, ae_init, ae_score, ae_train_step, normalize_counts
from ..models.params import scorer_from_leaves, scorer_leaves
from ..models.seqmodel import SeqConfig, seq_init, seq_score, seq_train_step, tokens_from_keys
from ..models.tick import seq_window_matrix
from ..models.vae import VAEConfig, vae_init, vae_score, vae_train_step
from ..ops.hashing import bits32, fold64_to_32
from ..ops.hll import hll_init
from ..ops.invertible import (InvSketch, class_weights, inv_capacity, inv_decode,
                              inv_decode_device, inv_decode_finish, inv_init, inv_merge,
                              inv_update, parse_priority_classes, validate_class_budget)
from ..ops.sketches import (bundle_digest, bundle_from_numpy, bundle_ingest_step, bundle_init,
                            bundle_merge, bundle_to_numpy, decode_digest)
from ..ops.window import hll_ingest_step, wcms_advance, wcms_ingest_step, wcms_init, wcms_query
from ..sources.batch import BATCH_COLUMNS, EventBatch, FoldedBatch
from ..sources.staging import H2DStager, PinnedBufferPool
from ..telemetry import counter, histogram
from ..telemetry.pipeline import PipelineStats

_log = logging.getLogger("ig-tpu.tpusketch")

# device-plane telemetry (batch grain; the histograms time the host side,
# the card's completion surfaces in the next blocking read)
_tm_events = counter("ig_tpusketch_events_total",
                     "events absorbed by the sketch plane", ("gadget",))
_tm_steps = counter("ig_tpusketch_steps_total",
                    "bundle_update device steps", ("gadget",))
_tm_drops = counter("ig_tpusketch_drops_total",
                    "upstream drops folded into the bundle", ("gadget",))
_tm_harvests = counter("ig_tpusketch_harvests_total",
                       "harvest ticks", ("gadget",))
_tm_h2d = histogram("ig_tpusketch_h2d_seconds",
                    "host→device batch staging (pad/fold + transfer "
                    "dispatch)", ("gadget",))
_tm_update = histogram("ig_tpusketch_update_seconds",
                       "bundle_update step dispatch", ("gadget",))
_tm_harvest_s = histogram("ig_tpusketch_harvest_seconds",
                          "digest D2H + decode + scoring per harvest tick",
                          ("gadget",))
_tm_merge_s = histogram("ig_tpusketch_merge_seconds",
                        "bundle_merge latency (checkpoint resume)")
_tm_ckpt_ok = counter("ig_tpusketch_checkpoints_total",
                      "successful sketch-state checkpoints")
_tm_ckpt_fail = counter("ig_tpusketch_checkpoint_failures_total",
                        "failed sketch-state checkpoint attempts")
_tm_cand_overflow = counter(
    "ig_sketch_candidate_overflow_total",
    "runs whose top-k candidate population exceeded k (the harvest's "
    "heavy-hitter re-rank became approximate; summaries carry approx=True)",
    ("gadget",))
_tm_qt_events = counter(
    "ig_sketch_quantile_events_total",
    "events absorbed into the DDSketch quantile plane", ("gadget",))
_tm_qt_zero = counter(
    "ig_sketch_quantile_zero_total",
    "quantile-plane events whose value lane was zero (no magnitude — "
    "they land in the sketch's zero bucket, not a log bucket)")


class ParamError(ValueError):
    """A configuration the operator refuses, with the reference's message."""


def _int_range(key: str, v: int, lo: int | None = None, hi: int | None = None) -> None:
    """The reference's ``validate_int_range`` at the params layer."""
    if lo is not None and v < lo:
        raise ParamError(f"param {key!r}: {v} below minimum {lo}")
    if hi is not None and v > hi:
        raise ParamError(f"param {key!r}: {v} above maximum {hi}")


@dataclasses.dataclass
class SketchConfig:
    """The reference's tpusketch instance params (``tpusketch.py:302-489``)
    with their defaults; durations are seconds."""

    depth: int = 4
    log2_width: int = 16
    hll_p: int = 14
    entropy_log2_width: int = 12
    topk: int = 128
    hh_column: str = "key_hash"
    distinct_column: str = "key_hash"
    dist_column: str = "key_hash"
    anomaly: bool = False
    anomaly_model: str = "ae"
    seq_window: int = 256
    harvest_interval: float = 1.0
    h2d_depth: int = 2
    invertible: bool = False
    inv_log2_buckets: int = 12
    inv_rows: int = 3
    priority_classes: str = ""
    quantiles: bool = False
    quantile_alpha: float = 0.01
    quantile_field: str = "aux1"
    audit_sample: int = 0
    shard_ingest: bool = False
    chips: str | int = "auto"
    history: bool = False
    history_interval: float = 10.0
    history_log2_width: int = 12
    history_slots: int = 8
    history_max_slices: int = 256
    history_compact: bool = False
    history_archive_dir: str = ""
    standing_queries: str = ""

    def validate(self) -> None:
        """The checks the reference's params layer makes when a value is
        set (validators, possible values), as ParamError."""
        if self.anomaly_model not in ("ae", "vae", "seq"):
            raise ParamError(f"param 'anomaly-model': {self.anomaly_model!r} not one of "
                             "['ae', 'vae', 'seq']")
        _int_range("inv-log2-buckets", self.inv_log2_buckets, 6, 20)
        _int_range("inv-rows", self.inv_rows, 2, 8)
        _int_range("audit-sample", self.audit_sample, 0)
        if not 0.0 < float(self.quantile_alpha) <= 0.3:
            raise ParamError(f"param 'quantile-alpha': quantile-alpha must be in (0, 0.3], "
                             f"got {float(self.quantile_alpha)}")
        if self.priority_classes:
            try:
                parse_priority_classes(self.priority_classes)
            except ValueError as e:
                raise ParamError(f"param 'priority-classes': {e}") from None
        if self.chips != "auto":
            try:
                chips = int(self.chips)
            except ValueError:
                raise ParamError(f"param 'chips': {self.chips!r} is not an integer or "
                                 "'auto'") from None
            if chips < 1:
                raise ParamError(f"param 'chips': chips must be >= 1, got {chips}")


@dataclasses.dataclass
class SketchContext:
    """What the instance reads from the reference's ``GadgetContext``:
    the run's identity, the gadget's batch size, the history clock, the
    summary and window hooks (read live, as the reference reads
    ``ctx.extra``), and the gadget's key resolver. ``window_sink`` takes
    each sealed window as `encode_window` gives it, (header, payload):
    it stands in for the reference's history store."""

    gadget: str = "trace/exec"
    run_id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex[:12])
    node: str = ""
    batch_size: int = 0
    history_gadget: str = ""
    history_clock: Callable[[], float] | None = None
    on_sketch_summary: Callable[["SketchSummary"], None] | None = None
    on_window_sealed: Callable[[dict], None] | None = None
    window_sink: Callable[[dict, bytes], None] | None = None
    resolve_key: Callable[[int], str] | None = None
    replay: bool = False


@dataclasses.dataclass
class HeavyHitterRow:
    """Rendered harvest row (the sketch-column type)."""

    key: str = ""
    count: int = 0
    share: float = 0.0


@dataclasses.dataclass
class SketchSummary:
    events: int
    drops: int
    distinct: float
    entropy_bits: float
    heavy_hitters: list[tuple[int, int]]  # (key32, est count)
    anomaly: dict[int, float] | None = None  # mntns → score
    epoch: int = 0
    names: dict[int, str] = dataclasses.field(default_factory=dict)  # key32 → label
    # True once the tracked top-k population exceeded k: heavy_hitters is
    # then an approximation, not the exact re-rank
    approx: bool = False
    # invertible-plane decode: exact (key32, count) pairs, and those the
    # candidate ring missed
    decoded: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    decoded_only: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    inv: dict | None = None        # {recovered, complete, residual_events, capacity}
    classes: dict[str, dict] | None = None  # priority class → decode answer
    quantiles: dict | None = None  # {p50, p90, p99, p999, zeros, total, underflow, alpha}
    pipeline: dict | None = None   # PipelineStats.snapshot() at harvest time
    accuracy: dict | None = None   # ops.accuracy.accuracy_block, audit plane on


# -- checkpoint/resume plumbing ----------------------------------------------
# Pointed at a checkpoint directory, every instance resumes from (merges)
# and saves to <dir>/<category>-<gadget>[-scorer|-invclasses].npz.

_ckpt_dir: Path | None = None
_live: dict[str, "TpuSketchInstance"] = {}  # run_id → instance
_live_mu = threading.Lock()


def set_checkpoint_dir(path: str | Path | None) -> None:
    global _ckpt_dir
    _ckpt_dir = Path(path) if path else None


def checkpoint_dir() -> Path | None:
    return _ckpt_dir


def live_instances() -> list["TpuSketchInstance"]:
    with _live_mu:
        return list(_live.values())


def _checkpoint_logged(inst: "TpuSketchInstance", retries: int = 1) -> bool:
    """One instance save with failure accounting: failures are logged,
    counted and retried once. Never raises."""
    for attempt in range(1 + retries):
        try:
            inst.checkpoint()
            _tm_ckpt_ok.inc()
            return True
        except Exception as e:  # noqa: BLE001 — one bad save must not stop the rest
            _tm_ckpt_fail.inc()
            _log.warning("checkpoint of %s failed (attempt %d/%d): %r",
                         getattr(inst, "_ckpt_key", "?"), attempt + 1, 1 + retries, e)
    return False


def checkpoint_all() -> int:
    """Save every live sketch instance; returns how many were saved."""
    return sum(_checkpoint_logged(inst) for inst in live_instances())


def _lane_np(t: torch.Tensor) -> np.ndarray:
    """A uint32 lane (int64 or int32 tensor) as a uint32 numpy copy."""
    return bits32(t).cpu().numpy().view(np.uint32).copy()


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host uint32 lane as an int32 bit view on `dev` (a copy)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(dev, copy=True)


class TpuSketchInstance:
    """One run's sketch plane on one device (the reference's single-chip
    path, ``tpusketch.py:495-2117``)."""

    def __init__(self, config: SketchConfig | None = None,
                 context: SketchContext | None = None,
                 device: str | torch.device = "cuda"):
        cfg = config if config is not None else SketchConfig()
        ctx = context if context is not None else SketchContext()
        cfg.validate()
        self.device = resolve_device(device)
        self.config, self.ctx = cfg, ctx
        self.hh_col = cfg.hh_column
        self.distinct_col = cfg.distinct_column
        self.dist_col = cfg.dist_column
        self.harvest_interval = cfg.harvest_interval or 1.0
        self._bundle_mu = threading.Lock()
        g = ctx.gadget
        self._m_events = _tm_events.labels(gadget=g)
        self._m_steps = _tm_steps.labels(gadget=g)
        self._m_drops = _tm_drops.labels(gadget=g)
        self._m_harvests = _tm_harvests.labels(gadget=g)
        self._m_h2d = _tm_h2d.labels(gadget=g)
        self._m_update = _tm_update.labels(gadget=g)
        self._m_harvest_s = _tm_harvest_s.labels(gadget=g)
        self._m_qt_events = _tm_qt_events.labels(gadget=g)
        # -- invertible plane and priority classes ---------------------------
        self._inv_on = cfg.invertible
        self._inv_rows = cfg.inv_rows
        self._inv_lb = cfg.inv_log2_buckets
        self._inv_classes: list[tuple[Any, InvSketch]] = []
        if cfg.priority_classes:
            if not self._inv_on:
                raise ParamError(
                    "param 'priority-classes': needs 'invertible true' — "
                    "accuracy classes partition the invertible plane's "
                    "memory budget")
            try:
                cls = parse_priority_classes(cfg.priority_classes)
                validate_class_budget(cls, rows=self._inv_rows, log2_buckets=self._inv_lb)
            except ValueError as e:
                raise ParamError(f"param 'priority-classes': {e}") from None
            self._inv_classes = [(c, inv_init(self._inv_rows, c.log2_buckets, device=self.device))
                                 for c in cls]
        self._overflow_counted = False
        # -- latency quantile plane ------------------------------------------
        self._qt_on = cfg.quantiles
        self._qt_alpha = float(cfg.quantile_alpha)
        self._qt_field = cfg.quantile_field
        self._qt_minv = 1.0  # integer ns/bytes: 0 is the zero bucket, 1 the least magnitude
        if not self._qt_on:
            if self._qt_alpha != 0.01:
                raise ParamError(
                    "param 'quantile-alpha': needs 'quantiles true' — "
                    "the error target configures the DDSketch plane")
            if self._qt_field != "aux1":
                raise ParamError(
                    "param 'quantile-field': needs 'quantiles true' — "
                    "the value lane only exists with the quantile plane")
        elif self._qt_field not in BATCH_COLUMNS:
            raise ParamError(
                f"param 'quantile-field': {self._qt_field!r} is not a "
                f"wire column (one of {', '.join(BATCH_COLUMNS)})")
        # -- planes and configurations ported by later ROADMAP items ---------
        if cfg.shard_ingest or (cfg.chips != "auto" and int(cfg.chips) > 1):
            raise ParamError(
                "param 'shard-ingest'/'chips': sharded ingest over several devices "
                "is not ported yet (ROADMAP item 11); chips=1 is the single-device path")
        if cfg.standing_queries:
            raise ParamError("param 'standing-queries': the standing-query plane is not "
                             "ported yet (ROADMAP item 10c)")
        if cfg.history_compact or cfg.history_archive_dir:
            raise ParamError("param 'history-compact'/'history-archive-dir': the history "
                             "store's lifecycle is not ported yet (ROADMAP item 10c)")
        if cfg.history and ctx.window_sink is None:
            raise ParamError("param 'history': needs a window_sink — the sealed-window "
                             "store is not ported yet (ROADMAP item 10c)")
        # -- accuracy audit plane --------------------------------------------
        self._shadow = self._win_shadow = self._astats = None
        if cfg.audit_sample > 0:
            from ..ops.accuracy import AccuracyStats, ShadowSample
            self._shadow = ShadowSample(cfg.audit_sample)
            self._win_shadow = ShadowSample(cfg.audit_sample)
            self._astats = AccuracyStats(ctx.run_id, g)
        self.bundle = bundle_init(
            depth=cfg.depth, log2_width=cfg.log2_width, hll_p=cfg.hll_p,
            entropy_log2_width=cfg.entropy_log2_width, k=cfg.topk,
            inv_rows=self._inv_rows if self._inv_on else 0,
            inv_log2_buckets=self._inv_lb, quantiles=self._qt_on,
            quantile_alpha=self._qt_alpha, quantile_min_value=self._qt_minv,
            device=self.device)
        # -- anomaly plane ----------------------------------------------------
        self.anomaly_on = cfg.anomaly
        self.anomaly_model = cfg.anomaly_model
        self.scorer = None
        self._container_counts: dict[int, np.ndarray] = {}
        self._container_seqs: dict[int, list[int]] = {}
        self._seq_window = cfg.seq_window
        if self.anomaly_on:
            dim = 1 << cfg.entropy_log2_width
            if self.anomaly_model == "vae":
                self._ae_cfg = VAEConfig(input_dim=dim, hidden_dim=256, latent_dim=64)
                self.scorer = vae_init(self._ae_cfg, device=self.device)
            elif self.anomaly_model == "seq":
                self._ae_cfg = SeqConfig(vocab=min(dim, 512))
                self.scorer = seq_init(self._ae_cfg, device=self.device)
            else:
                self._ae_cfg = AEConfig(input_dim=dim, hidden_dim=256, latent_dim=64)
                self.scorer = ae_init(self._ae_cfg, device=self.device)
        self._drops_seen = 0
        self._last_harvest = time.monotonic()
        self._epoch = 0
        self._names: dict[int, str] = {}
        # host-clock split of the last harvest (ms): digest + device decode,
        # host finisher, anomaly step, seal
        self.last_harvest_ms: dict[str, float] = {}
        # the device batch shape: the gadget's own batch size, rounded up
        pad = 8192
        if ctx.batch_size > 0:
            pad = max(pad, 1 << (ctx.batch_size - 1).bit_length())
        self._pad = pad
        self._h2d_depth = cfg.h2d_depth
        self._pool: PinnedBufferPool | None = None
        self._stager: H2DStager | None = None
        # late enrichment: a rolling sample of (k64, k32, comm) rows, names
        # resolved at harvest and seal
        self._lbl_cap = 1024
        self._lbl_k64 = np.zeros(self._lbl_cap, np.uint64)
        self._lbl_k32 = np.zeros(self._lbl_cap, np.uint32)
        self._lbl_comm = np.zeros((self._lbl_cap, 8), np.uint8)
        self._lbl_i = 0
        self._pstats = PipelineStats(ctx.run_id, g)
        self._pstats.register()
        if self._astats is not None:
            self._astats.register()
        # -- sketch-history plane (sealed windows) ----------------------------
        self._hist_on = cfg.history
        if self._hist_on:
            self._hist_interval = cfg.history_interval or 0.0
            self._hist_max_slices = cfg.history_max_slices
            self._hist_gadget = ctx.history_gadget or g
            self._hist_clock = ctx.history_clock or time.time
            self._wcms = wcms_init(n_slots=cfg.history_slots, depth=cfg.depth,
                                   log2_width=cfg.history_log2_width, device=self.device)
            self._win_hll = hll_init(cfg.hll_p, device=self.device)
            self._win_n = 0
            self._win_start = self._hist_clock()
            self._win_slices: dict[str, Any] = {}
            self._win_slices_dropped_keys: set[str] = set()
        self._ckpt_key = g.replace("/", "-")
        self._resume()
        if self._hist_on:
            # window-open baselines after resume: window deltas exclude the
            # prior state the merge just absorbed
            self._win_events0 = float(self.bundle.events)
            self._win_drops0 = float(self.bundle.drops)
            self._win_ent0 = self._ent_host(self.bundle)
            self._win_inv0 = self._inv_host(self.bundle)
            self._win_qt0 = self._qt_host(self.bundle)
        with _live_mu:
            _live[ctx.run_id] = self

    def _note_watermarks(self, pop_ts: float, oldest_ts: float) -> None:
        """Batch-grain lag watermarks: host lag = pop − oldest event,
        device lag = dispatch (now) − pop. Unstamped batches read as zero
        lag."""
        now = time.time()
        if pop_ts <= 0.0:
            pop_ts = now
        if oldest_ts <= 0.0 or oldest_ts > pop_ts:
            oldest_ts = pop_ts
        self._pstats.note_host_lag(pop_ts - oldest_ts)
        self._pstats.note_device_lag(max(now - pop_ts, 0.0))

    # -- host snapshots (copies: on the CPU .numpy() is the live state) ------

    @staticmethod
    def _ent_host(b) -> np.ndarray:
        return b.entropy.counts.cpu().numpy().astype(np.float32, copy=True)

    @staticmethod
    def _inv_host(b) -> tuple | None:
        """(count int64, keysum uint32, fpsum uint32) of the bundle's
        invertible lanes: the window-open baseline for seal deltas.
        Caller holds _bundle_mu for the live bundle."""
        if b.inv is None:
            return None
        return (b.inv.count.cpu().numpy().astype(np.int64, copy=True),
                _lane_np(b.inv.keysum), _lane_np(b.inv.fpsum))

    @staticmethod
    def _qt_host(b) -> tuple | None:
        """(counts int64, zeros, total) of the bundle's DDSketch lanes."""
        if b.quantiles is None:
            return None
        q = b.quantiles
        return (q.counts.cpu().numpy().astype(np.int64, copy=True),
                int(q.zeros), int(q.total))

    # -- per-batch helpers ---------------------------------------------------

    def _qt_value_lane(self, batch: EventBatch, block: np.ndarray, n: int) -> np.ndarray:
        """Fill the block's value lane (row 4) from the configured wire
        column, saturating at 2**32 - 1 so magnitudes past it land in the
        top buckets instead of wrapping into the small ones."""
        vals = block[4]
        raw = batch.cols[self._qt_field][:n].astype(np.uint64, copy=False)
        vals[:n] = np.minimum(raw, np.uint64(0xFFFFFFFF)).astype(np.uint32)
        vals[n:] = 0
        return vals

    def _qt_count(self, vals_np: np.ndarray | None, n: int) -> None:
        if not self._qt_on:
            return
        self._m_qt_events.inc(n)
        z = n if vals_np is None else int(n - np.count_nonzero(vals_np[:n]))
        if z > 0:
            _tm_qt_zero.inc(z)

    def _shadow_feed(self, keys: np.ndarray, weights: np.ndarray | None = None) -> None:
        """The batch's real rows into the run and window shadow samples
        (host numpy; ShadowSample copies what it keeps)."""
        if self._shadow is None:
            return
        self._shadow.update(keys, weights)
        self._win_shadow.update(keys, weights)
        self._astats.note_fed(int(np.asarray(keys).size))

    @staticmethod
    def _padded_mntns(batch: EventBatch, n: int, pad: int) -> np.ndarray:
        out = np.zeros(pad, dtype=np.uint64)
        out[:n] = batch.cols["mntns"][:n]
        return out

    def _inv_class_absorb(self, keys_d: torch.Tensor, mntns_np: np.ndarray,
                          w_np: np.ndarray) -> None:
        """One `inv_update` for each priority class whose share of the
        batch has a nonzero weight. The keys are the staged lane on the
        device; the per-class weights are host tenant masks, copied over.
        Caller holds _bundle_mu."""
        if not self._inv_classes:
            return
        wts = class_weights([c for c, _ in self._inv_classes], mntns_np, w_np)
        for (_, s), w_c in zip(self._inv_classes, wts):
            if w_c.any():
                inv_update(s, keys_d, _to_device(w_c, self.device))

    def _fence(self, stager: H2DStager, token) -> None:
        """Tie the staged block's release to every consumer of its arrays:
        on the card one CUDA event after the bundle step, the window steps
        and the class updates; on the CPU they have run when this is
        called, and the bundle step's token stands for them."""
        if self.device.type == "cuda":
            token = torch.cuda.Event()
            token.record(torch.cuda.current_stream(self.device))
        stager.fence(token)

    def _staging_for(self, pad: int) -> tuple[PinnedBufferPool, H2DStager]:
        """The pinned pool and stager for the pad shape: 4 lanes (up to
        three key columns and the weights), 5 with the quantile plane's
        value lane. A pad growth drains the old stager first."""
        if self._pool is None or self._pool.capacity != pad:
            if self._stager is not None:
                self._stager.drain()
            self._pool = PinnedBufferPool(pad, lanes=5 if self._qt_on else 4,
                                          max_free=self._h2d_depth + 2, device=self.device)
            self._stager = H2DStager(self._pool, depth=self._h2d_depth, device=self.device,
                                     stats=self._pstats)
        self._pad = max(self._pad, pad)
        return self._pool, self._stager

    def _after_batch(self) -> None:
        """The interval seal and the timed harvest."""
        if self._hist_on and self._hist_interval > 0 and \
                self._hist_clock() - self._win_start >= self._hist_interval:
            self.seal_window()
        now = time.monotonic()
        if now - self._last_harvest >= self.harvest_interval:
            self._last_harvest = now
            self.harvest()

    # -- the columnar hot path ------------------------------------------------

    def enrich_batch(self, batch: EventBatch) -> None:
        if batch.count == 0:
            return
        n = batch.count
        pad = self._pad
        while pad < n:
            pad *= 2
        t0 = time.perf_counter()
        with record_function("tpusketch/h2d"):
            pool, stager = self._staging_for(pad)
            block = pool.get()
            arr = block.numpy()
            rows: dict[str, int] = {}

            def keys_for(colname: str) -> np.ndarray:
                r = rows.get(colname)
                if r is None:
                    r = rows[colname] = len(rows)
                    lane, a = arr[r], batch.cols[colname][:n]
                    lane[:n] = fold64_to_32(a) if a.dtype == np.uint64 else a
                    lane[n:] = 0
                return arr[r]

            hh = keys_for(self.hh_col)
            distinct = keys_for(self.distinct_col)
            dist = keys_for(self.dist_col)
            w = arr[3]
            w[:n] = 1
            w[n:] = 0
            vals = self._qt_value_lane(batch, arr, n) if self._qt_on else None
            new_drops = batch.drops - self._drops_seen
            self._drops_seen = batch.drops
            # one copy per distinct lane: shared columns stage once
            order = list(rows.values()) + [3] + ([4] if vals is not None else [])
            staged = stager.stage(block, [block[r] for r in order])
            by_row = dict(zip(order, staged))
            hh_d = by_row[rows[self.hh_col]]
            distinct_d = by_row[rows[self.distinct_col]]
            dist_d = by_row[rows[self.dist_col]]
            w_d = by_row[3]
            v_d = by_row.get(4) if vals is not None else None
        t1 = time.perf_counter()
        with record_function("tpusketch/update"), record_function("ig:tpusketch_update"):
            with self._bundle_mu:
                _, tok = bundle_ingest_step(self.bundle, hh_d, distinct_d, dist_d, w_d,
                                            float(max(new_drops, 0)), v_d)
            if self._hist_on:
                wcms_ingest_step(self._wcms, hh_d, w_d)
                hll_ingest_step(self._win_hll, distinct_d, w_d)
                self._accumulate_slices(batch, n, hh, distinct, dist)
            if self._inv_classes:
                with self._bundle_mu:
                    self._inv_class_absorb(hh_d, self._padded_mntns(batch, n, len(hh)), w)
            self._fence(stager, tok)
        t2 = time.perf_counter()
        self._m_h2d.observe(t1 - t0)
        self._m_update.observe(t2 - t1)
        self._m_events.inc(n)
        self._m_steps.inc()
        self._qt_count(vals, n)
        if new_drops > 0:
            self._m_drops.inc(new_drops)
        oldest = batch.oldest_ts
        if oldest <= 0.0:
            tmin = float(batch.cols["ts"][:n].min())
            if tmin > 0.0:
                oldest = tmin / 1e9
        self._note_watermarks(batch.pop_ts, oldest)
        self._shadow_feed(hh[:n])
        self._label_sample(batch, hh, n)
        if self.anomaly_on:
            self._accumulate_container_dists(batch, n)
        self._after_batch()

    def ingest_folded(self, fb: FoldedBatch) -> None:
        """Ingest of a pre-folded batch popped into a `folded_block()`
        (``pop_folded``): the one keys lane feeds all three sketch
        streams. The stager returns the block to this instance's pool
        once the step's fence completes. Sealed windows carry no slices
        and the anomaly plane sees nothing on this path (no kind or
        per-event mntns columns), as in the reference."""
        if fb.count == 0:
            return
        n = fb.count
        t0 = time.perf_counter()
        with record_function("tpusketch/h2d"):
            _pool, stager = self._staging_for(fb.capacity)
            block = fb.block if fb.block is not None else torch.from_numpy(fb.lanes)
            fvals = fb.values if self._qt_on else None
            if n < fb.capacity:
                fb.keys[n:] = 0
                fb.weights[n:] = 0
                if fvals is not None:
                    fvals[n:] = 0
            new_drops = fb.drops - self._drops_seen
            self._drops_seen = fb.drops
            if fvals is not None:
                k_d, w_d, v_d = stager.stage(block, (block[0], block[1], block[3]))
            else:
                (k_d, w_d), v_d = stager.stage(block, (block[0], block[1])), None
        t1 = time.perf_counter()
        with record_function("tpusketch/update"), record_function("ig:tpusketch_update"):
            with self._bundle_mu:
                # without a value lane the step zero-fills: every event lands
                # in the zero bucket and totals stay honest
                _, tok = bundle_ingest_step(self.bundle, k_d, k_d, k_d, w_d,
                                            float(max(new_drops, 0)), v_d)
            if self._hist_on:
                wcms_ingest_step(self._wcms, k_d, w_d)
                hll_ingest_step(self._win_hll, k_d, w_d)
            if self._inv_classes:
                with self._bundle_mu:
                    self._inv_class_absorb(k_d, fb.mntns, fb.weights)
            self._fence(stager, tok)
        t2 = time.perf_counter()
        self._m_h2d.observe(t1 - t0)
        self._m_update.observe(t2 - t1)
        self._m_events.inc(n)
        self._m_steps.inc()
        self._qt_count(fvals, n)
        if new_drops > 0:
            self._m_drops.inc(new_drops)
        self._note_watermarks(fb.pop_ts, fb.oldest_ts)
        # folded batches carry real integer weights: the shadow honours them
        self._shadow_feed(fb.keys[:n], fb.weights[:n])
        self._after_batch()

    def folded_block(self) -> torch.Tensor:
        """A pinned (4+, pad) staging block for ``pop_folded``: rows 0-2
        are the keys, weights and mntns lanes; row 3 is the value lane when
        popped with ``with_values=True``."""
        pool, _ = self._staging_for(self._pad)
        return pool.get()

    # -- late enrichment (off the ingest path) --------------------------------

    def _label_sample(self, batch: EventBatch, hh: np.ndarray, n: int) -> None:
        """Park up to 64 (k64, k32, comm) rows a batch in the rolling ring."""
        s = min(n, 64)
        raw = batch.cols[self.hh_col][:s]
        # only real 64-bit key hashes resolve through the vocab; other
        # columns park 0 and resolve through comm
        is_hash = raw.dtype == np.uint64
        cap, i = self._lbl_cap, self._lbl_i
        first = min(s, cap - i)
        self._lbl_k32[i:i + first] = hh[:first]
        self._lbl_k64[i:i + first] = raw[:first] if is_hash else 0
        self._lbl_comm[i:i + first] = batch.comm[:first] if batch.comm is not None else 0
        rem = s - first
        if rem:
            self._lbl_k32[:rem] = hh[first:s]
            self._lbl_k64[:rem] = raw[first:s] if is_hash else 0
            self._lbl_comm[:rem] = batch.comm[first:s] if batch.comm is not None else 0
        self._lbl_i = (i + s) % cap

    def _resolve_late(self, keys32) -> None:
        """Display names for (few) heavy-hitter keys from the sample ring,
        once a harvest or seal. A key absent from the ring stays
        unresolved (it may be sampled later); one found without a name
        caches its hex form."""
        resolve = self.ctx.resolve_key
        for k in keys32:
            k = int(k)
            if not k or k in self._names:
                continue
            j = np.flatnonzero(self._lbl_k32 == np.uint32(k))
            if not j.size:
                continue
            jj = int(j[0])
            k64 = int(self._lbl_k64[jj])
            name = ""
            if resolve is not None and k64:
                name = resolve(k64) or ""
            if not name:
                comm = bytes(self._lbl_comm[jj])
                name = comm.split(b"\0", 1)[0].decode("utf-8", "replace")
            self._names[k] = name or f"0x{k:08x}"

    def _accumulate_container_dists(self, batch: EventBatch, n: int) -> None:
        mntns = batch.cols["mntns"][:n]
        keys = batch.cols[self.dist_col][:n]
        if self.anomaly_model == "seq":
            # per-container token sequences (order matters) for the LM
            toks = tokens_from_keys(keys, self._ae_cfg.vocab)
            w = self._seq_window
            for ns in np.unique(mntns):
                seq = self._container_seqs.setdefault(int(ns), [])
                seq.extend(int(t) for t in toks[mntns == ns])
                if len(seq) > w:
                    del seq[:-w]
            return
        dim = self._ae_cfg.input_dim
        buckets = (keys % np.uint64(dim)).astype(np.int64)
        for ns in np.unique(mntns):
            sel = mntns == ns
            vec = self._container_counts.setdefault(int(ns), np.zeros(dim, dtype=np.float32))
            np.add.at(vec, buckets[sel], 1.0)

    def _seq_score_containers(self) -> dict[int, float] | None:
        """One training step of the sequence LM on every container window
        with 4 tokens or more, then each one's mean next-token NLL
        (``attn="full"``, as the reference's default)."""
        ready = {ns: s for ns, s in self._container_seqs.items() if len(s) >= 4}
        if not ready:
            return None
        mat, _ = seq_window_matrix(ready.values(), self._seq_window)
        toks = torch.from_numpy(mat).to(self.device)
        self.scorer, _ = seq_train_step(self.scorer, toks, "full")
        scores = seq_score(self.scorer, toks, "full").float().cpu().numpy()
        return {ns: float(s) for ns, s in zip(ready.keys(), scores)}

    def _score_containers(self) -> dict[int, float] | None:
        if self.anomaly_on and self.anomaly_model == "seq":
            return self._seq_score_containers()
        if not (self.anomaly_on and self._container_counts):
            return None
        mats = np.stack(list(self._container_counts.values()))
        x = normalize_counts(torch.from_numpy(mats).to(self.device))
        if self.anomaly_model == "vae":
            self.scorer, _ = vae_train_step(self.scorer, x)
            scores = vae_score(self.scorer, x)
        else:
            self.scorer, _ = ae_train_step(self.scorer, x)
            scores = ae_score(self.scorer, x)
        scores = scores.float().cpu().numpy()
        return {ns: float(s) for ns, s in zip(self._container_counts.keys(), scores)}

    # -- sealed windows ------------------------------------------------------

    def _accumulate_slices(self, batch: EventBatch, n: int, hh: np.ndarray,
                           distinct: np.ndarray, dist: np.ndarray) -> None:
        """Subpopulation slices of the open window: per mntns, per kind,
        and mntns × kind, each a small host sketch, at most
        history_max_slices of them (the rest are counted as dropped)."""
        from ..history import SliceSketch
        mntns = batch.cols["mntns"][:n]
        kind = batch.cols["kind"][:n]
        hh_n, distinct_n, dist_n = hh[:n], distinct[:n], dist[:n]

        def feed(key: str, sel: np.ndarray) -> None:
            s = self._win_slices.get(key)
            if s is None:
                if len(self._win_slices) >= self._hist_max_slices:
                    self._win_slices_dropped_keys.add(key)
                    return
                s = self._win_slices[key] = SliceSketch()
            s.update(hh_n[sel], distinct_n[sel], dist_n[sel])

        for ns in np.unique(mntns):
            sel = mntns == ns
            feed(f"mntns:{int(ns)}", sel)
            for k in np.unique(kind[sel]):
                feed(f"mntns:{int(ns)}|kind:{int(k)}", sel & (kind == k))
        for k in np.unique(kind):
            feed(f"kind:{int(k)}", kind == k)

    def seal_window(self) -> None:
        """Seal the open window and hand it to the window sink. A window
        with no events and no slices is skipped. The window's count-min is
        the ring's current slot and its HLL the window HLL; entropy,
        events, drops and the invertible and DDSketch lanes are deltas of
        the cumulative bundle (pure adds, so the subtraction is exact,
        uint32 wrap included)."""
        from ..history import SealedWindow, encode_window, window_digest
        end = self._hist_clock()
        with self._bundle_mu:
            b = self.bundle
            events = float(b.events)
            drops = float(b.drops)
            ent_now = self._ent_host(b)
            cand = _lane_np(b.topk.keys)
            # the candidate-overflow latch crosses the seal boundary
            overflow = bool(int(b.topk.overflow))
            inv_now = self._inv_host(b)
            qt_now = self._qt_host(b)
        win_events = int(events - self._win_events0)
        if win_events <= 0 and not self._win_slices:
            self._win_start = end
            return
        epoch = int(self._wcms.epoch)
        cms = self._wcms.slots[epoch].cpu().numpy().astype(np.int32, copy=True)
        counts = wcms_query(self._wcms, _to_device(cand, self.device), last_k=1)
        counts = counts.cpu().numpy().astype(np.int64)
        order = np.argsort(-counts)
        keep = [(int(cand[i]), int(counts[i])) for i in order if cand[i] != 0 and counts[i] > 0]
        self._resolve_late([k for k, _ in keep[:32]])
        self._win_n += 1
        kw: dict[str, Any] = {}
        if inv_now is not None and self._win_inv0 is not None:
            kw.update(inv_count=(inv_now[0] - self._win_inv0[0]).astype(np.int32),
                      inv_keysum=inv_now[1] - self._win_inv0[1],
                      inv_fpsum=inv_now[2] - self._win_inv0[2])
        if qt_now is not None and self._win_qt0 is not None:
            kw.update(qt_counts=(qt_now[0] - self._win_qt0[0]).astype(np.int32),
                      qt_zeros=int(qt_now[1] - self._win_qt0[1]),
                      qt_total=int(qt_now[2] - self._win_qt0[2]),
                      qt_alpha=float(self._qt_alpha), qt_min_value=float(self._qt_minv))
        if self._win_shadow is not None:
            kw.update(rs_keys=self._win_shadow.keys.copy(),
                      rs_weights=self._win_shadow.weights.copy(),
                      rs_capacity=int(self._win_shadow.capacity))
        win = SealedWindow(
            gadget=self._hist_gadget, node=self.ctx.node, run_id=self.ctx.run_id,
            window=self._win_n, start_ts=float(self._win_start), end_ts=float(end),
            events=win_events, drops=int(drops - self._win_drops0),
            cms=cms,
            hll=self._win_hll.registers.cpu().numpy().astype(np.int32, copy=True),
            ent=(ent_now - self._win_ent0).astype(np.float32),
            topk_keys=np.array([k for k, _ in keep], dtype=np.uint32),
            topk_counts=np.array([c for _, c in keep], dtype=np.int64),
            slices={key: {"events": s.events, "hll": s.hll, "ent": s.ent, "hh": s.sealed_hh()}
                    for key, s in self._win_slices.items()},
            names={k: self._names[k] for k, _ in keep if k in self._names},
            slices_dropped=len(self._win_slices_dropped_keys),
            approx=overflow, **kw)
        win.digest = window_digest(win)
        try:
            with record_function("tpusketch/seal-window"):
                self.ctx.window_sink(*encode_window(win))
        except (OSError, ValueError) as e:
            _log.warning("window seal failed (window %d was dropped): %r", self._win_n, e)
        else:
            hook = self.ctx.on_window_sealed
            if hook is not None:
                try:
                    hook({"gadget": win.gadget, "window": win.window,
                          "start_ts": win.start_ts, "end_ts": win.end_ts,
                          "events": win.events, "drops": win.drops, "digest": win.digest})
                except Exception as he:  # noqa: BLE001 — announce only
                    _log.warning("window announce failed: %r", he)
        # open the next window: rotate the ring, fresh HLL, new baselines
        wcms_advance(self._wcms)
        self._win_hll.registers.zero_()
        self._win_start = end
        self._win_events0 = events
        self._win_drops0 = drops
        self._win_ent0 = ent_now
        self._win_inv0 = inv_now
        self._win_qt0 = qt_now
        if self._win_shadow is not None:
            self._win_shadow.reset()
        self._win_slices = {}
        self._win_slices_dropped_keys = set()

    # -- harvest ---------------------------------------------------------------

    def harvest(self) -> SketchSummary:
        with record_function("tpusketch/harvest"), record_function("ig:tpusketch_harvest"):
            return self._harvest_traced()

    def _harvest_traced(self) -> SketchSummary:
        t0 = time.perf_counter()
        # one packed digest, read in one device-to-host copy; the decode's
        # device loop is queued before that copy, so the copy's wait is
        # the loop's time too
        inv_dev = qt_now = None
        with self._bundle_mu:
            digest = bundle_digest(self.bundle)
            if self._inv_on and self.bundle.inv is not None:
                cap = min(4096, inv_capacity(self._inv_rows, self._inv_lb))
                inv_dev = inv_decode_device(self.bundle.inv, sweeps=2, cap=cap)
            if self._qt_on and self.bundle.quantiles is not None:
                qt_now = self._qt_host(self.bundle)
            if self._inv_classes:
                cls_snap = [(c, (s.count.cpu().numpy().astype(np.int64, copy=True),
                                 _lane_np(s.keysum), _lane_np(s.fpsum)))
                            for c, s in self._inv_classes]
        events_f, drops_f, distinct, entropy_bits, approx, keys, counts = (
            decode_digest(digest.cpu().numpy()))
        t1 = time.perf_counter()
        if approx and not self._overflow_counted:
            self._overflow_counted = True
            _tm_cand_overflow.labels(gadget=self.ctx.gadget).inc()
        order = np.argsort(-counts)
        hh = [(int(keys[i]), int(counts[i])) for i in order if keys[i] != 0]
        decoded: list[tuple[int, int]] = []
        decoded_only: list[tuple[int, int]] = []
        inv_info = classes_out = None
        if inv_dev is not None:
            dec = inv_decode_finish(*inv_dev)
            decoded = dec.keys
            ring = {k for k, _ in hh}
            decoded_only = [(k, c) for k, c in dec.keys if k not in ring]
            inv_info = {"recovered": dec.recovered, "complete": dec.complete,
                        "residual_events": dec.residual_events,
                        "capacity": inv_capacity(self._inv_rows, self._inv_lb)}
            if self._inv_classes:
                classes_out = {}
                for c, arrs in cls_snap:
                    cdec = inv_decode(arrs)
                    classes_out[c.name] = {
                        "tenants": list(c.tenants) if c.tenants is not None else "*",
                        "log2_buckets": c.log2_buckets,
                        "capacity": inv_capacity(self._inv_rows, c.log2_buckets),
                        "decoded": cdec.top(32),
                        "recovered": cdec.recovered,
                        "complete": cdec.complete,
                        "residual_events": cdec.residual_events,
                    }
        qt_out = None
        if qt_now is not None:
            from ..ops.quantiles import dd_quantile_np
            c, z, t = qt_now
            ps = (dd_quantile_np(c, z, t, [0.50, 0.90, 0.99, 0.999], alpha=self._qt_alpha,
                                 min_value=self._qt_minv) if t > 0 else np.zeros(4))
            qt_out = {"p50": float(ps[0]), "p90": float(ps[1]), "p99": float(ps[2]),
                      "p999": float(ps[3]), "zeros": int(z), "total": int(t),
                      "underflow": int(c[0]), "alpha": float(self._qt_alpha)}
        # the reference's per-stage spans carry the snapshot's watermarks as
        # span attributes: they wait for the span tree (ROADMAP 10b)
        pipe_out = self._pstats.snapshot()
        acc_out = None
        if self._shadow is not None:
            from ..ops.accuracy import accuracy_block
            b = self.bundle
            acc_out = accuracy_block(
                events=float(events_f), depth=b.cms.depth, width=1 << b.cms.log2_width,
                hll_p=b.hll.p, ent_log2_width=b.entropy.log2_width,
                distinct=float(distinct), entropy_bits=float(entropy_bits),
                hh_keys=np.array([k for k, _ in hh], dtype=np.uint32),
                hh_counts=np.array([c for _, c in hh], dtype=np.int64),
                qt_alpha=float(self._qt_alpha) if self._qt_on else None,
                shadow=self._shadow)
            self._astats.observe_block(acc_out)
        self._resolve_late([k for k, _ in hh[:32]])
        t2 = time.perf_counter()
        anomaly = self._score_containers()
        t3 = time.perf_counter()
        self._epoch += 1
        summary = SketchSummary(
            events=int(events_f), drops=int(drops_f), distinct=distinct,
            entropy_bits=entropy_bits, heavy_hitters=hh, anomaly=anomaly, epoch=self._epoch,
            names={k: self._names[k] for k, _ in hh if k in self._names}, approx=approx,
            decoded=decoded, decoded_only=decoded_only, inv=inv_info, classes=classes_out,
            quantiles=qt_out, pipeline=pipe_out, accuracy=acc_out)
        cb = self.ctx.on_sketch_summary
        if cb is not None:
            cb(summary)
        self._m_harvests.inc()
        self._m_harvest_s.observe(time.perf_counter() - t0)
        t4 = time.perf_counter()
        if self._hist_on and self._hist_interval <= 0:
            # history-interval 0: one sealed window a harvest (the replay mode)
            self.seal_window()
        t5 = time.perf_counter()
        self.last_harvest_ms = {"digest_decode": (t1 - t0) * 1e3, "finish": (t2 - t1) * 1e3,
                                "anomaly": (t3 - t2) * 1e3, "seal": (t5 - t4) * 1e3,
                                "total": (t5 - t0) * 1e3}
        return summary

    def post_gadget_run(self) -> None:
        """Teardown: the final harvest (none in a replay, which harvests
        only at recorded boundaries) and the final partial window, the
        stager drained, the stats unregistered, the shutdown checkpoint."""
        if not self.ctx.replay:
            self.harvest()
        if self._hist_on:
            self.seal_window()
        if self._stager is not None:
            self._stager.drain()
        self._pstats.unregister()
        if self._astats is not None:
            self._astats.unregister()
        if _ckpt_dir is not None:
            _checkpoint_logged(self)
        with _live_mu:
            _live.pop(self.ctx.run_id, None)

    # -- checkpoint/resume -----------------------------------------------------

    def _scorer_path(self, base: Path) -> Path:
        return Path(str(base) + "-scorer")

    def _resume(self) -> None:
        """Merge a prior checkpoint (either package's) into the fresh
        state. A missing file means fresh state; one that exists but does
        not load (torn, another configuration) is logged as a warning."""
        if _ckpt_dir is None:
            return
        from ..utils.checkpoint import load_pytree
        base = _ckpt_dir / self._ckpt_key
        try:
            with record_function("tpusketch/resume"):
                prior = load_pytree(base, like=bundle_to_numpy(self.bundle))
                t0 = time.perf_counter()
                self.bundle = bundle_merge(self.bundle, bundle_from_numpy(
                    prior, quantile_alpha=self._qt_alpha,
                    quantile_min_value=self._qt_minv, device=self.device))
                _tm_merge_s.observe(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001
            log_fn = _log.warning if base.with_suffix(".npz").exists() else _log.debug
            log_fn("resume of %s skipped (fresh state): %r", self._ckpt_key, e)
        if self.scorer is not None:
            try:
                scorer_from_leaves(self.scorer, load_pytree(self._scorer_path(base)))
            except Exception as e:  # noqa: BLE001
                _log.debug("scorer resume of %s skipped: %r", self._ckpt_key, e)
        if self._inv_classes:
            cls_base = Path(str(base) + "-invclasses")
            try:
                like = [x for _, s in self._inv_classes for x in self._inv_leaves(s)]
                prior = load_pytree(cls_base, like=like)
                merged = []
                for i, (c, s) in enumerate(self._inv_classes):
                    cnt, ks, fs = prior[3 * i:3 * i + 3]
                    p = InvSketch(count=torch.from_numpy(cnt).to(self.device),
                                  keysum=torch.from_numpy(ks.astype(np.int64)).to(self.device),
                                  fpsum=torch.from_numpy(fs.astype(np.int64)).to(self.device),
                                  log2_buckets=s.log2_buckets)
                    merged.append((c, inv_merge(s, p)))
                self._inv_classes = merged
            except Exception as e:  # noqa: BLE001
                log_fn = _log.warning if cls_base.with_suffix(".npz").exists() else _log.debug
                log_fn("class resume of %s skipped (fresh class state): %r", self._ckpt_key, e)

    @staticmethod
    def _inv_leaves(s: InvSketch) -> list[np.ndarray]:
        """An InvSketch's leaves as the reference flattens it."""
        return [s.count.cpu().numpy().astype(np.int32, copy=True), _lane_np(s.keysum),
                _lane_np(s.fpsum)]

    def checkpoint(self) -> None:
        """Save the bundle, the scorer and the priority classes. The
        host snapshot is taken under _bundle_mu; the file writes run
        outside it."""
        if _ckpt_dir is None:
            return
        from ..utils.checkpoint import save_pytree
        base = _ckpt_dir / self._ckpt_key
        with record_function("tpusketch/checkpoint"), record_function("ig:tpusketch_checkpoint"):
            with self._bundle_mu:
                bundle_host = bundle_to_numpy(self.bundle)
                scorer_host = scorer_leaves(self.scorer) if self.scorer is not None else None
                classes_host = ([x for _, s in self._inv_classes for x in self._inv_leaves(s)]
                                if self._inv_classes else None)
            save_pytree(base, bundle_host)
            if scorer_host is not None:
                save_pytree(self._scorer_path(base), scorer_host)
            if classes_host is not None:
                save_pytree(Path(str(base) + "-invclasses"), classes_host)

    # -- display ---------------------------------------------------------------

    def heavy_hitter_rows(self, resolve: Callable[[int], str] | None = None,
                          k: int = 20) -> list[HeavyHitterRow]:
        with self._bundle_mu:
            b = self.bundle
            total = max(float(b.events), 1.0)
            keys = _lane_np(b.topk.keys)
            counts = b.topk.counts.cpu().numpy().copy()
        rows = []
        for i in np.argsort(-counts)[:k]:
            if keys[i] == 0:
                continue
            name = resolve(int(keys[i])) if resolve else f"0x{int(keys[i]):08x}"
            rows.append(HeavyHitterRow(key=name or f"0x{int(keys[i]):08x}",
                                       count=int(counts[i]),
                                       share=float(counts[i]) / total))
        return rows
