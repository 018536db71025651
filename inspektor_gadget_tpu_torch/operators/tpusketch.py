"""The tpusketch operator on one device (PyTorch port of
``inspektor_gadget_tpu/operators/tpusketch.py``: `TpuSketch`,
`TpuSketchInstance`).

Event batches flow into a per-run `SketchBundle` on the device
(count-min, HLL, entropy, top-k, and optionally the invertible and
DDSketch planes) through the staged ingest step (K2 on the card). A
harvest reads the bundle back in one digest, decodes the invertible
plane, reads the quantiles, audits the estimates against a shadow
sample and scores every container with the anomaly scorer. With the
history plane on, a seal cuts one mergeable window out of the
cumulative state and appends it to the node's sealed-window store
(`history.HISTORY`), whose bytes are the reference's; standing queries
fold each appended window, and the store's compaction and archive tiers
run where the params ask. Checkpoints are the reference's files, so
either package resumes the other's bundle.

The gadget framework builds an instance as the reference does:
`TpuSketch.instance_params` holds the reference's 38 instance params,
and ``TpuSketchInstance(op, ctx, gadget, params)`` reads them and the
`GadgetContext` (its ``device``, and ``extra``'s hooks, read live). The
same instance can be built without the framework from a `SketchConfig`
(the params, ``-`` written ``_``) and a `SketchContext` (what it reads
from the gadget context): ``TpuSketchInstance(config, context,
device=...)``. Both routes validate through the same `ParamDesc`
validators and the reference's cross-param checks.

With ``shard-ingest true`` and ``chips`` of 2 or more, the staged ingest
runs on that many device lanes (`_lane_devices`, every card by default):
batch i lands on lane i mod chips, through that lane's own pinned pool
and stager, and a round of one batch a lane runs one K2 a lane
(`ops.sketches.make_bundle_ingest_sharded`); every read of the state
(harvest, seal, checkpoint, display) merges the lanes first
(`cluster_merge`), bit-identical to the one-device fold of the same
stream. The window plane stays on the instance's device. ``chips=1`` is
the exact unsharded path, and ``IG_SHARD_DISABLE=1`` forces it.

The reference donates its bundle to each step; the port updates it in
place under ``_bundle_mu``, and every host snapshot that must outlive
the next step is a copy (on the CPU a tensor's ``.numpy()`` is the
live state). Spans are the reference's `TRACER` spans under the run
span (each a ``torch.profiler`` range while a profiler records), but
that the gadget path's batch is tiled finer: ``tpusketch/h2d`` holds
``tpusketch/fold`` and ``tpusketch/copy``, then come
``tpusketch/update`` and ``tpusketch/post``; the harvest's parts are
``tpusketch/harvest/{dispatch,wait,read,finish,anomaly}``. The unsharded
``tpusketch/update`` carries ``graph``, how the step ran: a CUDA graph's
"replay" or "capture", or "eager" (`ops.sketches.bundle_ingest_step`).
On the card each gadget-path batch's fence event is a timing event:
once it has completed, its completion less the host's dispatch end,
mapped onto the host clock by an anchor event taken when the instance
is built and re-taken at every harvest, is the batch's device lag (the
pipeline's ``device`` stage).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..gadgets.context import GadgetContext
from ..gadgets.interface import GadgetDesc
from ..history import (DEFAULT_SCHEDULE, HISTORY, HISTORY_METRICS, CompactionEngine,
                       SealedWindow, encode_window, validate_schedule, window_digest)
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
                            bundle_merge, bundle_stack_sharded, bundle_to_numpy, decode_digest,
                            make_bundle_harvest_sharded, make_bundle_ingest_sharded)
from ..ops.window import hll_ingest_step, wcms_advance, wcms_ingest_step, wcms_init, wcms_query
from ..parallel.mesh import ingest_mesh, local_devices
from ..params import ParamDesc, ParamDescs, ParamError, Params, TypeHint
from ..params.validators import validate_int_range
from ..queries import QueryError, StandingQueryEngine, load_queries, load_queries_file
from ..queries import engine as queries_engine
from ..sources.batch import BATCH_COLUMNS, EventBatch, FoldedBatch
from ..sources.staging import H2DStager, PinnedBufferPool
from ..telemetry import counter, histogram
from ..telemetry.pipeline import PipelineStats
from ..telemetry.tracing import TRACER, SpanContext
from ..utils.logger import get_logger
from .operators import Operator, OperatorInstance, register

_log = get_logger("ig-tpu.tpusketch")

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
                       "host dispatch of the step", ("gadget",))
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

# the per-batch parts a harvest record sums over the batches since the
# harvest before it (ms, but the count)
_BATCH_PARTS = ("batches", "fold", "copy", "dispatch", "post", "device_lag")
_STAMPS_MAX = 256  # parked completion stamps before a hot-path booking


# -- the params layer: one copy of each rule, for both construction routes ----

def _validate_chips(value: str) -> None:
    """`chips` is 'auto' or a positive int."""
    if value == "auto":
        return
    try:
        v = int(value)
    except ValueError:
        raise ValueError(f"{value!r} is not an integer or 'auto'") from None
    if v < 1:
        raise ValueError(f"chips must be >= 1, got {v}")


def _lane_devices(chips: int | None, device: torch.device) -> list[torch.device]:
    """The devices the sharded ingest lanes run on, lane k on the k-th:
    every local card for a CUDA instance, the one CPU for a CPU instance;
    the first `chips` of them (all for None). Module-level, so that tests
    pin a topology, lanes sharing a device included."""
    devs = local_devices() if device.type == "cuda" else [torch.device("cpu")]
    return devs if chips is None else devs[:chips]


def _local_device_count(device: torch.device) -> int:
    """Devices visible to the sharded ingest plane."""
    return len(_lane_devices(None, device))


def _validate_priority_classes(value: str) -> None:
    """Grammar only: the budget needs inv-rows and inv-log2-buckets and is
    checked at instantiation."""
    parse_priority_classes(value)


def _validate_quantile_alpha(value: str) -> None:
    """The DDSketch relative-error target: a float in (0, 0.3]."""
    try:
        v = float(value)
    except ValueError:
        raise ValueError(f"{value!r} is not a float") from None
    if not (0.0 < v <= 0.3):
        raise ValueError(f"quantile-alpha must be in (0, 0.3], got {v}")


@dataclasses.dataclass
class SketchConfig:
    """The instance params the sketch plane runs on (``-`` written
    ``_``), with the reference's defaults; durations are seconds."""

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
    history_dir: str = ""
    history_log2_width: int = 12
    history_slots: int = 8
    history_max_slices: int = 256
    history_compact: bool = False
    history_schedule: str = DEFAULT_SCHEDULE
    history_archive_dir: str = ""
    history_archive_cache_bytes: int = 64 << 20
    standing_queries: str = ""
    query_cache_bytes: int = 8 << 20
    query_refresh: int = 1
    query_max_range: float = 86400.0

    def validate(self) -> None:
        """Set every field on the params layer, which runs the
        `ParamDesc` checks (possible values, validators, type hints) and
        raises their ParamError."""
        params = TpuSketch().instance_params().to_params()
        for f in dataclasses.fields(self):
            params.set(f.name.replace("_", "-"), getattr(self, f.name))

    @classmethod
    def from_params(cls, params: Params) -> "SketchConfig":
        """The config of a validated `Params` of `TpuSketch.instance_params`."""
        kw: dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            p = params.get(f.name.replace("_", "-"))
            if isinstance(f.default, bool):
                kw[f.name] = p.as_bool()
            elif isinstance(f.default, int):
                kw[f.name] = p.as_int()
            elif f.name.endswith("_interval") or f.name == "query_max_range":
                kw[f.name] = p.as_duration()
            elif isinstance(f.default, float):
                kw[f.name] = float(p.as_string())
            else:
                kw[f.name] = p.as_string()
        return cls(**kw)


@dataclasses.dataclass
class SketchContext:
    """What the instance reads from the reference's ``GadgetContext``:
    the run's identity, the gadget's batch size, the history clock, the
    summary, window and standing-query hooks, the gadget's key resolver,
    the run span, and the resolved operator params the history store's
    manifest records. Where the framework built the instance, ``extra``
    is the gadget context's, read live: its ``on_sketch_summary``,
    ``on_window_sealed``, ``on_query_answer`` and ``replay`` keys stand
    over the fields of the same names."""

    gadget: str = "trace/exec"
    run_id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex[:12])
    node: str = ""
    batch_size: int = 0
    history_gadget: str = ""
    history_clock: Callable[[], float] | None = None
    on_sketch_summary: Callable[["SketchSummary"], None] | None = None
    on_window_sealed: Callable[[dict], None] | None = None
    on_query_answer: Callable[[dict, bytes], None] | None = None
    resolve_key: Callable[[int], str] | None = None
    replay: bool = False
    trace_parent: SpanContext | None = None
    params: dict[str, str] | None = None
    extra: dict[str, Any] | None = None

    @classmethod
    def from_gadget_context(cls, ctx: GadgetContext, gadget: Any) -> "SketchContext":
        p = ctx.gadget_params
        return cls(gadget=ctx.desc.full_name, run_id=ctx.run_id,
                   node=ctx.extra.get("node", "") or "",
                   batch_size=p.get("batch-size").as_int() if "batch-size" in p else 0,
                   history_gadget=ctx.extra.get("history_gadget") or "",
                   # a replay sets only the alerts clock: its resealed
                   # windows take the recorded timeline too (reference
                   # tpusketch.py:749-750)
                   history_clock=(ctx.extra.get("history_clock")
                                  or ctx.extra.get("alerts_clock")),
                   resolve_key=getattr(gadget, "resolve_key", None),
                   trace_parent=ctx.extra.get("trace_ctx"),
                   params=ctx.operator_params.copy_to_map(), extra=ctx.extra)

    def hook(self, key: str) -> Any:
        """`key` from the live ``extra`` where it is set, else the field."""
        if self.extra is not None and key in self.extra:
            return self.extra[key]
        return getattr(self, key)


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


class TpuSketch(Operator):
    name = "tpusketch"

    def dependencies(self) -> list[str]:
        return []

    def can_operate_on(self, desc: GadgetDesc) -> bool:
        return True  # any batch-emitting gadget

    def instance_params(self) -> ParamDescs:
        """The reference's instance params (``tpusketch.py:302-488``):
        keys, defaults, type hints, possible values and validators."""
        return ParamDescs([
            ParamDesc(key="enable", default="false", type_hint=TypeHint.BOOL,
                      description="enable the sketch plane"),
            ParamDesc(key="depth", default="4", type_hint=TypeHint.INT),
            ParamDesc(key="log2-width", default="16", type_hint=TypeHint.INT),
            ParamDesc(key="hll-p", default="14", type_hint=TypeHint.INT),
            ParamDesc(key="entropy-log2-width", default="12", type_hint=TypeHint.INT),
            ParamDesc(key="topk", default="128", type_hint=TypeHint.INT),
            ParamDesc(key="hh-column", default="key_hash",
                      description="wire column feeding the heavy-hitter stream"),
            ParamDesc(key="distinct-column", default="key_hash"),
            ParamDesc(key="dist-column", default="key_hash",
                      description="wire column feeding entropy/anomaly"),
            ParamDesc(key="anomaly", default="false", type_hint=TypeHint.BOOL,
                      description="train the autoencoder anomaly scorer"),
            ParamDesc(key="anomaly-model", default="ae", possible_values=("ae", "vae", "seq"),
                      description="anomaly scorer family (distribution AE, "
                                  "distribution VAE, or sequence LM)"),
            ParamDesc(key="seq-window", default="256", type_hint=TypeHint.INT,
                      description="per-container token window for the sequence scorer"),
            ParamDesc(key="harvest-interval", default="1s", type_hint=TypeHint.DURATION),
            ParamDesc(key="h2d-depth", default="2", type_hint=TypeHint.INT,
                      description="H2D double-buffer depth: transfers of batch k+1..k+N-1 "
                                  "overlap device compute of batch k"),
            ParamDesc(key="invertible", default="false", type_hint=TypeHint.BOOL,
                      description="add the invertible heavy-key plane: decode of (merged) "
                                  "state recovers exact (key, count) pairs with zero "
                                  "per-key storage"),
            ParamDesc(key="inv-log2-buckets", default="12", type_hint=TypeHint.INT,
                      validator=validate_int_range(lo=6, hi=20),
                      description="buckets per invertible row (decode capacity ~ "
                                  "rows*buckets/4 distinct keys)"),
            ParamDesc(key="inv-rows", default="3", type_hint=TypeHint.INT,
                      validator=validate_int_range(lo=2, hi=8),
                      description="invertible hash rows (peeling redundancy; 3 is the "
                                  "sweet spot)"),
            ParamDesc(key="priority-classes", default="", validator=_validate_priority_classes,
                      description="PSketch-style accuracy classes: "
                                  "name=log2buckets:mntns|mntns,... with one '*' catch-all "
                                  "(e.g. hot=12:101|102,rest=10:*); classes partition the "
                                  "base invertible memory budget so hot tenants keep decode "
                                  "fidelity when the whole stream overflows it"),
            ParamDesc(key="quantiles", default="false", type_hint=TypeHint.BOOL,
                      description="add the DDSketch latency quantile plane: per-event "
                                  "magnitudes (latency ns / bytes) bucket into one more fused "
                                  "grid plane; harvests carry p50/p90/p99/p99.9"),
            ParamDesc(key="quantile-alpha", default="0.01", validator=_validate_quantile_alpha,
                      description="DDSketch relative-error target: every quantile read is "
                                  "within alpha of the true value (0.01 = 1%)"),
            ParamDesc(key="quantile-field", default="aux1",
                      description="wire column feeding the value lane on the EventBatch "
                                  "path (aux1 carries latency ns / byte counts for the "
                                  "value-bearing kinds; folded batches carry their own lane)"),
            ParamDesc(key="audit-sample", default="0", type_hint=TypeHint.INT,
                      validator=validate_int_range(lo=0),
                      description="shadow-sample capacity for the accuracy audit plane (keys "
                                  "held as ground truth; 0 = plane off — summaries then carry "
                                  "analytic bounds only)"),
            ParamDesc(key="shard-ingest", default="false", type_hint=TypeHint.BOOL,
                      description="shard the staged ingest plane across local devices "
                                  "(round-robin lanes, collective harvest; needs >= 2 "
                                  "local devices; IG_SHARD_DISABLE=1 forces the "
                                  "single-device path)"),
            ParamDesc(key="chips", default="auto", validator=_validate_chips,
                      description="device lanes for shard-ingest: 'auto' = all local "
                                  "devices; 1 = the exact single-device path; must not "
                                  "exceed the local device count"),
            ParamDesc(key="history", default="false", type_hint=TypeHint.BOOL,
                      description="seal time-windowed sketch snapshots into the node's "
                                  "history store"),
            ParamDesc(key="history-interval", default="10s", type_hint=TypeHint.DURATION,
                      description="window length; 0 seals one window per harvest (the "
                                  "deterministic-replay mode)"),
            ParamDesc(key="history-dir", default="",
                      description="override the node history area for this run "
                                  "($IG_HISTORY_DIR otherwise)"),
            ParamDesc(key="history-log2-width", default="12", type_hint=TypeHint.INT,
                      description="per-window CMS width (the WindowedCMS ring's table)"),
            ParamDesc(key="history-slots", default="8", type_hint=TypeHint.INT,
                      description="WindowedCMS ring slots (live last-k window view)"),
            ParamDesc(key="history-max-slices", default="256", type_hint=TypeHint.INT,
                      description="subpopulation slices tracked per window (overflow "
                                  "dropped and accounted)"),
            ParamDesc(key="history-compact", default="false", type_hint=TypeHint.BOOL,
                      description="run time-decayed compaction over this run's history "
                                  "store"),
            ParamDesc(key="history-schedule", default=DEFAULT_SCHEDULE,
                      validator=validate_schedule,
                      description="resolution schedule res@horizon[,res@horizon...] (e.g. "
                                  "1m@24h,10m@7d,1h@inf); the last horizon must be inf"),
            ParamDesc(key="history-archive-dir", default="",
                      description="offload fully-compacted cold segments to this archive "
                                  "root"),
            ParamDesc(key="history-archive-cache-bytes", default=str(64 << 20),
                      type_hint=TypeHint.INT, validator=validate_int_range(lo=1 << 16),
                      description="rehydration cache budget (LRU by bytes)"),
            ParamDesc(key="standing-queries", default="",
                      description="standing-query document (JSON/YAML list of {id, stats, "
                                  "range, key?, top?, every?}) or @/path/to/file"),
            ParamDesc(key="query-cache-bytes", default=str(8 << 20), type_hint=TypeHint.INT,
                      validator=validate_int_range(lo=1 << 10),
                      description="digest-keyed result cache budget (LRU by bytes)"),
            ParamDesc(key="query-refresh", default="1", type_hint=TypeHint.INT,
                      validator=validate_int_range(lo=1),
                      description="default publish cadence in seal ticks for queries "
                                  "without an explicit 'every'"),
            ParamDesc(key="query-max-range", default="24h",
                      description="cap on any standing query's sliding range (duration, "
                                  "e.g. 24h)"),
        ])

    def instantiate(self, ctx: GadgetContext, gadget: Any,
                    instance_params: Params) -> "TpuSketchInstance":
        return TpuSketchInstance(self, ctx, gadget, instance_params)


class TpuSketchInstance(OperatorInstance):
    """One run's sketch plane on one device (the reference's single-chip
    path, ``tpusketch.py:495-2117``). Built by the framework as
    ``TpuSketchInstance(op, ctx, gadget, params)`` (``enable=false``
    gives a no-op instance, and the device is the context's), or without
    it as ``TpuSketchInstance(config, context, device=...)``."""

    def __init__(self, op: "TpuSketch | SketchConfig | None" = None,
                 ctx: "GadgetContext | SketchContext | None" = None,
                 gadget: Any = None, params: Params | None = None, *,
                 device: str | torch.device = "cuda"):
        super().__init__(TpuSketch.name)
        if isinstance(op, TpuSketch):
            p = params if params is not None else op.instance_params().to_params()
            self.enabled = p.get("enable").as_bool()
            if not self.enabled:
                return
            cfg = SketchConfig.from_params(p)
            device = ctx.device
            ctx = SketchContext.from_gadget_context(ctx, gadget)
        else:
            self.enabled = True
            cfg = op if op is not None else SketchConfig()
            ctx = ctx if ctx is not None else SketchContext()
            cfg.validate()
        self.device = resolve_device(device)
        self.config, self.ctx = cfg, ctx
        self.gadget = gadget
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
        # -- sharded ingest: every topology error before the first batch ----
        self._shard_on = False
        self._chips = 1
        shard_req = cfg.shard_ingest
        ndev = _local_device_count(self.device)
        if os.environ.get("IG_SHARD_DISABLE", "") == "1":
            # the escape hatch outranks the topology checks: a fleet-wide
            # chips=N config still starts on a host with fewer devices
            if shard_req or cfg.chips != "auto":
                _log.warning("IG_SHARD_DISABLE=1: shard-ingest/chips params are inert — "
                             "forced to the single-chip path")
            shard_req = False
        elif cfg.chips != "auto" and int(cfg.chips) > ndev:
            raise ParamError(f"param 'chips': {cfg.chips} exceeds the {ndev} local "
                             f"device(s) on this host")
        if shard_req:
            if ndev < 2:
                raise ParamError(
                    "param 'shard-ingest': this host exposes 1 device — sharded ingest "
                    "needs >= 2 local devices (chips=1 is the single-chip path and needs "
                    "no flag)")
            self._chips = ndev if cfg.chips == "auto" else int(cfg.chips)
            if self._chips >= 2 and ctx.batch_size > 0 and ctx.batch_size % self._chips:
                raise ParamError(
                    f"param 'chips': batch-size {ctx.batch_size} is not divisible by chips "
                    f"{self._chips} — round-robin lane fills need whole batches per lane")
            self._shard_on = self._chips >= 2
        # the lanes are built at the first batch. Batch i always lands on
        # lane i mod chips (_next_lane, which no flush moves), and _pending
        # holds each lane's staged batch until the round is full or a read
        # of the state flushes it with zero-weight fillers
        self._mesh: list[torch.device] | None = None
        self._sharded = None
        self._ingest_sharded = self._harvest_sharded = None
        self._lane_pools: list[PinnedBufferPool] = []
        self._lane_stagers: list[H2DStager] = []
        self._lane_zeros: list[torch.Tensor] = []
        self._next_lane = 0
        self._pending: dict[int, dict] = {}
        # -- standing-query plane: every misconfig raises before the first batch
        sq_specs = None
        if not cfg.standing_queries:
            if cfg.query_cache_bytes != 8 << 20:
                raise ParamError(
                    "param 'query-cache-bytes': needs 'standing-queries' "
                    "— the result cache fronts materialized answers")
            if cfg.query_refresh != 1:
                raise ParamError(
                    "param 'query-refresh': needs 'standing-queries' — "
                    "the cadence applies to registered queries")
            if cfg.query_max_range != 86400.0:
                raise ParamError(
                    "param 'query-max-range': needs 'standing-queries' "
                    "— the cap bounds registered queries' ranges")
        else:
            if not cfg.history:
                raise ParamError(
                    "param 'standing-queries': needs 'history true' — "
                    "materialized answers fold the sealed-window stream")
            doc = cfg.standing_queries
            try:
                load = load_queries_file if doc.startswith("@") else load_queries
                sq_specs = load(doc[1:] if doc.startswith("@") else doc,
                                default_every=cfg.query_refresh,
                                max_range_s=cfg.query_max_range)
            except QueryError as e:
                raise ParamError(f"param 'standing-queries': {e}") from None
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
        # host-clock split of the last harvest (ms): the digest's dispatch,
        # its copy's wait and its read (digest_decode, their sum), the host
        # finisher, the anomaly step, the seal; and sums over the gadget-path
        # batches since the harvest before it: their count, fold, copy,
        # dispatch, post and (on the card) device lag
        self.last_harvest_ms: dict[str, float] = {}
        self._acc = dict.fromkeys(_BATCH_PARTS, 0.0)
        # device-completion stamps (the card's unsharded gadget path):
        # (fence event, dispatch end) a batch, booked once the event has
        # completed, against `_anchor`
        self._stamps: collections.deque = collections.deque()
        self._anchor: tuple[Any, float] | None = None
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
        # self-observability feed for top/sketch
        from ..gadgets.top.sketch import SketchStatsSource
        self._stats = SketchStatsSource(ctx.run_id, g)
        self._stats.register()
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
            # host-clock split of the last seal (ms): reads off the device,
            # digest + encode_window, the store append, the standing queries
            self.last_seal_ms: dict[str, float] = {}
            try:
                self._hist_writer = HISTORY.writer_for(
                    self._hist_gadget, node=ctx.node, run_id=ctx.run_id, params=ctx.params,
                    base_dir=cfg.history_dir or None, platform=self.device.type)
            except (OSError, ValueError) as e:
                _log.warning("history store open failed (sealing disabled for this run): "
                             "%r", e)
                self._hist_on = False
        # tiered lifecycle: the archive tier (rehydration for this run's
        # history area) and the compaction engine, aging windows on the
        # clock that stamps them
        self._hist_engine = None
        if self._hist_on:
            if cfg.history_archive_dir:
                HISTORY.set_archive(cfg.history_archive_dir, cfg.history_archive_cache_bytes,
                                    base_dir=cfg.history_dir or None)
            if cfg.history_compact:
                self._hist_engine = CompactionEngine(cfg.history_schedule,
                                                     clock=self._hist_clock)
        self._sq_engine = None
        if sq_specs is not None:
            self._sq_engine = StandingQueryEngine(
                sq_specs, gadget=ctx.history_gadget or g, node=ctx.node,
                cache_bytes=cfg.query_cache_bytes)
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
        if self._sq_engine is not None:
            queries_engine.register(ctx.run_id, self._sq_engine)
        if self.device.type == "cuda" and not self._shard_on:
            # the completion stamps' first origin, off the batch path
            self._take_anchor()
        with _live_mu:
            _live[ctx.run_id] = self

    def _span(self, name: str, label: str | None = None, **attrs):
        """A device-plane span: under the enrich span when called from the
        operator chain (the ambient current), else under the run span;
        while a profiler records, a range named `label` or `name`."""
        return TRACER.span(name, parent=TRACER.current_context() or self.ctx.trace_parent,
                           attrs=attrs, label=label)

    def _note_watermarks(self, pop_ts: float, oldest_ts: float, lane: int = 0) -> None:
        """Batch-grain lag watermarks: host lag = pop − oldest event,
        device lag = dispatch (now) − pop. Unstamped batches read as zero
        lag."""
        now = time.time()
        if pop_ts <= 0.0:
            pop_ts = now
        if oldest_ts <= 0.0 or oldest_ts > pop_ts:
            oldest_ts = pop_ts
        self._pstats.note_host_lag(pop_ts - oldest_ts, lane)
        self._pstats.note_device_lag(max(now - pop_ts, 0.0), lane)

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

    def _fence(self, stager: H2DStager, token):
        """Tie the staged block's release to every consumer of its arrays
        and return the fence: on the card one CUDA timing event after the
        bundle step, the window steps and the class updates; on the CPU
        they have run when this is called, and the bundle step's token
        stands for them."""
        if self.device.type == "cuda":
            token = torch.cuda.Event(enable_timing=True)
            token.record(torch.cuda.current_stream(self.device))
        stager.fence(token)
        return token

    # -- device-completion stamps (the card only) ---------------------------------

    def _take_anchor(self) -> None:
        """An event completed now, and the host clock when it had: the
        origin that maps event times onto the host clock."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        ev.synchronize()
        self._anchor = (ev, time.perf_counter())

    def _stamp(self, fence, t_dispatch: float) -> None:
        """Park one batch's fence event with its dispatch end. A backlog
        past `_STAMPS_MAX` (harvests far apart) books what has completed."""
        self._stamps.append((fence, t_dispatch))
        if len(self._stamps) > _STAMPS_MAX:
            self._book_stamps()

    def _book_stamps(self) -> None:
        """Book every parked stamp whose event has completed (in order:
        one stream): its completion on the host clock less its dispatch
        end, into the pipeline's device stage and the harvest's sum."""
        ev0, t0 = self._anchor
        while self._stamps:
            ev, t = self._stamps[0]
            if not ev.query():
                break
            self._stamps.popleft()
            lag = max(t0 + ev0.elapsed_time(ev) / 1e3 - t, 0.0)
            self._pstats.note_completion_lag(lag)
            self._acc["device_lag"] += lag * 1e3

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

    # -- the sharded ingest plane ------------------------------------------------

    def _ensure_sharded(self) -> None:
        """The lanes, the sharded step and harvest, and one bundle a lane
        (lane 0 seeded with the live, possibly resumed, bundle)."""
        if self._sharded is not None:
            return
        self._mesh = ingest_mesh(self._chips, _lane_devices(self._chips, self.device))
        self._ingest_sharded = make_bundle_ingest_sharded(self._mesh, self.bundle)
        self._harvest_sharded = make_bundle_harvest_sharded(self._mesh, self.bundle)
        self._sharded = bundle_stack_sharded(self.bundle, self._mesh)

    def _lane_staging(self, pad: int) -> tuple[PinnedBufferPool, H2DStager]:
        """The pool and stager of the lane the next batch lands on. Each
        lane has its own pinned pool and a stager copying to its own
        device on its own copy stream, and one cached zero lane (the
        filler of a flushed round, which touches no staging state). A pad
        growth flushes the open round at the old shape, drains, and
        rebuilds every lane."""
        self._ensure_sharded()
        if not self._lane_pools or self._lane_pools[0].capacity != pad:
            with self._bundle_mu:
                self._dispatch_round_locked()
            for st in self._lane_stagers:
                st.drain()
            self._lane_pools = [PinnedBufferPool(pad, lanes=5 if self._qt_on else 4,
                                                 max_free=self._h2d_depth + 2, device=d, lane=k)
                                for k, d in enumerate(self._mesh)]
            self._lane_stagers = [H2DStager(pool, depth=self._h2d_depth, device=d,
                                            stats=self._pstats)
                                  for pool, d in zip(self._lane_pools, self._mesh)]
            self._lane_zeros = [torch.zeros(pad, dtype=torch.int32, device=d)
                                for d in self._mesh]
        self._pad = max(self._pad, pad)
        return self._lane_pools[self._next_lane], self._lane_stagers[self._next_lane]

    def _shard_absorb_locked(self, hh_d, distinct_d, dist_d, w_d, new_drops: float,
                             slot: int, values_d=None) -> None:
        """Park one staged batch on its lane (its arrays already on the
        lane's device; `slot` is the stager slot to fence at dispatch) and
        move the round-robin on; a full round dispatches. Caller holds
        _bundle_mu."""
        lane = self._next_lane
        arrays = (hh_d, distinct_d, dist_d, w_d)
        if self._qt_on:
            arrays += (values_d if values_d is not None else self._lane_zeros[lane],)
        self._pending[lane] = {"arrays": arrays, "slot": slot, "drops": max(new_drops, 0.0)}
        self._next_lane = (lane + 1) % self._chips
        if len(self._pending) >= self._chips:
            self._dispatch_round_locked()

    def _dispatch_round_locked(self) -> None:
        """One sharded step over the pending lanes: one K2 a lane on the
        lane's device. A lane without a batch (a read of the state
        mid-round, a ragged tail) rides its cached zero lane: weight 0
        adds to no plane, so a flushed round folds exactly the batches it
        holds. Each real batch's stager slot is fenced on its lane's
        token. Caller holds _bundle_mu."""
        if not self._pending:
            return
        n_arr = 5 if self._qt_on else 4
        for lane in range(self._chips):
            if lane not in self._pending:
                self._pending[lane] = {"arrays": (self._lane_zeros[lane],) * n_arr,
                                       "slot": None, "drops": 0.0}
        by_lane = [self._pending[k] for k in range(self._chips)]
        cols = [[p["arrays"][i] for p in by_lane] for i in range(n_arr)]
        self._sharded, tokens = self._ingest_sharded(
            self._sharded, *cols[:4], [p["drops"] for p in by_lane],
            cols[4] if self._qt_on else None)
        for lane, (p, tok) in enumerate(zip(by_lane, tokens)):
            if p["slot"] is not None:
                self._lane_stagers[lane].fence_slot(p["slot"], tok)
        self._pending = {}
        self._pstats.note_round()

    def _merged_locked(self):
        """The bundle every read consumes: the live bundle, or under
        shard-ingest the open round flushed and the lanes merged
        (`cluster_merge`, on lane 0's device), bit-identical to the
        one-device fold of the same stream. Caller holds _bundle_mu."""
        if not self._shard_on or self._sharded is None:
            return self.bundle
        self._dispatch_round_locked()
        return self._harvest_sharded(self._sharded)

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
        if not self.enabled or batch.count == 0:
            return
        n = batch.count
        pad = self._pad
        while pad < n:
            pad *= 2
        lane = self._next_lane if self._shard_on else 0
        fence = None
        with self._span("tpusketch/h2d", events=n, pad=pad) as h2d:
            with self._span("tpusketch/fold") as fold:
                pool, stager = (self._lane_staging(pad) if self._shard_on
                                else self._staging_for(pad))
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
            with self._span("tpusketch/copy") as copy:
                # one copy per distinct lane: shared columns stage once
                order = list(rows.values()) + [3] + ([4] if vals is not None else [])
                staged = stager.stage(block, [block[r] for r in order])
                staged_slot = stager.last_slot
            by_row = dict(zip(order, staged))
            hh_d = by_row[rows[self.hh_col]]
            distinct_d = by_row[rows[self.distinct_col]]
            dist_d = by_row[rows[self.dist_col]]
            w_d = by_row[3]
            v_d = by_row.get(4) if vals is not None else None
        with self._span("tpusketch/update", label="ig:tpusketch_update", events=n) as update:
            if self._shard_on:
                # the window and class planes stay on the instance's
                # device: the lane's staged arrays are copied there
                if self._hist_on:
                    wcms_ingest_step(self._wcms, hh_d.to(self.device), w_d.to(self.device))
                    hll_ingest_step(self._win_hll, distinct_d.to(self.device), w_d.to(self.device))
                    self._accumulate_slices(batch, n, hh, distinct, dist)
                with self._bundle_mu:
                    if self._inv_classes:
                        self._inv_class_absorb(hh_d.to(self.device),
                                               self._padded_mntns(batch, n, len(hh)), w)
                    self._shard_absorb_locked(hh_d, distinct_d, dist_d, w_d,
                                              float(max(new_drops, 0)), staged_slot, v_d)
            else:
                with self._bundle_mu:
                    _, tok = bundle_ingest_step(self.bundle, hh_d, distinct_d, dist_d, w_d,
                                                float(max(new_drops, 0)), v_d)
                    update.set_attr("graph", self.bundle.graphs.last)
                if self._hist_on:
                    wcms_ingest_step(self._wcms, hh_d, w_d)
                    hll_ingest_step(self._win_hll, distinct_d, w_d)
                    self._accumulate_slices(batch, n, hh, distinct, dist)
                if self._inv_classes:
                    with self._bundle_mu:
                        self._inv_class_absorb(hh_d, self._padded_mntns(batch, n, len(hh)), w)
                fence = self._fence(stager, tok)
                t_dispatch = time.perf_counter()
        if fence is not None and self._anchor is not None:
            self._stamp(fence, t_dispatch)
        with self._span("tpusketch/post") as post:
            self._m_h2d.observe(h2d.duration)
            self._m_update.observe(update.duration)
            self._m_events.inc(n)
            self._m_steps.inc()
            self._qt_count(vals, n)
            if new_drops > 0:
                self._m_drops.inc(new_drops)
            self._stats.steps += 1
            self._stats.events += n
            self._stats.drops = batch.drops
            oldest = batch.oldest_ts
            if oldest <= 0.0:
                tmin = float(batch.cols["ts"][:n].min())
                if tmin > 0.0:
                    oldest = tmin / 1e9
            self._note_watermarks(batch.pop_ts, oldest, lane)
            self._shadow_feed(hh[:n])
            self._label_sample(batch, hh, n)
            if self.anomaly_on:
                self._accumulate_container_dists(batch, n)
        acc = self._acc
        acc["batches"] += 1
        acc["fold"] += fold.duration * 1e3
        acc["copy"] += copy.duration * 1e3
        acc["dispatch"] += update.duration * 1e3
        acc["post"] += post.duration * 1e3
        self._after_batch()

    def ingest_folded(self, fb: FoldedBatch) -> None:
        """Ingest of a pre-folded batch popped into a `folded_block()`
        (``pop_folded``): the one keys lane feeds all three sketch
        streams. The stager returns the block to this instance's pool
        once the step's fence completes. Sealed windows carry no slices
        and the anomaly plane sees nothing on this path (no kind or
        per-event mntns columns), as in the reference."""
        if not self.enabled or fb.count == 0:
            return
        n = fb.count
        lane = self._next_lane if self._shard_on else 0
        with self._span("tpusketch/h2d", events=n, pad=fb.capacity) as h2d:
            _pool, stager = (self._lane_staging(fb.capacity) if self._shard_on
                             else self._staging_for(fb.capacity))
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
            staged_slot = stager.last_slot
        with self._span("tpusketch/update", label="ig:tpusketch_update", events=n) as update:
            if self._shard_on:
                if self._hist_on:
                    k_i, w_i = k_d.to(self.device), w_d.to(self.device)
                    wcms_ingest_step(self._wcms, k_i, w_i)
                    hll_ingest_step(self._win_hll, k_i, w_i)
                with self._bundle_mu:
                    if self._inv_classes:
                        self._inv_class_absorb(k_d.to(self.device), fb.mntns, fb.weights)
                    self._shard_absorb_locked(k_d, k_d, k_d, w_d, float(max(new_drops, 0)),
                                              staged_slot, v_d)
            else:
                with self._bundle_mu:
                    # without a value lane the step zero-fills: every event
                    # lands in the zero bucket and totals stay honest
                    _, tok = bundle_ingest_step(self.bundle, k_d, k_d, k_d, w_d,
                                                float(max(new_drops, 0)), v_d)
                    update.set_attr("graph", self.bundle.graphs.last)
                if self._hist_on:
                    wcms_ingest_step(self._wcms, k_d, w_d)
                    hll_ingest_step(self._win_hll, k_d, w_d)
                if self._inv_classes:
                    with self._bundle_mu:
                        self._inv_class_absorb(k_d, fb.mntns, fb.weights)
                self._fence(stager, tok)
        self._m_h2d.observe(h2d.duration)
        self._m_update.observe(update.duration)
        self._m_events.inc(n)
        self._m_steps.inc()
        self._qt_count(fvals, n)
        if new_drops > 0:
            self._m_drops.inc(new_drops)
        self._stats.steps += 1
        self._stats.events += n
        self._stats.drops = fb.drops
        self._note_watermarks(fb.pop_ts, fb.oldest_ts, lane)
        # folded batches carry real integer weights: the shadow honours them
        self._shadow_feed(fb.keys[:n], fb.weights[:n])
        self._after_batch()

    def folded_block(self) -> torch.Tensor:
        """A pinned (4+, pad) staging block for ``pop_folded``: rows 0-2
        are the keys, weights and mntns lanes; row 3 is the value lane when
        popped with ``with_values=True``. Under shard-ingest it comes from
        the pool of the lane the next `ingest_folded` lands on."""
        pool, _ = (self._lane_staging(self._pad) if self._shard_on
                   else self._staging_for(self._pad))
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
        """Seal the open window into the history store: ONE frame, ONE
        O_APPEND write (a kill mid-seal tears at most this window, and the
        torn tail is dropped and accounted on read). A window with no
        events and no slices is skipped. The window's count-min is the
        ring's current slot and its HLL the window HLL; entropy, events,
        drops and the invertible and DDSketch lanes are deltas of the
        cumulative bundle (pure adds, so the subtraction is exact, uint32
        wrap included). Standing queries fold the window only after the
        append succeeded, so their coverage is what the store holds."""
        t0 = time.perf_counter()
        end = self._hist_clock()
        with self._bundle_mu:
            b = self._merged_locked()
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
        t1 = time.perf_counter()
        win.digest = window_digest(win)
        t2 = t3 = time.perf_counter()
        try:
            with self._span("tpusketch/seal-window", window=self._win_n, events=win_events):
                # HISTORY.append_window, split so the encode and the append
                # are timed apart
                header, payload = encode_window(win)
                t2 = time.perf_counter()
                win.seq = self._hist_writer.append_window_frame(
                    header, payload, win.slice_keys, win.end_ts or None)
                t3 = time.perf_counter()
        except (OSError, ValueError) as e:
            if not isinstance(e, OSError):
                # the writer's append path already counted an OSError
                HISTORY_METRICS.drops.labels(reason="seal").inc()
            _log.warning("window seal failed (window %d was dropped): %r", self._win_n, e)
        else:
            hook = self.ctx.hook("on_window_sealed")
            if hook is not None:
                try:
                    hook({"gadget": win.gadget, "window": win.window,
                          "start_ts": win.start_ts, "end_ts": win.end_ts,
                          "events": win.events, "drops": win.drops, "digest": win.digest})
                except Exception as he:  # noqa: BLE001 — announce only
                    _log.warning("window announce failed: %r", he)
            if self._sq_engine is not None:
                try:
                    pubs = self._sq_engine.on_seal(win, now=float(end))
                except Exception as qe:  # noqa: BLE001 — observe only
                    _log.warning("standing-query refresh failed: %r", qe)
                    pubs = []
                qhook = self.ctx.hook("on_query_answer")
                if qhook is not None:
                    for qheader, qpayload in pubs:
                        try:
                            qhook(qheader, qpayload)
                        except Exception as qe:  # noqa: BLE001
                            _log.warning("query answer publish failed: %r", qe)
        t4 = time.perf_counter()
        self.last_seal_ms = {"d2h": (t1 - t0) * 1e3, "encode": (t2 - t1) * 1e3,
                             "append": (t3 - t2) * 1e3, "queries": (t4 - t3) * 1e3,
                             "total": (t4 - t0) * 1e3}
        if self._hist_engine is not None:
            # a time-gated pass: sealed segments whose windows aged past
            # their level's horizon fold into super-windows (the active
            # segment, where this window just landed, is never touched)
            try:
                self._hist_engine.maybe_compact(self._hist_writer.path)
            except (OSError, ValueError) as e:
                _log.warning("compaction pass failed: %r", e)
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
        with self._span("tpusketch/harvest", epoch=self._epoch + 1):
            return self._harvest_traced()

    def _harvest_traced(self) -> SketchSummary:
        t0 = time.perf_counter()
        # one packed digest, read in one device-to-host copy; the decode's
        # device loop is queued before that copy, so the copy's wait is
        # the loop's time too
        inv_dev = qt_now = None
        with self._span("tpusketch/harvest/dispatch") as dispatch, self._bundle_mu:
            merged = self._merged_locked()
            digest = bundle_digest(merged)
            if self._inv_on and merged.inv is not None:
                cap = min(4096, inv_capacity(self._inv_rows, self._inv_lb))
                inv_dev = inv_decode_device(merged.inv, sweeps=2, cap=cap)
            if self._qt_on and merged.quantiles is not None:
                qt_now = self._qt_host(merged)
            if self._inv_classes:
                cls_snap = [(c, (s.count.cpu().numpy().astype(np.int64, copy=True),
                                 _lane_np(s.keysum), _lane_np(s.fpsum)))
                            for c, s in self._inv_classes]
        with self._span("tpusketch/harvest/wait") as wait:
            digest_np = digest.cpu().numpy()
        if self._anchor is not None:
            # the copy waited for every step queued before it: book the
            # stamps against the old anchor, then take a fresh one
            self._book_stamps()
            self._take_anchor()
        acc, self._acc = self._acc, dict.fromkeys(_BATCH_PARTS, 0.0)
        with self._span("tpusketch/harvest/read") as read:
            events_f, drops_f, distinct, entropy_bits, approx, keys, counts = (
                decode_digest(digest_np))
        with self._span("tpusketch/harvest/finish") as finish:
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
        with self._span("tpusketch/harvest/anomaly") as anomaly_span:
            anomaly = self._score_containers()
        self._epoch += 1
        summary = SketchSummary(
            events=int(events_f), drops=int(drops_f), distinct=distinct,
            entropy_bits=entropy_bits, heavy_hitters=hh, anomaly=anomaly, epoch=self._epoch,
            names={k: self._names[k] for k, _ in hh if k in self._names}, approx=approx,
            decoded=decoded, decoded_only=decoded_only, inv=inv_info, classes=classes_out,
            quantiles=qt_out, pipeline=pipe_out, accuracy=acc_out)
        cb = self.ctx.hook("on_sketch_summary")
        if cb is not None:
            cb(summary)
        self._m_harvests.inc()
        self._m_harvest_s.observe(time.perf_counter() - t0)
        t4 = time.perf_counter()
        if self._hist_on and self._hist_interval <= 0:
            # history-interval 0: one sealed window a harvest (the replay mode)
            self.seal_window()
        t5 = time.perf_counter()
        parts = {"digest_dispatch": dispatch.duration * 1e3, "digest_wait": wait.duration * 1e3,
                 "digest_read": read.duration * 1e3}
        self.last_harvest_ms = {
            "digest_decode": parts["digest_dispatch"] + parts["digest_wait"]
            + parts["digest_read"], **parts,
            "finish": finish.duration * 1e3, "anomaly": anomaly_span.duration * 1e3,
            "seal": (t5 - t4) * 1e3, "total": (t5 - t0) * 1e3, **acc}
        if self._anchor is None:
            del self.last_harvest_ms["device_lag"]
        return summary

    def post_gadget_run(self) -> None:
        """Teardown: the final harvest (none in a replay, which harvests
        only at recorded boundaries) and the final partial window, the
        history store's active segment sealed and one compaction pass, the
        stager drained, the standing queries and stats unregistered, the
        shutdown checkpoint."""
        if not self.enabled:
            return
        if not self.ctx.hook("replay"):
            self.harvest()
        if self._hist_on:
            # the final partial window, then seal the store's active
            # segment so this run's windows get index rows
            self.seal_window()
            HISTORY.release(self._hist_writer)
            if self._hist_engine is not None:
                # one final pass lets a short-horizon schedule compact the
                # windows the release just sealed
                try:
                    self._hist_engine.compact_store(self._hist_writer.path)
                except (OSError, ValueError) as e:
                    _log.warning("teardown compaction failed: %r", e)
        if self._stager is not None:
            self._stager.drain()
        if self._lane_stagers:
            # the open round landed in the final harvest's merge above;
            # flush again for a caller that skipped it, then release every
            # lane's in-flight blocks
            with self._bundle_mu:
                self._dispatch_round_locked()
            for st in self._lane_stagers:
                st.drain()
        if self._sq_engine is not None:
            queries_engine.unregister(self.ctx.run_id)
        self._stats.unregister()
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
            with self._span("tpusketch/resume"):
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
        with self._span("tpusketch/checkpoint", key=self._ckpt_key):
            with self._bundle_mu:
                bundle_host = bundle_to_numpy(self._merged_locked())
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
            b = self._merged_locked()
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


register(TpuSketch())
