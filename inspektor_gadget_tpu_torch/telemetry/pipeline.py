"""Pipeline health of the ingest hot path: per-stage lag watermarks,
starved and saturated stager ticks (the port's copy of
``inspektor_gadget_tpu/telemetry/pipeline.py``).

- Watermark: a stage's lag for the most recent batch (host lag = pop -
  oldest event, device lag = dispatch - pop), stamped once a batch; on
  the card also the ``device`` stage, completion - dispatch end, stamped
  once the batch's fence event has completed.
- Starved tick: the H2D stager found its next ring slot empty, so the
  device had drained everything in flight and the host sets the pace.
- Saturated tick: the slot was still occupied, so the host is a full
  ring ahead and waits on the slot's fence (the wait is timed); the
  device sets the pace.
- starved_ratio = starved / (starved + saturated).

Lag distributions go into `LagSketch`, a host DDSketch with the bucket
math of ``ops/quantiles.py`` in scalar numpy.
"""

from __future__ import annotations

import math
import threading

import numpy as np

from .registry import counter, gauge

_tm_stage_lag = gauge(
    "ig_pipeline_stage_lag_seconds",
    "Lag watermark of the most recent batch through a pipeline stage",
    ("stage", "lane"))
_tm_starved_ratio = gauge(
    "ig_pipeline_starved_ratio",
    "starved / (starved + saturated) stager ticks — 1.0 means the device "
    "always drained the ring before the host refilled it (host-bound)")
_tm_backpressure = counter(
    "ig_pipeline_backpressure_total",
    "Ticks a pipeline stage blocked on a full downstream ring",
    ("stage",))
_tm_occupancy = gauge(
    "ig_pipeline_occupancy",
    "Occupied slots in a pipeline stage's ring",
    ("stage", "lane"))


class LagSketch:
    """Host DDSketch over one stage's lag samples: alpha 1%, 2048
    buckets, min_value 1e-9 (ns to ~30 s), in scalar math. One sample a
    batch, so an add costs a log and an increment."""

    __slots__ = ("alpha", "min_value", "counts", "zeros", "total",
                 "watermark", "_inv_log_gamma", "_offset", "_gamma")

    def __init__(self, alpha: float = 0.01, n_buckets: int = 2048,
                 min_value: float = 1e-9):
        self.alpha = alpha
        self.min_value = min_value
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._inv_log_gamma = 1.0 / math.log(self._gamma)
        self._offset = math.log(min_value) * self._inv_log_gamma
        self.counts = np.zeros(n_buckets, np.int64)
        self.zeros = 0
        self.total = 0
        self.watermark = 0.0

    def add(self, v: float) -> None:
        self.watermark = float(v)
        self.total += 1
        if v <= 0.0:
            self.zeros += 1
            return
        idx = math.ceil(math.log(max(v, self.min_value))
                        * self._inv_log_gamma - self._offset)
        self.counts[min(max(idx, 0), len(self.counts) - 1)] += 1

    def quantile(self, q: float) -> float:
        """Value at quantile q — the dd_quantile_np formula on this
        sketch's own lanes (0.0 inside the zero bucket / empty sketch:
        a lag gauge must never surface NaN)."""
        if self.total <= 0:
            return 0.0
        rank = q * max(self.total - 1.0, 0.0)
        if rank < self.zeros:
            return 0.0
        cum = self.zeros + np.cumsum(self.counts.astype(np.float64))
        bucket = int((cum <= rank).sum())
        bucket = min(bucket, len(self.counts) - 1)
        log_gamma = math.log(self._gamma)
        offset = math.log(self.min_value) / log_gamma
        return float(2.0 * math.exp((bucket + offset) * log_gamma)
                     / (self._gamma + 1.0))


class PipelineStats:
    """Per-run pipeline health accounting, fed a batch at a time by the
    staging layer (starved, saturated, stall, occupancy) and the ingest
    loop (watermarks); `register` makes it findable by run id."""

    def __init__(self, run_id: str, gadget: str = ""):
        self.run_id = run_id
        self.gadget = gadget
        self._mu = threading.Lock()
        self._stages: dict[tuple[str, int], LagSketch] = {}
        self.starved = 0
        self.saturated = 0
        self.stall_s = 0.0
        self.rounds = 0
        self._backpressure: dict[str, int] = {}
        self._occupancy: dict[str, float] = {}
        self._occ_touched: set[tuple[str, str]] = set()

    # -- observations (hot path: one lock + O(1) work per batch) ------------

    def note_lag(self, stage: str, lag_s: float, lane: int = 0) -> None:
        lag_s = max(float(lag_s), 0.0)
        with self._mu:
            sk = self._stages.get((stage, lane))
            if sk is None:
                sk = self._stages[(stage, lane)] = LagSketch()
            sk.add(lag_s)
        _tm_stage_lag.labels(stage=stage, lane=str(lane)).set(lag_s)

    def note_host_lag(self, lag_s: float, lane: int = 0) -> None:
        """pop − oldest event: how stale a batch already was when the
        host popped it off the capture ring."""
        self.note_lag("pop", lag_s, lane)

    def note_device_lag(self, lag_s: float, lane: int = 0) -> None:
        """dispatch − pop: how long a popped batch waited for staging +
        the device update to pick it up."""
        self.note_lag("h2d", lag_s, lane)

    def note_completion_lag(self, lag_s: float, lane: int = 0) -> None:
        """the step's completion on the card − the host's dispatch end:
        how far the card ran behind the host (the ``device`` stage; fed
        only on the card, once the batch's fence event has completed)."""
        self.note_lag("device", lag_s, lane)

    def note_starved(self, lane: int = 0) -> None:
        with self._mu:
            self.starved += 1
            ratio = self.starved / (self.starved + self.saturated)
        _tm_starved_ratio.set(ratio)

    def note_saturated(self, stall_s: float, lane: int = 0,
                       stage: str = "h2d") -> None:
        with self._mu:
            self.saturated += 1
            self.stall_s += max(float(stall_s), 0.0)
            self._backpressure[stage] = self._backpressure.get(stage, 0) + 1
            ratio = self.starved / (self.starved + self.saturated)
        _tm_starved_ratio.set(ratio)
        _tm_backpressure.labels(stage=stage).inc()

    def note_backpressure(self, stage: str, n: int = 1) -> None:
        with self._mu:
            self._backpressure[stage] = self._backpressure.get(stage, 0) + n
        _tm_backpressure.labels(stage=stage).inc(n)

    def note_occupancy(self, stage: str, occupied: float,
                       lane: int = 0) -> None:
        with self._mu:
            self._occupancy[f"{stage}:{lane}"] = float(occupied)
            self._occ_touched.add((stage, str(lane)))
        _tm_occupancy.labels(stage=stage, lane=str(lane)).set(occupied)

    def note_round(self) -> None:
        with self._mu:
            self.rounds += 1

    # -- reads --------------------------------------------------------------

    def snapshot(self) -> dict:
        """The run's pipeline block: a plain JSON-able dict with stable
        keys."""
        with self._mu:
            stages: dict[str, dict] = {}
            for (stage, lane), sk in sorted(self._stages.items()):
                row = stages.setdefault(stage, {
                    "watermark_s": 0.0, "p50_s": 0.0, "p99_s": 0.0,
                    "count": 0})
                # multi-lane stages report the worst lane's view: the
                # fleet cares about the laggiest lane, not the average
                row["watermark_s"] = max(row["watermark_s"], sk.watermark)
                row["p50_s"] = max(row["p50_s"], sk.quantile(0.50))
                row["p99_s"] = max(row["p99_s"], sk.quantile(0.99))
                row["count"] += sk.total
            ticks = self.starved + self.saturated
            return {
                "stages": stages,
                "host_lag_s": stages.get("pop", {}).get("watermark_s", 0.0),
                "device_lag_s": stages.get("h2d", {}).get("watermark_s", 0.0),
                "starved": self.starved,
                "saturated": self.saturated,
                "starved_ratio": (self.starved / ticks) if ticks else 0.0,
                "stall_s": self.stall_s,
                "backpressure": dict(self._backpressure),
                "occupancy": dict(self._occupancy),
                "rounds": self.rounds,
            }

    # -- lifecycle ----------------------------------------------------------

    def register(self) -> None:
        with _live_mu:
            _live[self.run_id] = self

    def unregister(self) -> None:
        """Drop out of the live registry and return every gauge this run
        touched to 0: a stopped run leaves nothing on shared gauges."""
        with _live_mu:
            _live.pop(self.run_id, None)
        with self._mu:
            touched = list(self._stages.keys())
            occ = list(self._occ_touched)
        for stage, lane in touched:
            _tm_stage_lag.labels(stage=stage, lane=str(lane)).set(0.0)
        for stage, lane in occ:
            _tm_occupancy.labels(stage=stage, lane=lane).set(0.0)
        _tm_starved_ratio.set(0.0)


_live_mu = threading.Lock()
_live: dict[str, PipelineStats] = {}


def live_stats() -> list[PipelineStats]:
    with _live_mu:
        return list(_live.values())
