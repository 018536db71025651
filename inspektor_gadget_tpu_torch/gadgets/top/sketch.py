"""top/sketch — self-observability of the analytics plane (top/ebpf analogue).

Reference: pkg/gadgets/top/ebpf reports runtime/run-count of every loaded
BPF program via kernel stats (pkg/bpfstats + pid_iter). The analogue here:
every live tpusketch instance self-registers; this gadget reports per
interval each instance's device-step count, ingested events, drops, and
ingest rate — the "what is my observability stack itself costing" view.

The port's copy of ``inspektor_gadget_tpu/gadgets/top/sketch.py``.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from ...columns import col
from ...params import ParamDescs
from ...types import Event
from ..interface import GadgetDesc, GadgetType
from ..interval_gadget import IntervalGadget, interval_params
from ..registry import register

_live_lock = threading.Lock()
_live: dict[str, "SketchStatsSource"] = {}


class SketchStatsSource:
    """Registered by tpusketch instances (and other device pipelines)."""

    def __init__(self, run_id: str, gadget: str):
        self.run_id = run_id
        self.gadget = gadget
        self.steps = 0
        self.events = 0
        self.drops = 0
        self.device_ms = 0.0

    def register(self) -> None:
        with _live_lock:
            _live[self.run_id] = self

    def unregister(self) -> None:
        with _live_lock:
            _live.pop(self.run_id, None)


def live_sources() -> list[SketchStatsSource]:
    with _live_lock:
        return list(_live.values())


@dataclasses.dataclass
class SketchStats(Event):
    runid: str = col("", width=14)
    gadget: str = col("", width=18)
    steps: int = col(0, width=8, group="sum", dtype=np.int64)
    events: int = col(0, width=12, group="sum", dtype=np.int64)
    drops: int = col(0, width=8, group="sum", dtype=np.int64)
    rate: float = col(0.0, width=12, precision=0, dtype=np.float32)


class TopSketch(IntervalGadget):
    def setup(self, ctx) -> None:
        self._prev: dict[str, tuple[int, int]] = {}
        self._t = time.monotonic()

    def collect(self, ctx) -> list[SketchStats]:
        now = time.monotonic()
        dt = max(now - self._t, 1e-6)
        self._t = now
        rows = []
        for src in live_sources():
            pe, ps = self._prev.get(src.run_id, (0, 0))
            devents = src.events - pe
            dsteps = src.steps - ps
            self._prev[src.run_id] = (src.events, src.steps)
            rows.append(SketchStats(
                runid=src.run_id, gadget=src.gadget, steps=dsteps,
                events=devents, drops=src.drops, rate=devents / dt,
            ))
        return rows


@register
class TopSketchDesc(GadgetDesc):
    name = "sketch"
    category = "top"
    gadget_type = GadgetType.TRACE_INTERVALS
    description = "Top analytics-plane pipelines (self-observability)"
    event_cls = SketchStats

    def params(self) -> ParamDescs:
        return interval_params("-events")

    def new_instance(self, ctx) -> TopSketch:
        return TopSketch(ctx)
