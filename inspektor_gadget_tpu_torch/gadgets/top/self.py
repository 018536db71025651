"""top/self — self-stats of the native capture plane (top/ebpf parity).

Reference: pkg/gadgets/top/ebpf reports every loaded BPF program with its
runtime/run-count from kernel stats (tracer.go:55-418, pkg/bpfstats
BPF_ENABLE_STATS). The capture plane here is C++ threads instead of BPF
programs, so the analogue enumerates every live native source through the
C API (ig_sources_stats): per-source capture-thread CPU time, ring
occupancy/capacity, produced/consumed/drops/filtered — while it runs,
alongside whatever gadgets own those sources.

Interval semantics match the top family: CPU% and event rate are deltas
over the drain interval; totals are cumulative.

The port's copy of ``inspektor_gadget_tpu/gadgets/top/self.py``: its rows
are the sources of the port's capture library only.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ...columns import col
from ...params import ParamDescs
from ...types import Event
from ..interface import GadgetDesc, GadgetType
from ..interval_gadget import IntervalGadget, interval_params
from ..registry import register
from ...sources.bridge import sources_stats


@dataclasses.dataclass
class SourceStats(Event):
    srcid: int = col(0, width=6, dtype=np.int64)
    source: str = col("", width=14)
    cpu_pct: float = col(0.0, width=7, precision=2, dtype=np.float32)
    rate: float = col(0.0, width=11, precision=0, dtype=np.float32)
    produced: int = col(0, width=11, group="sum", dtype=np.int64)
    ring: str = col("", width=12)
    drops: int = col(0, width=8, group="sum", dtype=np.int64)
    filtered: int = col(0, width=9, group="sum", dtype=np.int64)


class TopSelf(IntervalGadget):
    def setup(self, ctx) -> None:
        # (produced, cpu_ns) at the previous tick, keyed by source id —
        # seeded from a baseline snapshot so the first tick reports true
        # deltas, not a long-lived source's cumulative totals over one
        # interval (which would read as e.g. 3000% CPU)
        self._prev: dict[int, tuple[int, int]] = {
            s["id"]: (s["produced"], s["cpu_ns"]) for s in sources_stats()
        }
        self._t = time.monotonic()

    def collect(self, ctx) -> list[SourceStats]:
        now = time.monotonic()
        dt = max(now - self._t, 1e-6)
        self._t = now
        rows = []
        live = sources_stats()
        seen = set()
        for s in live:
            sid = s["id"]
            seen.add(sid)
            first_sighting = sid not in self._prev
            pp, pc = self._prev.get(sid, (s["produced"], s["cpu_ns"]))
            self._prev[sid] = (s["produced"], s["cpu_ns"])
            # a source first seen this tick reports zero deltas (its
            # cumulative counters cover its whole lifetime, not this tick)
            dprod = 0 if first_sighting else s["produced"] - pp
            dcpu = 0 if first_sighting else s["cpu_ns"] - pc
            rows.append(SourceStats(
                timestamp=time.time_ns(),
                srcid=sid,
                source=s["kind_name"],
                cpu_pct=100.0 * dcpu / (dt * 1e9),
                rate=dprod / dt,
                produced=s["produced"],
                ring=f"{s['ring_len']}/{s['ring_cap']}",
                drops=s["drops"],
                filtered=s["filtered"],
            ))
        # forget sources that were destroyed
        for sid in list(self._prev):
            if sid not in seen:
                del self._prev[sid]
        return rows


@register
class TopSelfDesc(GadgetDesc):
    name = "self"
    category = "top"
    gadget_type = GadgetType.TRACE_INTERVALS
    description = "Top native capture sources (thread CPU, rings, loss)"
    event_cls = SourceStats

    def params(self) -> ParamDescs:
        return interval_params("-cpu_pct")

    def new_instance(self, ctx) -> TopSelf:
        return TopSelf(ctx)
