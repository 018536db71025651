"""top/windows — the sketch-history plane's sealed windows rendered
through the column system.

The history sibling of top/recordings: every tick lists the node's most
recently sealed windows (header rows only — listing never decodes
payloads), so watching what the store holds, how fresh it is, and which
subpopulations each window carries costs the same `ig-tpu top windows`
muscle memory as any other gadget.

The port's copy of ``inspektor_gadget_tpu/gadgets/top/windows.py``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ...columns import col
from ...types import Event
from ..interface import GadgetDesc, GadgetType
from ..interval_gadget import IntervalGadget, interval_params
from ..registry import register


@dataclasses.dataclass
class WindowRow(Event):
    gadget: str = col("", width=20)
    window: int = col(0, width=8, dtype=np.int64)
    seq: int = col(0, width=8, dtype=np.int64)
    events: int = col(0, width=10, dtype=np.int64)
    drops: int = col(0, width=8, dtype=np.int64)
    slices: int = col(0, width=8, dtype=np.int64)
    span_s: float = col(0.0, width=8, precision=1, dtype=np.float32)
    age_s: float = col(0.0, width=8, precision=1, dtype=np.float32)


class TopWindows(IntervalGadget):
    def collect(self, ctx) -> list[WindowRow]:
        from ...history import HISTORY
        now = time.time()
        rows = []
        for h in HISTORY.list_windows():
            rows.append(WindowRow(
                timestamp=time.time_ns(),
                gadget=h.get("gadget", ""),
                window=int(h.get("window", 0)),
                seq=int(h.get("seq", 0)),
                events=int(h.get("events", 0)),
                drops=int(h.get("drops", 0)),
                slices=len(h.get("keys") or []),
                span_s=max(float(h.get("end_ts", 0.0))
                           - float(h.get("start_ts", 0.0)), 0.0),
                age_s=max(now - float(h.get("end_ts", now)), 0.0),
            ))
        return rows


@register
class TopWindowsDesc(GadgetDesc):
    name = "windows"
    category = "top"
    gadget_type = GadgetType.TRACE_INTERVALS
    description = "Top sealed sketch windows (history store contents)"
    event_cls = WindowRow

    def params(self):
        return interval_params("age_s")

    def new_instance(self, ctx) -> TopWindows:
        return TopWindows(ctx)
