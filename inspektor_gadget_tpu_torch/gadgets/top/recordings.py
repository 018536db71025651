"""top/recordings — the capture plane's recording lifecycle rendered
through the column system.

The capture sibling of top/alerts: every tick lists the node's active
recordings (live journal stats from the RecordingManager) and the
stopped ones found under the capture base dir, one row per recording —
so watching what is being recorded, how much disk it holds, and what
survived a crash costs the same `ig-tpu top recordings` muscle memory as
any other gadget.

The port's copy of ``inspektor_gadget_tpu/gadgets/top/recordings.py``.
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
class RecordingRow(Event):
    id: str = col("", width=20)
    state: str = col("", width=10)
    journals: int = col(0, width=8, dtype=np.int64)
    segments: int = col(0, width=8, dtype=np.int64)
    records: int = col(0, width=10, dtype=np.int64)
    bytes: int = col(0, width=12, dtype=np.int64)
    age_s: float = col(0.0, width=8, precision=1, dtype=np.float32)


class TopRecordings(IntervalGadget):
    def collect(self, ctx) -> list[RecordingRow]:
        from ...capture import RECORDINGS
        from ...capture.journal import dir_stats
        now = time.time()
        rows = []
        for rec in RECORDINGS.list():
            path = rec.get("path", "")
            segments, total = dir_stats(path) if path else (0, 0)
            open_journals = rec.get("open_journals") or {}
            journals = (len(open_journals) if rec.get("state") == "recording"
                        else len(rec.get("journals") or []))
            records = sum(int(s.get("next_seq", 0))
                          for s in open_journals.values())
            rows.append(RecordingRow(
                timestamp=time.time_ns(),
                id=rec.get("id", ""),
                state=rec.get("state", ""),
                journals=journals,
                segments=segments,
                records=records,
                bytes=total,
                age_s=max(now - float(rec.get("started_ts") or now), 0.0),
            ))
        return rows


@register
class TopRecordingsDesc(GadgetDesc):
    name = "recordings"
    category = "top"
    gadget_type = GadgetType.TRACE_INTERVALS
    description = "Top capture recordings (journal lifecycle and disk usage)"
    event_cls = RecordingRow

    def params(self):
        return interval_params("-age_s")

    def new_instance(self, ctx) -> TopRecordings:
        return TopRecordings(ctx)
