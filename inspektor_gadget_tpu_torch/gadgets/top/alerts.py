"""top/alerts — active alert lifecycle rendered through the column system.

The alerting-plane sibling of top/metrics: every tick walks the
process-wide active-alert table (node-scope entries from this process's
engines, cluster-scope entries from the GrpcRuntime fold-in) and emits
one row per (scope, rule, key) with its state, triggering value, node
list, and age — so watching alerts costs the same `ig-tpu top alerts`
muscle memory as watching any other gadget.

The port's copy of ``inspektor_gadget_tpu/gadgets/top/alerts.py``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ...columns import col
from ...params import ParamDesc, ParamDescs, TypeHint
from ...types import Event
from ..interface import GadgetDesc, GadgetType
from ..interval_gadget import IntervalGadget, interval_params
from ..registry import register


@dataclasses.dataclass
class AlertRow(Event):
    rule: str = col("", width=20)
    state: str = col("", width=9)
    severity: str = col("", width=9)
    key: str = col("", width=18)
    scope: str = col("", width=8)
    value: float = col(0.0, width=12, precision=4, dtype=np.float64)
    threshold: float = col(0.0, width=12, precision=4, dtype=np.float64)
    nodes: str = col("", width=24)
    age_s: float = col(0.0, width=8, precision=1, dtype=np.float32)


class TopAlerts(IntervalGadget):
    def collect(self, ctx) -> list[AlertRow]:
        from ...alerts import ACTIVE
        include_resolved = True
        p = ctx.gadget_params
        if "all" in p:
            include_resolved = p.get("all").as_bool()
        now = time.time()
        rows = []
        for a in ACTIVE.all():
            if not include_resolved and a.get("state") == "resolved":
                continue
            rows.append(AlertRow(
                timestamp=time.time_ns(),
                rule=a.get("rule", ""),
                state=a.get("state", ""),
                severity=a.get("severity", ""),
                key=a.get("key", ""),
                scope=a.get("scope", ""),
                value=float(a.get("value", 0.0)),
                threshold=float(a.get("threshold", 0.0)),
                nodes=",".join(a.get("nodes") or []),
                age_s=max(now - float(a.get("since") or now), 0.0),
            ))
        return rows


@register
class TopAlertsDesc(GadgetDesc):
    name = "alerts"
    category = "top"
    gadget_type = GadgetType.TRACE_INTERVALS
    description = "Top active alerts (sketch-to-signal detection plane)"
    event_cls = AlertRow

    def params(self) -> ParamDescs:
        p = interval_params("-age_s")
        p.append(ParamDesc(key="all", default="true",
                           type_hint=TypeHint.BOOL,
                           description="include recently-resolved alerts"))
        return p

    def new_instance(self, ctx) -> TopAlerts:
        return TopAlerts(ctx)
