"""top/metrics — the telemetry registry rendered through the column system.

Reference analogue: `kubectl gadget top ebpf` + the otel metrics exporter,
folded into one interval gadget: every tick walks the process-wide
telemetry registry (sources, operator chain, tpusketch device plane, agent
streams, runtime fan-out) and emits one row per sample with its per-tick
rate, so the formatter path displays the framework's self-observability
exactly like any other gadget. Histogram buckets are elided (the _sum and
_count samples remain); scrape /metrics for full distributions.

The port's copy of ``inspektor_gadget_tpu/gadgets/top/metrics.py``: it
walks the port's own registry, never the JAX package's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ...columns import col
from ...params import ParamDescs
from ...telemetry import REGISTRY
from ...types import Event
from ..interface import GadgetDesc, GadgetType
from ..interval_gadget import IntervalGadget, interval_params
from ..registry import register


@dataclasses.dataclass
class MetricRow(Event):
    metric: str = col("", width=36)
    labels: str = col("", width=30)
    kind: str = col("", width=9)
    value: float = col(0.0, width=16, precision=1, dtype=np.float64)
    rate: float = col(0.0, width=12, precision=1, dtype=np.float32)


class TopMetrics(IntervalGadget):
    def setup(self, ctx) -> None:
        # prior value per sample so counters report per-tick rates; seeded
        # now so the first tick shows deltas, not lifetime totals
        self._prev: dict[str, float] = {
            key: v for key, _k, v in self._walk()}
        self._t = time.monotonic()

    @staticmethod
    def _walk():
        for name, kind, lbl, value in REGISTRY.samples():
            if kind == "histogram" and name.endswith("_bucket"):
                continue
            yield f"{name}{lbl}", kind, value

    def collect(self, ctx) -> list[MetricRow]:
        now = time.monotonic()
        dt = max(now - self._t, 1e-6)
        self._t = now
        rows = []
        seen = set()
        for key, kind, value in self._walk():
            seen.add(key)
            prev = self._prev.get(key, 0.0)
            self._prev[key] = value
            name, _, lbl = key.partition("{")
            rows.append(MetricRow(
                timestamp=time.time_ns(),
                metric=name,
                labels=("{" + lbl) if lbl else "",
                kind=kind,
                value=value,
                # gauges report level, not flow
                rate=(value - prev) / dt if kind != "gauge" else 0.0,
            ))
        for key in list(self._prev):
            if key not in seen:
                del self._prev[key]
        return rows


@register
class TopMetricsDesc(GadgetDesc):
    name = "metrics"
    category = "top"
    gadget_type = GadgetType.TRACE_INTERVALS
    description = "Top telemetry-registry samples (framework self-metrics)"
    event_cls = MetricRow

    def params(self) -> ParamDescs:
        return interval_params("-rate")

    def new_instance(self, ctx) -> TopMetrics:
        return TopMetrics(ctx)
