"""The port's telemetry plane: the metrics registry and the pipeline
health accounting of the ingest path (numpy only).

    from ..telemetry import counter
    _hits = counter("ig_ingest_pool_hits_total", "...", ("lane",))
    _hits.labels(lane="0").inc()
"""

from .pipeline import LagSketch, PipelineStats, live_stats
from .registry import (DEFAULT_BUCKETS, REGISTRY, Counter, Gauge, Histogram, MetricFamily,
                       Registry, Span, counter, gauge, histogram, render_prometheus, snapshot)

__all__ = ["DEFAULT_BUCKETS", "REGISTRY", "Counter", "Gauge", "Histogram", "LagSketch",
           "MetricFamily", "PipelineStats", "Registry", "Span", "counter", "gauge",
           "histogram", "live_stats", "render_prometheus", "snapshot"]
