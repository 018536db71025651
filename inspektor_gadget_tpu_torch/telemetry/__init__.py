"""The port's telemetry plane: the metrics registry, the span tree and
flight recorder (`telemetry.tracing`), and the pipeline health
accounting of the ingest path (numpy only).

    from ..telemetry import counter
    _hits = counter("ig_ingest_pool_hits_total", "...", ("lane",))
    _hits.labels(lane="0").inc()
"""

from .http import MetricsServer, parse_addr
from .pipeline import LagSketch, PipelineStats, live_stats
from .registry import (DEFAULT_BUCKETS, REGISTRY, Counter, Gauge, Histogram, MetricFamily,
                       Registry, Span, counter, gauge, histogram, render_prometheus, snapshot)
from .tracing import (RECORDER, TRACER, FlightRecorder, FlightRecorderHandler, SpanContext,
                      SpanRecord, Tracer, device_annotation, export_chrome,
                      install_crash_handlers, parse_traceparent)

__all__ = ["DEFAULT_BUCKETS", "RECORDER", "REGISTRY", "TRACER", "Counter", "FlightRecorder",
           "FlightRecorderHandler", "Gauge", "Histogram", "LagSketch", "MetricFamily",
           "MetricsServer", "PipelineStats", "Registry", "Span", "SpanContext", "SpanRecord",
           "Tracer", "counter", "device_annotation", "export_chrome", "gauge", "histogram",
           "install_crash_handlers", "live_stats", "parse_addr", "parse_traceparent",
           "render_prometheus", "snapshot"]
