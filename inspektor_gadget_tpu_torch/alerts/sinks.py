"""Pluggable alert delivery.

The sink API is deliberately tiny — `emit(AlertEvent)` — so operators can
bolt on pagers/webhooks without touching the engine. Two built-ins:

- LogSink: one log line per transition on the run's logger (which the
  agent multiplexes onto the client stream, so remote transitions show up
  client-side even without the typed EV_ALERT path).
- WebhookFileSink: appends each transition as one JSON line to a file —
  the webhook stand-in tests and air-gapped deployments assert against
  (the shared utils/journal.py append + torn-tail-read discipline).

The port's copy of ``inspektor_gadget_tpu/alerts/sinks.py``.
"""

from __future__ import annotations

import logging
from typing import Protocol, runtime_checkable

from ..utils.journal import append_line, read_jsonl
from .engine import AlertEvent

_SEV_LEVEL = {"info": logging.INFO, "warning": logging.WARNING,
              "critical": logging.ERROR}


@runtime_checkable
class AlertSink(Protocol):
    def emit(self, event: AlertEvent) -> None: ...


class LogSink:
    def __init__(self, logger: logging.Logger | None = None):
        self.logger = logger or logging.getLogger("ig-tpu.alerts")

    def emit(self, event: AlertEvent) -> None:
        self.logger.log(
            _SEV_LEVEL.get(event.severity, logging.WARNING),
            "alert %s %s%s: value=%.6g threshold=%.6g [%s]",
            event.rule, event.transition,
            f" key={event.key}" if event.key else "",
            event.value, event.threshold, event.severity)


class WebhookFileSink:
    """JSON-lines delivery to a file path (the test/webhook stand-in).

    Each transition is one `json.dumps` + single O_APPEND write, so
    concurrent engines can share a file without interleaving lines.
    """

    def __init__(self, path: str):
        self.path = path

    def emit(self, event: AlertEvent) -> None:
        append_line(self.path, event.to_dict())

    @staticmethod
    def read(path: str) -> list[dict]:
        """Read back a sink file, tolerating a crash-truncated tail."""
        try:
            return read_jsonl(path, on_bad="stop").records
        except OSError:
            return []
