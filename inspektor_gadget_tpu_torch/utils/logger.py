"""Leveled logger facade (ref: pkg/logger/logger.go, 191 LoC).

A thin contract over stdlib logging so components depend on the facade, not
a backend — the role the reference's Logger interface plays over logrus.
The gRPC transport encodes severity in the high bits of the event type
(agent/wire.py EV_LOG_SHIFT; ref grpc-runtime.go:326-328), so remote log
records multiplex into the event stream; StreamLogger is the server-side
adapter that does that encoding and threads run/trace IDs into the stream
header so client-side lines correlate with spans. Every ig-tpu.* record
also lands in the process flight recorder (telemetry/tracing.py attaches
its handler to the "ig-tpu" root logger).

The port's copy of ``inspektor_gadget_tpu/utils/logger.py``.
"""

from __future__ import annotations

import logging
from typing import Callable

# severity levels mirroring the reference's (logrus) ordering
PANIC, FATAL, ERROR, WARN, INFO, DEBUG, TRACE = range(7)

_TO_STD = {
    PANIC: logging.CRITICAL, FATAL: logging.CRITICAL, ERROR: logging.ERROR,
    WARN: logging.WARNING, INFO: logging.INFO, DEBUG: logging.DEBUG,
    TRACE: logging.DEBUG,
}


def std_from_severity(sev: int) -> int:
    """Reference severity (wire type bits) → stdlib levelno. Exact
    inverse of severity_from_std: PANIC/FATAL→CRITICAL, ERROR→ERROR,
    WARN→WARNING, INFO→INFO, DEBUG/TRACE→DEBUG."""
    return min(logging.CRITICAL, max(logging.DEBUG, 60 - sev * 10))


def severity_from_std(levelno: int) -> int:
    """stdlib levelno → reference severity (for the wire's type bits)."""
    if levelno >= logging.CRITICAL:
        return FATAL
    if levelno >= logging.ERROR:
        return ERROR
    if levelno >= logging.WARNING:
        return WARN
    if levelno >= logging.INFO:
        return INFO
    return DEBUG


def get_logger(name: str = "ig-tpu", level: int = INFO) -> logging.Logger:
    """Get a component logger. The level is only applied to a logger that
    has never been configured (level NOTSET): setting it unconditionally
    made the LAST caller win across every component sharing the name —
    a tpusketch import could silence the agent mid-flight."""
    log = logging.getLogger(name)
    if log.level == logging.NOTSET:
        log.setLevel(_TO_STD[level])
    return log


class StreamLogger:
    """Adapter publishing log records into a gadget event stream with
    severity-in-type encoding (ref: pkg/gadget-service/logger.go). The
    stream header carries run_id/trace_id so the client can correlate a
    remote log line with the spans of the run that produced it."""

    def __init__(self, push: Callable[[int, dict, bytes], None],
                 shift: int = 16, run_id: str = "", trace_id: str = ""):
        self._push = push
        self._shift = shift
        self.run_id = run_id
        self.trace_id = trace_id

    def log(self, severity: int, msg: str) -> None:
        header: dict = {}
        if self.run_id:
            header["run_id"] = self.run_id
        if self.trace_id:
            header["trace_id"] = self.trace_id
        self._push(severity << self._shift, header,
                   msg.encode("utf-8", "replace"))

    def error(self, msg: str) -> None:
        self.log(ERROR, msg)

    def warn(self, msg: str) -> None:
        self.log(WARN, msg)

    def info(self, msg: str) -> None:
        self.log(INFO, msg)

    def debug(self, msg: str) -> None:
        self.log(DEBUG, msg)


class StreamLogHandler(logging.Handler):
    """stdlib handler forwarding a run's logger records into its event
    stream via a StreamLogger (attached per run by agent/service.py, so
    ctx.logger warnings reach the remote client)."""

    def __init__(self, stream_logger: StreamLogger,
                 level: int = logging.INFO):
        super().__init__(level=level)
        self._sl = stream_logger

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._sl.log(severity_from_std(record.levelno),
                         record.getMessage())
        except Exception:  # noqa: BLE001 — logging must never kill the stream
            self.handleError(record)
