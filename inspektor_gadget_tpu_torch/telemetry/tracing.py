"""Distributed tracing plane: spans, context propagation, flight recorder.

Where registry.py answers "how much / how often", this module answers
"where did THIS run spend its time". One process-wide Tracer keeps a
bounded ring of finished spans; W3C-style trace/span IDs propagate
client → gRPC fan-out → agent → operator chain → device plane (the
`traceparent` header rides the RunGadget request, agent/wire.py carries
it in stream metadata), so one gadget run is one trace across every
process it touched. Export is Chrome trace-event JSON ("traceEvents"),
loadable in Perfetto / chrome://tracing via `ig-tpu debug trace export`.

On top of the same ring sits the flight recorder: the last N spans, log
records (utils/logger.py attaches a handler into it), errors, and facts
(probed platform, node name). It is served through the agent's DumpState
RPC, the `ig-tpu debug flight-record` verb, and dumped to a file on
SIGTERM / unhandled crash — a wedged or killed process leaves evidence.

Cost model: spans are batch/RPC/run-grain like the metrics plane — never
per event. An unsampled trace (head sampling, decided once at mint time)
propagates context but records nothing.

The port's copy of ``inspektor_gadget_tpu/telemetry/tracing.py``, as it
is but for three things. While a ``torch.profiler`` records, every
ambient span is also a ``record_function`` range of the same name (or
the `label` it is given), so program spans share the device trace's
clock; with no profiler running no range is entered, which the check
`profiling` costs nothing to make (no torch import, no dispatcher call).
Ids come from a private `random.Random` (the reference calls `uuid4`, a
syscall a span), in the same hex lengths. And `load_dump` reads its
JSON tolerantly.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import logging
import os
import random
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Iterable

from .registry import counter

TRACEPARENT = "traceparent"  # W3C header key, also the wire metadata key

_tm_spans = counter("ig_trace_spans_total", "spans recorded into the ring")
_tm_evicted = counter("ig_trace_spans_evicted_total",
                      "spans evicted from the bounded ring")
_tm_unsampled = counter("ig_trace_spans_unsampled_total",
                        "spans skipped by head sampling")


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """Propagatable identity of a span (W3C trace-context shaped)."""

    trace_id: str            # 32 lowercase hex
    span_id: str             # 16 lowercase hex
    sampled: bool = True

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-" \
               f"{'01' if self.sampled else '00'}"


def parse_traceparent(value: str) -> SpanContext | None:
    """'00-<32hex>-<16hex>-<2hex>' → SpanContext; None on malformed input
    (a bad peer header degrades to a fresh trace, never an error)."""
    if not isinstance(value, str):
        return None
    parts = value.split("-")
    if len(parts) != 4:
        return None
    _ver, trace_id, span_id, flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    return SpanContext(trace_id=trace_id, span_id=span_id,
                       sampled=bool(int(flags, 16) & 1))


@dataclasses.dataclass
class SpanRecord:
    """One finished span as retained in the ring / exported."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str
    start: float             # epoch seconds (cross-process alignable)
    duration: float          # seconds
    node: str = ""
    thread: str = ""
    error: str = ""
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)


class Span:
    """Context-manager span. Entering sets it as the thread's current
    span (children parent to it implicitly); exiting records it into the
    tracer ring — unless the trace is unsampled, in which case only the
    context propagates."""

    __slots__ = ("_tracer", "name", "context", "parent_id", "attrs",
                 "_t0", "_start", "_token", "_ambient", "error", "label",
                 "duration", "_range")

    def __init__(self, tracer: "Tracer", name: str, context: SpanContext,
                 parent_id: str, attrs: dict[str, Any] | None,
                 ambient: bool = True, label: str | None = None):
        self._tracer = tracer
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else {}
        self.error = ""
        self.label = label  # the profiler range's name, if not `name`
        self.duration = 0.0  # seconds, once exited
        self._t0 = 0.0
        self._start = 0.0
        self._ambient = ambient
        self._token: contextvars.Token | None = None
        self._range = None

    def set_attr(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def __enter__(self) -> "Span":
        self._start = time.time()
        if self._ambient:
            # a held-open (non-ambient) span may end on another thread, so
            # only ambient spans open a profiler range
            if profiling():
                self._range = _record_function(self.label or self.name)
                self._range.__enter__()
            self._token = self._tracer._current.set(self.context)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, _tb) -> None:
        dur = self.duration = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._token is not None:
            self._tracer._current.reset(self._token)
            self._token = None
        if exc is not None:
            self.error = f"{type(exc).__name__}: {exc}"
        if self.context.sampled:
            self._tracer._record(SpanRecord(
                name=self.name, trace_id=self.context.trace_id,
                span_id=self.context.span_id, parent_id=self.parent_id,
                start=self._start, duration=dur, node=self._tracer.node,
                thread=threading.current_thread().name,
                error=self.error, attrs=self.attrs))
        else:
            _tm_unsampled.inc()


# span and trace ids: a private generator (a global `random.seed` in the
# process cannot make two runs' ids collide), seeded from the OS and
# re-seeded in a forked child
_ids = random.Random()
if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_ids.seed)


def _new_trace_id() -> str:
    return f"{_ids.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_ids.getrandbits(64):016x}"


def profiling() -> bool:
    """True while a ``torch.profiler`` (or the autograd profiler)
    records: torch's own Python flag, read without importing torch (no
    profiler runs before its module is loaded)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


def _record_function(name: str):
    """A ``record_function(name)`` range (torch is loaded: `profiling`)."""
    return sys.modules["torch.autograd.profiler"].record_function(name)


class Tracer:
    """Process-wide span store: bounded ring retention, head sampling,
    contextvar-based implicit parenting within a thread."""

    def __init__(self, capacity: int = 4096, sample_rate: float = 1.0,
                 node: str = ""):
        self.capacity = int(capacity)
        self.sample_rate = float(sample_rate)
        self.node = node
        self._ring: deque[SpanRecord] = deque(maxlen=self.capacity)
        self._mu = threading.Lock()
        self._current: contextvars.ContextVar[SpanContext | None] = \
            contextvars.ContextVar("ig_current_span", default=None)

    # -- span creation ------------------------------------------------------

    def span(self, name: str, parent: SpanContext | None = None,
             attrs: dict[str, Any] | None = None,
             ambient: bool = True, label: str | None = None) -> Span:
        """Open a span. Parent resolution: explicit `parent` wins, else the
        thread's current span, else a new trace is minted (head-sampled).
        ambient=False skips the current-span contextvar entirely — for
        spans held open across yields, where a generator resumed on a
        different worker thread could otherwise strand a dead span as
        that thread's ambient parent forever. While a profiler records,
        an ambient span is also a profiler range named `label`, or the
        span's own name."""
        if parent is None:
            parent = self._current.get()
        if parent is None:
            sampled = random.random() < self.sample_rate
            ctx = SpanContext(_new_trace_id(), _new_span_id(), sampled)
            return Span(self, name, ctx, parent_id="", attrs=attrs,
                        ambient=ambient, label=label)
        ctx = SpanContext(parent.trace_id, _new_span_id(), parent.sampled)
        return Span(self, name, ctx, parent_id=parent.span_id, attrs=attrs,
                    ambient=ambient, label=label)

    def start_trace(self, name: str,
                    attrs: dict[str, Any] | None = None) -> Span:
        """Mint a root span with a fresh trace ID (ignores any current)."""
        sampled = random.random() < self.sample_rate
        ctx = SpanContext(_new_trace_id(), _new_span_id(), sampled)
        return Span(self, name, ctx, parent_id="", attrs=attrs)

    def current_context(self) -> SpanContext | None:
        return self._current.get()

    # -- ring ---------------------------------------------------------------

    def _record(self, rec: SpanRecord) -> None:
        with self._mu:
            if len(self._ring) == self.capacity:
                _tm_evicted.inc()
            self._ring.append(rec)
        _tm_spans.inc()

    def records(self, trace_id: str | None = None) -> list[SpanRecord]:
        with self._mu:
            recs = list(self._ring)
        if trace_id is not None:
            recs = [r for r in recs if r.trace_id == trace_id]
        return recs

    def export(self, trace_id: str | None = None) -> list[dict]:
        return [dataclasses.asdict(r) for r in self.records(trace_id)]

    def reset(self) -> None:
        with self._mu:
            self._ring.clear()


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing loadable)
# ---------------------------------------------------------------------------

def export_chrome(spans: Iterable[dict | SpanRecord],
                  trace_id: str | None = None) -> dict:
    """Span records (dicts or SpanRecords, local and/or fetched from
    agents) → Chrome trace-event JSON. Each node becomes a synthetic
    `pid` with a process_name metadata row; threads map to stable small
    `tid`s; spans are complete ("X") events with ts/dur in µs and span
    identity in args."""
    norm: list[dict] = []
    seen: set[str] = set()
    for s in spans:
        d = dataclasses.asdict(s) if isinstance(s, SpanRecord) else dict(s)
        if trace_id is not None and d.get("trace_id") != trace_id:
            continue
        sid = d.get("span_id", "")
        if sid and sid in seen:  # client + agent rings may overlap in-process
            continue
        seen.add(sid)
        norm.append(d)
    norm.sort(key=lambda d: d.get("start", 0.0))

    pids: dict[str, int] = {}
    tids: dict[tuple[int, str], int] = {}
    events: list[dict] = []
    for d in norm:
        proc = d.get("node") or "client"
        pid = pids.setdefault(proc, len(pids) + 1)
        tkey = (pid, d.get("thread") or "main")
        tid = tids.setdefault(tkey, len(tids) + 1)
        args = {"trace_id": d.get("trace_id", ""),
                "span_id": d.get("span_id", ""),
                "parent_id": d.get("parent_id", "")}
        if d.get("error"):
            args["error"] = d["error"]
        args.update(d.get("attrs") or {})
        events.append({
            "name": d.get("name", "?"), "ph": "X", "cat": "ig-tpu",
            "ts": round(d.get("start", 0.0) * 1e6, 3),
            "dur": round(d.get("duration", 0.0) * 1e6, 3),
            "pid": pid, "tid": tid, "args": args,
        })
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": proc}} for proc, pid in pids.items()]
    meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
              "args": {"name": tname}}
             for (pid, tname), tid in tids.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def device_annotation(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    records, so work outside any span lines up with the kernels in the
    same profiler timeline; otherwise a no-op context."""
    return _record_function(name) if profiling() else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Crash-safe black box: last N spans (shared with the tracer ring),
    log records, errors, and facts. snapshot() is the DumpState payload;
    dump() writes it as JSON for post-mortem reads."""

    def __init__(self, tracer: Tracer, max_logs: int = 512,
                 max_errors: int = 128):
        self.tracer = tracer
        self._logs: deque[dict] = deque(maxlen=max_logs)
        self._errors: deque[dict] = deque(maxlen=max_errors)
        self._facts: dict[str, Any] = {}
        self._mu = threading.Lock()

    def record_log(self, entry: dict) -> None:
        with self._mu:
            self._logs.append(entry)

    def record_error(self, kind: str, msg: str, tb: str = "") -> None:
        with self._mu:
            self._errors.append({"ts": time.time(), "kind": kind,
                                 "msg": msg, "traceback": tb})

    def set_fact(self, key: str, value: Any) -> None:
        with self._mu:
            self._facts[key] = value

    def snapshot(self, max_spans: int = 512) -> dict:
        # slice BEFORE converting: asdict over the whole 4096-ring on
        # every DumpState/crash dump would be ~8x the needed work
        spans = [dataclasses.asdict(r)
                 for r in self.tracer.records()[-max_spans:]]
        with self._mu:
            return {
                "pid": os.getpid(),
                "node": self.tracer.node,
                "time": time.time(),
                "facts": dict(self._facts),
                "spans": spans,
                "logs": list(self._logs),
                "errors": list(self._errors),
            }

    def dump(self, path: str, max_spans: int = 512) -> str:
        """Write the snapshot to `path` (best-effort atomically); returns
        the path. Never raises — the dump runs from crash/signal context
        where a second failure must not mask the first."""
        try:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self.snapshot(max_spans), f, default=str)
            os.replace(tmp, path)
        except OSError as e:
            logging.getLogger("ig-tpu.tracing").warning(
                "flight-record dump to %s failed: %s", path, e)
        return path

    def clear(self) -> None:
        with self._mu:
            self._logs.clear()
            self._errors.clear()


def _read_json_file(path: str) -> tuple[dict | None, str]:
    """(document, "") or (None, why) for a whole-file JSON artifact that
    may be crash-truncated: unreadable or torn files are reported, never
    raised."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except OSError as e:
        return None, f"{path}: unreadable ({e.strerror or e})"
    except json.JSONDecodeError as e:
        return None, f"{path}: truncated or corrupt ({e.msg} at line {e.lineno})"
    if not isinstance(doc, dict):
        return None, f"{path}: not a JSON object"
    return doc, ""


def load_dump(path: str) -> tuple[dict | None, str]:
    """Post-mortem read of a flight-recorder dump: (snapshot, "") or
    (None, why). Routed through the shared utils/journal tolerant read —
    a dump truncated by the very crash it documents (or a leftover
    .tmp from an interrupted atomic write) is reported, never raised."""
    doc, err = _read_json_file(path)
    if doc is None:
        # an interrupted atomic dump leaves <path>.tmp.<pid>; the newest
        # one is the best surviving evidence. A tmp can vanish between
        # glob and stat (the dumper's os.replace landing) — never raise
        # from a helper whose contract is reported-not-raised
        import glob

        def _mtime(p: str) -> float:
            try:
                return os.path.getmtime(p)
            except OSError:
                return 0.0

        tmps = sorted(glob.glob(f"{path}.tmp.*"), key=_mtime)
        if tmps:
            doc2, err2 = _read_json_file(tmps[-1])
            if doc2 is not None:
                return doc2, f"recovered from {tmps[-1]} ({err})"
        return None, err
    return doc, ""


class FlightRecorderHandler(logging.Handler):
    """logging.Handler feeding the flight recorder. Picks up `run_id` /
    `trace_id` attrs (StreamLogger threads them onto remote records) so
    flight-recorded log lines correlate with spans."""

    def __init__(self, recorder: FlightRecorder):
        super().__init__(level=logging.DEBUG)
        self.recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:
        try:
            entry = {
                "ts": record.created,
                "level": record.levelname,
                "logger": record.name,
                "msg": record.getMessage(),
                "run_id": getattr(record, "run_id", ""),
                "trace_id": getattr(record, "trace_id", ""),
            }
            self.recorder.record_log(entry)
            if record.levelno >= logging.ERROR:
                tb = ""
                if record.exc_info and record.exc_info[2] is not None:
                    tb = "".join(traceback.format_exception(
                        *record.exc_info))[-2000:]
                self.recorder.record_error("log", entry["msg"], tb)
        except Exception:  # noqa: BLE001 — logging must never take down the app
            self.handleError(record)


def install_crash_handlers(path: str, *,
                           recorder: "FlightRecorder | None" = None,
                           signals: tuple[int, ...] = (signal.SIGTERM,),
                           ) -> Callable[[], None]:
    """Dump the flight record to `path` on unhandled exceptions (main
    thread + threading.excepthook) and on the given signals, then chain
    to the previous handler. Returns an uninstall function (tests)."""
    rec = recorder if recorder is not None else RECORDER

    prev_hook = sys.excepthook

    def hook(tp, val, tb):
        rec.record_error(tp.__name__, str(val),
                         "".join(traceback.format_exception(tp, val, tb))[-4000:])
        rec.dump(path)
        prev_hook(tp, val, tb)

    sys.excepthook = hook

    prev_thook = threading.excepthook

    def thook(args):
        rec.record_error(
            args.exc_type.__name__, str(args.exc_value),
            "".join(traceback.format_exception(
                args.exc_type, args.exc_value, args.exc_traceback))[-4000:])
        rec.dump(path)
        prev_thook(args)

    threading.excepthook = thook

    prev_sig: dict[int, Any] = {}
    for sig in signals:
        def handler(signum, frame, _sig=sig):
            rec.record_error("signal", f"terminated by signal {signum}")
            rec.dump(path)
            prev = prev_sig.get(_sig)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_IGN:
                return  # the signal was a no-op before; keep it one
            else:
                raise SystemExit(128 + signum)
        try:
            prev_sig[sig] = signal.signal(sig, handler)
        except ValueError:  # not the main thread: excepthooks still work
            pass

    def uninstall() -> None:
        sys.excepthook = prev_hook
        threading.excepthook = prev_thook
        for sig, prev in prev_sig.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass

    return uninstall


# The process-wide tracer + flight recorder every layer shares, tunable
# via env (capacity bounds the black box; sample<1 head-samples traces).
TRACER = Tracer(
    capacity=int(os.environ.get("IG_TRACE_CAPACITY", "4096")),
    sample_rate=float(os.environ.get("IG_TRACE_SAMPLE", "1.0")),
)
RECORDER = FlightRecorder(TRACER)

# every process that touches telemetry keeps its recent ig-tpu.* log
# records in the flight recorder (the "ig-tpu" root logger is the
# ancestor of every component logger in this tree)
_root = logging.getLogger("ig-tpu")
if not any(isinstance(h, FlightRecorderHandler) for h in _root.handlers):
    _root.addHandler(FlightRecorderHandler(RECORDER))
