"""Parser: the untyped facade binding columns + filters + sort to callbacks.

Reference contract: pkg/parser/parser.go:41-96 — frontends (CLI, agent
service) hold a Parser, not the typed event class: SetEventCallback wires a
formatter; event handlers run filter→format; JSONHandlerFunc(Array) decode
remote events; EnableSnapshots/EnableCombiner attach the interval/one-shot
merge machinery (:123-153).

The port's copy of ``inspektor_gadget_tpu/parser.py``.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Sequence

from .columns import (
    Columns,
    TextFormatter,
    match_event,
    parse_filters,
    parse_sort,
    sort_events,
)
from .snapshotcombiner import SnapshotCombiner


class Parser:
    def __init__(self, columns: Columns):
        self.columns = columns
        self._filters = []
        self._sort = []
        self._callback: Callable[[Any], None] | None = None
        self._array_callback: Callable[[list], None] | None = None
        self._combiner: SnapshotCombiner | None = None
        self._accumulated: list = []

    # configuration (ref: parser.go option setters) -------------------------

    def set_filters(self, specs: str | Sequence[str]) -> None:
        self._filters = parse_filters(specs, self.columns)

    def set_sort(self, spec: str) -> None:
        self._sort = parse_sort(spec, self.columns)

    def set_event_callback(self, fn: Callable[[Any], None]) -> None:
        self._callback = fn

    def set_event_callback_array(self, fn: Callable[[list], None]) -> None:
        self._array_callback = fn

    def enable_snapshots(self, ttl_ticks: int = 2) -> None:
        """Interval merge mode (ref: EnableSnapshots :123-140)."""
        self._combiner = SnapshotCombiner(ttl_ticks=ttl_ticks)

    # event paths -----------------------------------------------------------

    def event_handler(self, ev: Any) -> None:
        if self._filters and not match_event(ev, self._filters, self.columns):
            return
        if self._callback is not None:
            self._callback(ev)

    def event_handler_array(self, evs: list) -> None:
        rows = [e for e in evs
                if not self._filters or match_event(e, self._filters, self.columns)]
        if self._sort:
            rows = sort_events(rows, self._sort, self.columns)
        if self._array_callback is not None:
            self._array_callback(rows)

    def json_handler(self, node: str):
        """Remote single-event decode (ref: JSONHandlerFunc)."""

        def handle(payload: str | bytes) -> None:
            d = json.loads(payload)
            ev = self.columns.from_dict(d)
            if not ev.node:
                ev.node = node
            self.event_handler(ev)

        return handle

    def json_handler_array(self, node: str):
        """Remote array decode keyed by node (ref: JSONHandlerFuncArray
        :265-286): arrays land in the snapshot combiner when enabled."""

        def handle(payload: str | bytes) -> None:
            rows = []
            for d in json.loads(payload):
                ev = self.columns.from_dict(d)
                if not ev.node:
                    ev.node = node
                rows.append(ev)
            if self._combiner is not None:
                self._combiner.add_snapshot(node, rows)
            else:
                self.event_handler_array(rows)

        return handle

    def tick(self) -> None:
        """Interval merge tick (the grpc runtime's ticker calls this)."""
        if self._combiner is not None:
            self.event_handler_array(self._combiner.get_snapshots())

    # one-shot accumulation (ref: EnableCombiner :142-153) ------------------

    def accumulate(self, evs: list) -> None:
        self._accumulated.extend(evs)

    def flush(self) -> None:
        if self._accumulated:
            self.event_handler_array(self._accumulated)
            self._accumulated = []

    def formatter(self, **kw) -> TextFormatter:
        return TextFormatter(self.columns, **kw)
