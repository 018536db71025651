"""IntervalGadget: base for top-style gadgets (type traceIntervals).

Reference contract: pkg/gadgets/top/* — a ticker drains and resets a stats
map every interval (top/file/tracer.go:222-272), the event is an *array* of
per-key Stats sorted by the gadget's sort param and truncated to max-rows
(gadget.go:43-66); the CLI re-renders the table per tick (cmd/common/
registry.go:330-344).

Subclasses implement collect() -> list[event] (drain + reset).

The port's copy of ``inspektor_gadget_tpu/gadgets/interval_gadget.py``.
"""

from __future__ import annotations

from typing import Any, Callable

from ..columns import parse_sort, sort_events
from ..params import ParamDesc, ParamDescs, TypeHint, validate_int_range
from .context import GadgetContext


def interval_params(default_sort: str) -> ParamDescs:
    return ParamDescs([
        ParamDesc(key="interval", default="1s", type_hint=TypeHint.DURATION,
                  description="stats drain interval"),
        ParamDesc(key="max-rows", default="20", type_hint=TypeHint.INT,
                  validator=validate_int_range(1, 10000),
                  description="rows to keep per interval"),
        ParamDesc(key="sort", default=default_sort,
                  description="sort spec, e.g. -reads,comm"),
    ])


class IntervalGadget:
    def __init__(self, ctx: GadgetContext):
        self.ctx = ctx
        p = ctx.gadget_params
        self.interval = (p.get("interval").as_duration() or 1.0) if "interval" in p else 1.0
        self.max_rows = p.get("max-rows").as_int() if "max-rows" in p else 20
        self.sort_spec = p.get("sort").as_string() if "sort" in p else ""
        self._array_handler: Callable[[list], None] | None = None

    def set_event_handler_array(self, handler: Callable[[list], None]) -> None:
        self._array_handler = handler

    # subclass API ----------------------------------------------------------

    def setup(self, ctx: GadgetContext) -> None:
        pass

    def teardown(self, ctx: GadgetContext) -> None:
        pass

    def collect(self, ctx: GadgetContext) -> list[Any]:
        raise NotImplementedError

    # run loop --------------------------------------------------------------

    def run(self, ctx: GadgetContext) -> None:
        self.setup(ctx)
        try:
            while not ctx.done:
                if ctx.sleep_or_done(self.interval):
                    break
                rows = self.collect(ctx)
                rows = self._sort_truncate(rows)
                if self._array_handler is not None:
                    self._array_handler(rows)
        finally:
            self.teardown(ctx)

    def _sort_truncate(self, rows: list[Any]) -> list[Any]:
        cols = self.ctx.columns
        if self.sort_spec and cols is not None:
            try:
                rows = sort_events(rows, parse_sort(self.sort_spec, cols), cols)
            except ValueError as e:
                self.ctx.logger.warning("bad sort spec: %s", e)
        return rows[: self.max_rows]
