"""Text-column formatter (ref: pkg/columns/formatter/textcolumns, ~714 LoC).

Produces aligned, width-constrained tables with header rows, per-column
ellipsis, and auto-scaling of column widths to the terminal width — the
behavioral contract of the reference's textcolumns formatter (widths from
column metadata, auto-scale in textcolumns.go AdjustWidthsToScreen).

The port's copy of ``inspektor_gadget_tpu/columns/formatter.py``.
"""

from __future__ import annotations

import operator
from typing import Any, Iterable, Mapping

from .columns import Column, Columns
from .ellipsis import truncate


class TextFormatter:
    def __init__(
        self,
        columns: Columns,
        *,
        show_columns: list[str] | None = None,
        max_width: int | None = None,
        divider: str = " ",
        header_style: str = "upper",
    ):
        self.columns = columns
        if show_columns is not None:
            columns.set_visible(show_columns)
        self.divider = divider
        self.header_style = header_style
        self._widths: dict[str, int] = {}
        self._fast: list | None = None
        self._fast_version = -1
        for c in columns.visible():
            self._widths[c.name] = max(c.width, len(c.name))
        if max_width:
            self.adjust_widths(max_width)

    def _width(self, c: Column) -> int:
        """Width for a column, computing a default for columns made
        visible after construction (set_visible with a new name)."""
        w = self._widths.get(c.name)
        if w is None:
            w = self._widths[c.name] = max(c.width, len(c.name))
        return w

    def adjust_widths(self, max_width: int) -> None:
        """Scale non-fixed columns proportionally to fit max_width
        (ref: textcolumns AdjustWidthsToScreen). Invalidates the compiled
        row specs — header and rows must never disagree on widths."""
        self._fast = None
        cols = self.columns.visible()
        for c in cols:
            self._width(c)  # seed widths for columns shown post-init
        total = sum(self._widths[c.name] for c in cols) + len(self.divider) * (len(cols) - 1)
        if total <= max_width:
            return
        fixed = sum(self._widths[c.name] for c in cols if c.fixed)
        flexible = total - fixed - len(self.divider) * (len(cols) - 1)
        budget = max_width - fixed - len(self.divider) * (len(cols) - 1)
        if budget <= 0 or flexible <= 0:
            return
        scale = budget / flexible
        for c in cols:
            if not c.fixed:
                self._widths[c.name] = max(c.min_width, int(self._widths[c.name] * scale))

    def _cell(self, c: Column, text: str) -> str:
        w = self._width(c)
        text = truncate(text, w, c.ellipsis)
        return text.rjust(w) if c.align == "right" else text.ljust(w)

    def header(self) -> str:
        cells = []
        for c in self.columns.visible():
            name = c.name.upper() if self.header_style == "upper" else c.name
            cells.append(self._cell(c, name))
        return self.divider.join(cells).rstrip()

    def _compile_fast(self) -> list:
        """Precompute per-column (getter, width, align, ...) so the
        per-event path (the display hot loop) does no sorted() rebuild,
        no field-string split, no method dispatch. Recompiled whenever
        adjust_widths runs or the Columns visibility/order changes
        (layout_version) — stale specs would render rows that disagree
        with the header."""
        specs = []
        for c in self.columns.visible():
            get = c.extractor or operator.attrgetter(c.field)
            specs.append((get, c.precision, self._width(c),
                          c.align == "right", c.ellipsis))
        self._fast = specs
        self._fast_version = self.columns.layout_version
        return specs

    def format_event(self, event: Any) -> str:
        if isinstance(event, Mapping):  # remote JSON rows: generic path
            cells = [self._cell(c, c.format_value(c.value(event)))
                     for c in self.columns.visible()]
            return self.divider.join(cells).rstrip()
        specs = self._fast
        if specs is None or self._fast_version != self.columns.layout_version:
            specs = self._compile_fast()
        cells = []
        for get, precision, w, right, ell in specs:
            v = get(event)
            if v is None:
                text = ""
            elif isinstance(v, bool):
                text = "true" if v else "false"
            elif isinstance(v, float):
                text = f"{v:.{precision}f}"
            else:
                text = str(v)
            if len(text) > w:
                text = truncate(text, w, ell)
            cells.append(text.rjust(w) if right else text.ljust(w))
        return self.divider.join(cells).rstrip()

    def format_table(self, events: Iterable[Any]) -> str:
        lines = [self.header()]
        lines.extend(self.format_event(e) for e in events)
        return "\n".join(lines)
