"""Typed column system (ref: pkg/columns — columninfo.go:43-66, columns.go:40-79).

Columns are declared as dataclass fields with ``col(...)`` metadata. A
``Columns`` registry built from an event dataclass provides:

- visible/ordered column metadata for formatters and catalogs,
- row-wise filtering, sorting, grouping (ref: pkg/columns/filter, sort, group),
- an ANSI-width text formatter (ref: pkg/columns/formatter/textcolumns),
- **tensorization**: events → struct-of-arrays numpy batches, the ingest
  contract for the sketch plane. String columns hash to uint64 via FNV-1a
  so heavy-hitter keys are fixed-width on the device.

The port's copy of ``inspektor_gadget_tpu/columns``, as it is.
"""

from .columns import (
    Column,
    Columns,
    col,
    register_template,
    get_template,
)
from .filter import FilterSpec, parse_filters, match_event, columnar_mask
from .sort import parse_sort, sort_events, columnar_argsort
from .group import group_events
from .formatter import TextFormatter
from .ellipsis import truncate

__all__ = [
    "Column",
    "Columns",
    "col",
    "register_template",
    "get_template",
    "FilterSpec",
    "parse_filters",
    "match_event",
    "columnar_mask",
    "parse_sort",
    "sort_events",
    "columnar_argsort",
    "group_events",
    "TextFormatter",
    "truncate",
]
