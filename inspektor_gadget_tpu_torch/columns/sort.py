"""Multi-column sort (ref: pkg/columns/sort/sort.go, ~178 LoC).

Spec: comma-separated column names, "-" prefix for descending, e.g.
"-reads,comm" (used by top gadgets, ref: pkg/gadgets/top/file/gadget.go:43-66).

The port's copy of ``inspektor_gadget_tpu/columns/sort.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np

from .columns import Columns


@dataclasses.dataclass
class SortSpec:
    column: str
    descending: bool = False


def parse_sort(spec: str | Sequence[str], columns: Columns) -> list[SortSpec]:
    if isinstance(spec, str):
        spec = [s for s in spec.split(",") if s]
    out = []
    for s in spec:
        desc = s.startswith("-")
        name = s[1:] if desc else s
        if not columns.has(name):
            raise ValueError(f"sort: unknown column {name!r}")
        out.append(SortSpec(column=name.lower(), descending=desc))
    return out


def sort_events(events: list[Any], specs: Sequence[SortSpec], columns: Columns) -> list[Any]:
    """Stable multi-key sort: apply keys in reverse order (ref: sort.go
    sorts with a chained comparator; stability gives the same result)."""
    out = list(events)
    for spec in reversed(specs):
        c = columns.get(spec.column)
        out.sort(key=lambda e: _key(c.value(e)), reverse=spec.descending)
    return out


def _key(v: Any):
    # None sorts first ascending; normalize mixed numerics
    if v is None:
        return (0, 0)
    if isinstance(v, bool):
        return (1, int(v))
    if isinstance(v, (int, float, np.integer, np.floating)):
        return (1, float(v))
    return (2, str(v))


def columnar_argsort(
    batch: Mapping[str, np.ndarray], specs: Sequence[SortSpec], columns: Columns
) -> np.ndarray:
    """Vectorized argsort over a struct-of-arrays batch via np.lexsort
    (last key is primary, so reverse the spec list)."""
    if not specs:
        n = len(next(iter(batch.values()))) if batch else 0
        return np.arange(n)
    keys = []
    for spec in reversed(specs):
        arr = batch[columns.get(spec.column).name]
        if spec.descending:
            if arr.dtype.kind in "ui":
                arr = arr.astype(np.int64, copy=False) * -1 if arr.dtype.kind == "i" else np.iinfo(np.uint64).max - arr
            else:
                arr = -arr
        keys.append(arr)
    return np.lexsort(keys)
