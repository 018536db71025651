"""Group-by with per-column aggregation verbs (ref: pkg/columns/group/group.go).

Columns declare group="sum"|"max"|"min" in their metadata; grouping by a key
column folds all events sharing the key, aggregating annotated columns and
keeping the first value for the rest — exactly the reference semantics
(group.go:52-118 sums numeric kinds, keeps last otherwise).

The port's copy of ``inspektor_gadget_tpu/columns/group.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from .columns import Columns


def group_events(events: list[Any], by: Sequence[str], columns: Columns) -> list[Any]:
    if not by:
        return list(events)
    key_cols = [columns.get(n) for n in by]
    groups: dict[tuple, Any] = {}
    for ev in events:
        key = tuple(c.value(ev) for c in key_cols)
        cur = groups.get(key)
        if cur is None:
            groups[key] = _copy(ev)
            continue
        for c in columns.all():
            if c.group is None:
                continue
            a, b = c.value(cur), c.value(ev)
            if a is None or b is None:
                merged = a if b is None else b
            elif c.group == "sum":
                merged = a + b
            elif c.group == "max":
                merged = max(a, b)
            else:
                merged = min(a, b)
            _set(cur, c.field, merged)
    return list(groups.values())


def _copy(ev: Any) -> Any:
    return dataclasses.replace(ev) if dataclasses.is_dataclass(ev) else ev


def _set(ev: Any, field: str, value: Any) -> None:
    parts = field.split(".")
    obj = ev
    for p in parts[:-1]:
        obj = getattr(obj, p)
    setattr(obj, parts[-1], value)
