"""Column filters (ref: pkg/columns/filter/filter.go, ~325 LoC).

Filter spec grammar mirrors the reference:
  "col:value"    exact match
  "col:!value"   negated exact match
  "col:>N" "col:>=N" "col:<N" "col:<=N"   numeric comparisons
  "col:~re"      regular-expression match

Both row-wise matching (for streaming events) and vectorized columnar masks
(for struct-of-arrays batches — the device ingest path) are provided.

The port's copy of ``inspektor_gadget_tpu/columns/filter.py``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from .columns import Columns, fnv1a64


@dataclasses.dataclass
class FilterSpec:
    column: str
    op: str  # "eq" | "ne" | "gt" | "ge" | "lt" | "le" | "re"
    value: str
    negate: bool = False
    _regex: re.Pattern | None = None

    def __post_init__(self):
        if self.op == "re":
            self._regex = re.compile(self.value)


_OPS = [(">=", "ge"), ("<=", "le"), (">", "gt"), ("<", "lt"), ("~", "re")]


def parse_filters(specs: str | Sequence[str], columns: Columns) -> list[FilterSpec]:
    """Parse comma-separated or list filter specs (ref: filter.go GetFilterFromString)."""
    if isinstance(specs, str):
        specs = [s for s in specs.split(",") if s]
    out: list[FilterSpec] = []
    for spec in specs:
        if ":" not in spec:
            raise ValueError(f"filter {spec!r}: expected 'column:value'")
        name, _, rest = spec.partition(":")
        if not columns.has(name):
            raise ValueError(f"filter {spec!r}: unknown column {name!r}")
        negate = rest.startswith("!")
        if negate:
            rest = rest[1:]
        op, value = "eq", rest
        for prefix, opname in _OPS:
            if rest.startswith(prefix):
                op, value = opname, rest[len(prefix):]
                break
        out.append(FilterSpec(column=name.lower(), op=op, value=value, negate=negate))
    return out


def _compare(v: Any, spec: FilterSpec) -> bool:
    if spec.op == "eq":
        res = str(v) == spec.value
    elif spec.op == "re":
        res = bool(spec._regex.search(str(v)))
    else:
        try:
            a, b = float(v), float(spec.value)
        except (TypeError, ValueError):
            return False
        res = {"gt": a > b, "ge": a >= b, "lt": a < b, "le": a <= b}[spec.op]
    return res != spec.negate


def match_event(event: Any, filters: Iterable[FilterSpec], columns: Columns) -> bool:
    return all(_compare(columns.get(f.column).value(event), f) for f in filters)


def numeric_col_mask(arr: np.ndarray, f: FilterSpec) -> np.ndarray | None:
    """Vectorized compare of one numeric filter against a column, honoring
    the row path's semantics; returns None when the caller must fall back
    to row-wise matching (value unrepresentable in the dtype — including
    OverflowError from out-of-range ints on numpy 2.x — or a non-canonical
    eq numeral like '07', which the row path string-compares)."""
    try:
        val = np.asarray(f.value).astype(arr.dtype)
    except (ValueError, OverflowError):
        return None
    if f.op == "eq" and str(val.item()) != f.value:
        return None
    m = {"eq": arr == val, "gt": arr > val, "ge": arr >= val,
         "lt": arr < val, "le": arr <= val}[f.op]
    return ~m if f.negate else m


def columnar_mask(
    batch: Mapping[str, np.ndarray],
    filters: Iterable[FilterSpec],
    columns: Columns,
    vocab: Mapping[int, str] | None = None,
) -> np.ndarray:
    """Vectorized filter over a struct-of-arrays batch. String equality
    compares FNV-1a hashes (exact for eq/ne); regex filters need `vocab` to
    un-hash and fall back to per-row matching."""
    n = len(next(iter(batch.values()))) if batch else 0
    mask = np.ones(n, dtype=bool)
    for f in filters:
        c = columns.get(f.column)
        arr = batch[c.name]
        if c.is_string:
            if f.op == "eq":
                m = arr == np.uint64(fnv1a64(f.value))
            elif f.op == "re":
                if vocab is None:
                    raise ValueError("regex filter on hashed column needs vocab")
                m = np.asarray(
                    [bool(f._regex.search(vocab.get(int(h), ""))) for h in arr]
                )
            else:
                raise ValueError(f"op {f.op!r} unsupported on string column")
        elif f.op == "re":
            # regex on a numeric column: match the stringified values, same
            # as the row-wise path
            m = np.asarray([bool(f._regex.search(str(v))) for v in arr])
        else:
            m = numeric_col_mask(arr, f)
            if m is not None:
                mask &= m
                continue
            # unrepresentable comparison value: row path compares str(v)
            # for eq and returns False for ordered ops — mirror that
            if f.op == "eq":
                m = np.asarray([str(v) == f.value for v in arr])
            else:
                m = np.zeros(n, dtype=bool)
        mask &= ~m if f.negate else m
    return mask
