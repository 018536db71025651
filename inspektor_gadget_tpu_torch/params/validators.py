"""Param validators (ref: pkg/params/validators.go:23-112).

The port's copy of ``inspektor_gadget_tpu/params/validators.py``.
"""

from __future__ import annotations

import re
from typing import Callable, Sequence

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNITS = {
    "ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0,
}


def parse_duration(s: str) -> float:
    """Parse Go-style duration strings ("1m30s", "500ms", plain seconds)."""
    s = s.strip()
    if not s:
        raise ValueError("empty duration")
    try:
        return float(s)
    except ValueError:
        pass
    pos, total = 0, 0.0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration {s!r}")
        total += float(m.group(1)) * _DURATION_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration {s!r}")
    return total


def validate_int_range(lo: int | None = None, hi: int | None = None) -> Callable[[str], None]:
    def check(value: str) -> None:
        try:
            v = int(value)
        except ValueError:
            raise ValueError(f"{value!r} is not an integer") from None
        if lo is not None and v < lo:
            raise ValueError(f"{v} below minimum {lo}")
        if hi is not None and v > hi:
            raise ValueError(f"{v} above maximum {hi}")
    return check


def validate_one_of(choices: Sequence[str]) -> Callable[[str], None]:
    def check(value: str) -> None:
        if value not in choices:
            raise ValueError(f"{value!r} not one of {list(choices)}")
    return check


def validate_duration(value: str) -> None:
    parse_duration(value)
