"""The resolution-schedule grammar of the history lifecycle (the port's
copy of the parser in ``inspektor_gadget_tpu/history/lifecycle.py``).

A schedule reads ``<resolution>@<horizon>[,...]``: windows live at each
resolution until they are as old as its horizon. Both sides are Go-style
durations with a leading ``<n>d`` day term; the last horizon is ``inf``.
Compaction itself waits for ROADMAP item 10c; the tpusketch operator's
``history-schedule`` param validates its value with `validate_schedule`.
"""

from __future__ import annotations

import dataclasses
import math
import re

from ..params.validators import parse_duration

DEFAULT_SCHEDULE = "1m@24h,10m@7d,1h@inf"

_INF = ("inf", "infinite", "∞")
_DAYS = re.compile(r"^(\d+(?:\.\d+)?)d(.*)$")


def _parse_span(s: str) -> float:
    """parse_duration plus a leading ``<n>d`` day term and ``inf``."""
    s = s.strip()
    if s.lower() in _INF:
        return math.inf
    total = 0.0
    m = _DAYS.match(s)
    if m:
        total += float(m.group(1)) * 86400.0
        s = m.group(2)
        if not s:
            return total
    return total + parse_duration(s)


@dataclasses.dataclass(frozen=True)
class ScheduleLevel:
    """One tier: windows live at `resolution` until `horizon` old."""
    resolution: float    # target super-window length, seconds
    horizon: float       # age past which this level compacts upward


def parse_schedule(spec: str) -> list[ScheduleLevel]:
    """``res@horizon[,res@horizon...]`` -> validated levels; every
    malformation raises ValueError."""
    entries = [e.strip() for e in (spec or "").split(",") if e.strip()]
    if not entries:
        raise ValueError(f"empty resolution schedule {spec!r}")
    levels: list[ScheduleLevel] = []
    for entry in entries:
        res_s, sep, hor_s = entry.partition("@")
        if not sep or not res_s.strip() or not hor_s.strip():
            raise ValueError(
                f"schedule entry {entry!r} is not <resolution>@<horizon>")
        try:
            res = _parse_span(res_s)
            hor = _parse_span(hor_s)
        except ValueError as e:
            raise ValueError(f"schedule entry {entry!r}: {e}") from None
        if not math.isfinite(res) or res <= 0:
            raise ValueError(
                f"schedule entry {entry!r}: resolution must be a finite "
                "positive duration")
        if hor <= 0:
            raise ValueError(
                f"schedule entry {entry!r}: horizon must be > 0")
        levels.append(ScheduleLevel(resolution=res, horizon=hor))
    for a, b in zip(levels, levels[1:]):
        if b.resolution <= a.resolution:
            raise ValueError(
                f"schedule {spec!r}: resolutions must strictly coarsen "
                f"({b.resolution:g}s after {a.resolution:g}s)")
        if b.horizon <= a.horizon:
            raise ValueError(
                f"schedule {spec!r}: horizons must strictly grow "
                f"({b.horizon:g}s after {a.horizon:g}s)")
    if math.isfinite(levels[-1].horizon):
        raise ValueError(
            f"schedule {spec!r}: the last horizon must be inf — data "
            "either lives forever at the coarsest level or moves to the "
            "archive tier, it never silently vanishes")
    for lvl in levels[:-1]:
        if not math.isfinite(lvl.horizon):
            raise ValueError(
                f"schedule {spec!r}: only the last horizon may be inf")
    return levels


def validate_schedule(value: str) -> None:
    """ParamDesc validator (raises ValueError, returns nothing)."""
    parse_schedule(value)
