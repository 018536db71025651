"""Width-constrained truncation (ref: pkg/columns/ellipsis/ellipsis.go).

The port's copy of ``inspektor_gadget_tpu/columns/ellipsis.py``.
"""

from __future__ import annotations

ELLIPSIS = "…"


def truncate(s: str, width: int, mode: str = "end") -> str:
    if width <= 0:
        return ""
    if len(s) <= width:
        return s
    if mode == "none":
        return s[:width]
    if width == 1:
        return ELLIPSIS
    if mode == "start":
        return ELLIPSIS + s[-(width - 1):]
    if mode == "middle":
        left = (width - 1) // 2
        right = width - 1 - left
        return s[:left] + ELLIPSIS + (s[-right:] if right else "")
    return s[: width - 1] + ELLIPSIS
