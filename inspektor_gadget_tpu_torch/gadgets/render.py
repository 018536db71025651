"""Result rendering for run-with-result gadgets.

Ref: the reference declares per-gadget output formats via
`GadgetOutputFormats` (pkg/gadgets/interface.go:141-166) and the CLI picks
one with `-o`; tabular results honor `-o json` by emitting the event array.
The requested format travels in `ctx.extra["output"]`.

The port's copy of ``inspektor_gadget_tpu/gadgets/render.py``.
"""

from __future__ import annotations

import json
from typing import Any, Sequence


def render_result(ctx, rows: Sequence[Any], cols=None) -> bytes:
    """Render collected rows per the requested output format."""
    cols = cols if cols is not None else ctx.columns
    if ctx.extra.get("output") == "json":
        return json.dumps([cols.to_dict(r) for r in rows],
                          default=str).encode()
    from ..columns import TextFormatter
    return TextFormatter(cols).format_table(rows).encode()
