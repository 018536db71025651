"""The fold order of the fleet's merge (ref:
``inspektor_gadget_tpu/fleet/aggregator.py:58 canonical_order``).

The merge algebra is associative and commutative on every plane, but two
spots of it see order: the label map's update is last-wins and the
merge's geometry base is first-wins. Folding in reply arrival order
would let scheduling leak into the sealed summary's bytes, so every
fleet fold sorts its windows first. The aggregation tree that the
reference builds on the same order is ROADMAP item 11.
"""

from __future__ import annotations

from typing import Iterable

from ..history.window import SealedWindow


def canonical_order(windows: Iterable[SealedWindow]) -> list[SealedWindow]:
    """The fold order both the flat path and the tree pin: sorted by
    (node, level, window, seq, digest) — a pure function of the window
    set, so reply arrival order cannot reach the merge (where the
    label-map last-wins update and the merge-base geometry choice would
    otherwise leak it into the sealed bytes)."""
    return sorted(windows, key=lambda w: (w.node, int(w.level),
                                          int(w.window), int(w.seq),
                                          w.digest))
