"""K2's least time on the card, from the cell's shapes.

K2 (``fused_planes_kernel``) reads the batch's distinct key lanes and
its weights lane (and the value lane with the quantile plane), four
bytes an event each, and writes its flat delta buffer once: count-min
depth x 2**log2_width words, the entropy row's 2**ent_log2 exact
counts as two words each, 2**hll_p HLL words, three invertible lanes of
rows x 2**inv_log2 words and the quantile plane's buckets. Its
operations are the integer work of hashing each event once a plane it
feeds: `HASH_OPS` 32-bit operations for the multiply-shift over the
murmur3 finalizer (two 32-bit multiplies, three xor-shifts, a multiply,
an add and the bucket shift, each counted once; the 16-bit split of a
32-bit product on a CPU does not exist on the card) plus one
shared-memory atomic a hashed plane.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
HASH_OPS = 12


def k2_planes(op: dict) -> dict:
    """The hashed planes (count) and the delta buffer's words, from a
    configuration's operator block (the operator's defaults otherwise)."""
    depth = int(op.get("depth", 4))
    log2w = int(op.get("log2-width", 16))
    ent = int(op.get("entropy-log2-width", 12))
    hll_p = int(op.get("hll-p", 14))
    words = depth * (1 << log2w) + 2 * (1 << ent) + (1 << hll_p)
    planes = depth + 2
    if op.get("invertible", "false") == "true":
        rows = int(op.get("inv-rows", 3))
        words += 3 * rows * (1 << int(op.get("inv-log2-buckets", 12)))
        planes += 3 * rows
    if op.get("quantiles", "false") == "true":
        words += 2048
        planes += 1
    return {"words": words, "planes": planes}


def k2_input_lanes(op: dict) -> int:
    """Lanes K2 reads: the distinct key columns among the heavy-hitter,
    distinct and distribution streams, the weights, the value lane."""
    cols = {op.get("hh-column", "key_hash"), op.get("distinct-column", "key_hash"),
            op.get("dist-column", "key_hash")}
    return len(cols) + 1 + (1 if op.get("quantiles", "false") == "true" else 0)


def k2_bytes(op: dict, n: int) -> int:
    """Bytes K2 must move for a batch of n rows: each input lane read
    once, each delta-buffer word written once."""
    return 4 * n * k2_input_lanes(op) + 4 * k2_planes(op)["words"]


def k2_ops(op: dict, n: int) -> int:
    """32-bit integer operations K2 must do for a batch of n rows."""
    return n * k2_planes(op)["planes"] * (HASH_OPS + 1)


def k2_least_ms(op: dict, n: int) -> float:
    """The larger of the byte bound and the operation bound, in ms."""
    return 1e3 * max(k2_bytes(op, n) / PEAKS["hbm_bytes_per_s"],
                     k2_ops(op, n) / PEAKS["int32_ops_per_s"])
