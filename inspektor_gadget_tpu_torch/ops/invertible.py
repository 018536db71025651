"""Invertible heavy-key sketch, state and update half (PyTorch port of
``inspektor_gadget_tpu/ops/invertible.py``).

Per (row, bucket) three integer lanes: ``count`` (sum of weights),
``keysum`` (sum of key*weight mod 2**32) and ``fpsum`` (sum of
fingerprint(key)*weight mod 2**32). Update and merge are integer adds;
the uint32 lanes wrap mod 2**32, which is the algebra the decode
inverts. Decode is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from .hashing import MASK32, _row_multiplier, fmix32, hashed_bucket, mul32, row_salt, u32

# hash rows disjoint from the count-min rows, fixed so state built
# anywhere merges coherently
INV_ROW_OFFSET = 16
FP_SALT = 0x7F4A7C15


@dataclass
class InvSketch:
    count: torch.Tensor   # (rows, buckets) int32
    keysum: torch.Tensor  # (rows, buckets) int64 lanes of uint32
    fpsum: torch.Tensor   # (rows, buckets) int64 lanes of uint32
    log2_buckets: int

    @property
    def rows(self) -> int:
        return self.count.shape[0]

    @property
    def buckets(self) -> int:
        return self.count.shape[1]


def inv_init(rows: int = 3, log2_buckets: int = 12,
             device: str | torch.device = "cuda") -> InvSketch:
    d = resolve_device(device)
    shape = (rows, 1 << log2_buckets)
    return InvSketch(count=torch.zeros(shape, dtype=torch.int32, device=d),
                     keysum=torch.zeros(shape, dtype=torch.int64, device=d),
                     fpsum=torch.zeros(shape, dtype=torch.int64, device=d),
                     log2_buckets=log2_buckets)


def inv_row_hash(row: int) -> tuple[int, int]:
    """(multiplier, salt) of invertible row `row`."""
    r = INV_ROW_OFFSET + row
    return int(_row_multiplier(r)), row_salt(r)


def inv_fingerprint(keys: torch.Tensor) -> torch.Tensor:
    return fmix32(u32(keys) ^ FP_SALT)


def inv_bucket(keys: torch.Tensor, row: int, log2_buckets: int) -> torch.Tensor:
    mult, salt = inv_row_hash(row)
    return hashed_bucket(keys, mult, salt, log2_buckets)


def inv_lane_values(keys: torch.Tensor, weights: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(count, key*w, fp*w) per event as int64 lanes; count is the int32
    weight itself."""
    k = u32(keys)
    w = weights.to(torch.int64)
    wu = w & MASK32
    return w, mul32(k, wu), mul32(inv_fingerprint(k), wu)


def inv_update(state: InvSketch, keys: torch.Tensor,
               weights: torch.Tensor | None = None) -> InvSketch:
    """Absorb a batch: integer scatter-adds on all three lanes. In place."""
    if weights is None:
        weights = torch.ones(keys.shape, dtype=torch.int32, device=keys.device)
    w, kw, fw = inv_lane_values(keys, weights)
    w = w.to(torch.int32)
    for r in range(state.rows):
        idx = inv_bucket(keys, r, state.log2_buckets)
        state.count[r].index_add_(0, idx, w)
        state.keysum[r].index_add_(0, idx, kw)
        state.fpsum[r].index_add_(0, idx, fw)
    state.keysum.bitwise_and_(MASK32)
    state.fpsum.bitwise_and_(MASK32)
    return state


def inv_merge(a: InvSketch, b: InvSketch) -> InvSketch:
    return InvSketch(count=a.count + b.count,
                     keysum=(a.keysum + b.keysum) & MASK32,
                     fpsum=(a.fpsum + b.fpsum) & MASK32,
                     log2_buckets=a.log2_buckets)
