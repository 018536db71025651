"""32-bit hashing primitives for sketch keys (PyTorch port of
``inspektor_gadget_tpu/ops/hashing.py``, bit-identical to it).

One representation of a uint32 lane runs through every torch expression
of the port: an ``int64`` tensor holding values in ``[0, 2**32)``. Torch
has no ``>>`` or add on ``uint32`` CPU tensors, so the lanes ride in
int64 and every product is masked back to 32 bits. Products are split
into 16-bit halves (`mul32`) so no intermediate ever leaves the int64
range. Key lanes may arrive as ``torch.uint32`` or as their ``int32`` bit
view (what the staging ring hands over); `u32` turns any of them into
the int64 form. The CUDA kernels read the same 32-bit words directly.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

# Odd multipliers for multiply-shift hashing, fixed so sketches built in
# different processes (and by the JAX package) merge coherently. Rows
# beyond the seed table derive deterministically via splitmix32.
_SEED_MULTIPLIERS = [
    0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
    0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09,
]


def _row_multiplier(row: int) -> np.uint32:
    if row < len(_SEED_MULTIPLIERS):
        return np.uint32(_SEED_MULTIPLIERS[row])
    z = (row * 0x9E3779B9 + 0x6A09E667) & 0xFFFFFFFF
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & 0xFFFFFFFF
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & 0xFFFFFFFF
    return np.uint32((z ^ (z >> 16)) | 1)  # force odd


def row_salt(row: int) -> int:
    return (row * 0x9E3779B9) & 0xFFFFFFFF


def fold64_to_32(keys64: np.ndarray) -> np.ndarray:
    """Host-side fold of uint64 FNV-1a hashes to uint32 (xor-fold)."""
    k = np.asarray(keys64, dtype=np.uint64)
    return ((k >> np.uint64(32)) ^ (k & np.uint64(0xFFFFFFFF))).astype(np.uint32)


def fmix32_np(h: np.ndarray) -> np.ndarray:
    """numpy twin of `fmix32` for host-side decode paths."""
    h = np.asarray(h, dtype=np.uint32).copy()
    h ^= h >> np.uint32(16)
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h ^= h >> np.uint32(13)
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    h ^= h >> np.uint32(16)
    return h


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any 32-bit key lane (uint32, its int32 bit view, or int64) as the
    port's int64 lane in [0, 2**32)."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    if x.dtype != torch.int64:
        x = x.to(torch.int64)
    return x & MASK32


def bits32(x: torch.Tensor) -> torch.Tensor:
    """The int32 tensor carrying the same 32 bits as a lane — the form
    the kernels and the digest take. 32-bit inputs are viewed, not
    copied."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype == torch.int32:
        return x
    x = u32(x)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def sum_wrap32(x: torch.Tensor) -> torch.Tensor:
    """The sum of an int32 lane wrapped to int32 (mod 2**32), as the
    reference's int32 reduction gives it; exact before the wrap."""
    s = bits32(x).sum(dtype=torch.int64)
    return ((s + (1 << 31)) & MASK32) - (1 << 31)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 lanes in [0, 2**32); `b` is a lane or
    a Python int. Split into 16-bit halves so no product exceeds 2**48."""
    if isinstance(b, torch.Tensor):
        lo, hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    else:
        b = int(b) & MASK32
        lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 lanes."""
    h = u32(h)
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hashed_bucket(keys: torch.Tensor, mult: int, salt: int,
                  log2_width: int) -> torch.Tensor:
    """fmix32(key * mult + salt) >> (32 - log2_width) as int64 indices —
    the one hash every histogram plane uses."""
    h = fmix32((mul32(u32(keys), mult) + salt) & MASK32)
    return h >> (32 - log2_width)


def multiply_shift(keys: torch.Tensor, row: int, log2_width: int) -> torch.Tensor:
    """Row `row`'s bucket index in [0, 2**log2_width), int64."""
    return hashed_bucket(keys, int(_row_multiplier(row)), row_salt(row),
                         log2_width)


def row_hashes(keys: torch.Tensor, depth: int, log2_width: int) -> torch.Tensor:
    """(depth, n) int64 bucket indices for a batch of keys."""
    k = u32(keys)
    return torch.stack([multiply_shift(k, d, log2_width) for d in range(depth)])
