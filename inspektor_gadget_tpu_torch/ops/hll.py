"""HyperLogLog distinct-count sketch (PyTorch port of
``inspektor_gadget_tpu/ops/hll.py``).

Update is a scatter-max of leading-zero ranks, merge an elementwise max.
The estimate follows the reference's float32 arithmetic; its sum over
2**p registers runs in another order than XLA's, so it agrees to float32
rounding, not bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from .hashing import MASK32, fmix32


@dataclass
class HLL:
    registers: torch.Tensor  # (2**p,) int32
    p: int


def hll_init(p: int = 14, device: str | torch.device = "cuda") -> HLL:
    return HLL(registers=torch.zeros(1 << p, dtype=torch.int32,
                                     device=resolve_device(device)), p=p)


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / m)


def hll_index_rank(keys: torch.Tensor, p: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(register index int64, rank int32) per key: rank is the leading
    zeros of the 32-p bits below the index, plus one — clz of the int32
    reinterpretation, as the reference takes it."""
    h = fmix32(keys)
    idx = h >> (32 - p)
    rest = ((h << p) & MASK32) | ((1 << p) - 1)  # low bits set: rest >= 1
    # clz of a 32-bit value = 32 - its bit length; frexp's exponent is
    # the bit length, exact for integers below 2**53
    clz = 32 - torch.frexp(rest.to(torch.float64)).exponent.to(torch.int64)
    rank = torch.clamp(clz, 0, 32 - p) + 1
    return idx, rank.to(torch.int32)


def hll_update(state: HLL, keys: torch.Tensor,
               mask: torch.Tensor | None = None) -> HLL:
    """Fold a batch; slots whose mask (or weight) is zero rank 0. In place."""
    idx, rank = hll_index_rank(keys, state.p)
    if mask is not None:
        rank = torch.where(mask != 0, rank, torch.zeros_like(rank))
    state.registers.scatter_reduce_(0, idx, rank, reduce="amax")
    return state


def hll_estimate(state: HLL) -> torch.Tensor:
    m = state.registers.shape[0]
    dev = state.registers.device
    f32 = torch.float32
    regs = state.registers.to(f32)
    raw = torch.tensor(_alpha(m) * m * m, dtype=f32, device=dev) / torch.exp2(-regs).sum()
    zeros = (state.registers == 0).sum().to(f32)
    mf = torch.tensor(float(m), dtype=f32, device=dev)
    linear = mf * torch.log(mf / torch.clamp(zeros, min=1.0))
    small = (raw <= 2.5 * m) & (zeros > 0)
    est = torch.where(small, linear, raw)
    two32 = torch.tensor(2.0 ** 32, dtype=f32, device=dev)
    big = -two32 * torch.log1p(-est / two32)
    return torch.where(est > two32 / 30.0, big, est)


def hll_merge(a: HLL, b: HLL) -> HLL:
    return HLL(registers=torch.maximum(a.registers, b.registers), p=a.p)
