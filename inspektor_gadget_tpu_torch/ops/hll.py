"""HyperLogLog distinct-count sketch (PyTorch port of
``inspektor_gadget_tpu/ops/hll.py``).

Update is a scatter-max of leading-zero ranks, merge an elementwise max.
The estimate is the reference's float32 arithmetic on the CPU, bit for
bit, on every device: XLA lowers ``exp2(-r)`` to its own ``exp`` of
``-r * 0.693147182``, which misses the exact power of two by up to 34
ulps from rank 13 up, so the port reads those values from a table of
XLA's outputs at the ranks a register can hold (`_XLA_EXP2_NEG`); it
sums them in XLA's order (`xla_sum_f32`) and takes linear counting's
``log`` as XLA's (`xla_logf`), and the large-range correction's
``log1p``, above 2**32 / 30 estimated keys, as XLA's too (`xla_log1pf`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from .hashing import MASK32, fmix32
from .lanes import psum
from .quantiles import xla_log1pf, xla_logf, xla_sum_f32

# XLA's CPU float32 exp2(-r) for r = 0..64 (every rank a register holds),
# as bit patterns; tests/test_torch_sketch_ops.py holds them to jnp.exp2
_XLA_EXP2_NEG = np.array([
    0x3f800000, 0x3f000000, 0x3e800000, 0x3e000000, 0x3d800000, 0x3d000000, 0x3c800000,
    0x3c000000, 0x3b800000, 0x3b000000, 0x3a800000, 0x3a000000, 0x39800000, 0x38fffff8,
    0x38800000, 0x38000004, 0x377fffff, 0x36fffff7, 0x367fffff, 0x36000004, 0x357fffff,
    0x34fffff7, 0x347fffff, 0x34000004, 0x337fffff, 0x32fffff7, 0x327fffef, 0x32000004,
    0x317fffff, 0x30fffff7, 0x30800008, 0x30000004, 0x2f7fffff, 0x2efffff7, 0x2e7fffef,
    0x2e000003, 0x2d7fffff, 0x2cfffff7, 0x2c800007, 0x2c000003, 0x2b7fffff, 0x2afffff7,
    0x2a7fffef, 0x2a000003, 0x297fffff, 0x28fffff7, 0x28800007, 0x27ffffe6, 0x277ffffe,
    0x2700000b, 0x267fffee, 0x26000003, 0x257fffde, 0x24fffff6, 0x24800007, 0x23ffffe6,
    0x237ffffe, 0x2300000b, 0x227fffee, 0x22000003, 0x2180000f, 0x20fffff6, 0x20800007,
    0x1fffffe6, 0x1f7ffffe], dtype=np.uint32).view(np.float32)


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
    exp2_neg = torch.from_numpy(_XLA_EXP2_NEG).to(dev)[state.registers.to(torch.int64)]
    raw = torch.tensor(_alpha(m) * m * m, dtype=f32, device=dev) / xla_sum_f32(exp2_neg)
    zeros = (state.registers == 0).sum().to(f32)
    mf = torch.tensor(float(m), dtype=f32, device=dev)
    linear = mf * xla_logf((mf / torch.clamp(zeros, min=1.0)).reshape(1))[0]
    small = (raw <= 2.5 * m) & (zeros > 0)
    est = torch.where(small, linear, raw)
    two32 = torch.tensor(2.0 ** 32, dtype=f32, device=dev)
    log1p = xla_log1pf(-est / two32)
    # past 2**32 keys log1p is a NaN with every bit set, which the
    # reference's multiply keeps and a card's would replace with its own
    big = torch.where(torch.isnan(log1p), log1p, -two32 * log1p)
    return torch.where(est > two32 / 30.0, big, est)


def hll_merge(a: HLL, b: HLL) -> HLL:
    return HLL(registers=torch.maximum(a.registers, b.registers), p=a.p)


def hll_pmax(lanes: Sequence[HLL], group=None) -> HLL:
    """Cluster-wide merge (reference ``ops/hll.py:73``): the registers'
    elementwise max over the lanes, then across `group`."""
    return HLL(registers=psum([s.registers for s in lanes], group, op="max"), p=lanes[0].p)
