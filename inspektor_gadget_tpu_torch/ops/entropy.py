"""Streaming entropy sketch over hashed buckets (PyTorch port of
``inspektor_gadget_tpu/ops/entropy.py``).

H = log2(N) - (1/N) * sum_i c_i*log2(c_i) over float32 bucket counts.
The update is the K1 histogram: the hand-written CUDA kernel for CUDA
tensors (where the reference takes its Pallas kernel on the TPU), its
plain version for CPU tensors. Weights are integers, the bundle's
weights lane. The batch's bucket counts are exact (int64, never
wrapping) and are rounded to float32 once, as they are added: the same
as the reference's Pallas path whenever a bucket's batch total is below
2**24, and the same as its CPU path, which adds each float32 weight in
turn, whenever a bucket's running count stays below 2**24 (PERF.md §1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from .hashing import _row_multiplier, row_salt
from .kernels import histogram
from .lanes import psum
from .quantiles import fma_f32, xla_logf, xla_sum_f32

_INV_LN2 = float(np.float32(1.0) / np.float32(np.log(np.float32(2.0))))  # XLA folds /log(2)


@dataclass
class EntropySketch:
    counts: torch.Tensor  # (width,) float32
    log2_width: int


def entropy_init(log2_width: int = 12, device: str | torch.device = "cuda") -> EntropySketch:
    return EntropySketch(counts=torch.zeros(1 << log2_width, dtype=torch.float32,
                                            device=resolve_device(device)),
                         log2_width=log2_width)


def entropy_update(state: EntropySketch, keys: torch.Tensor,
                   weights: torch.Tensor | None = None) -> EntropySketch:
    """Add the batch's exact weighted bucket histogram (row-0 hash),
    rounded to float32 once. In place."""
    if weights is None:
        weights = torch.ones(keys.shape, dtype=torch.int32, device=keys.device)
    if weights.is_floating_point():
        raise TypeError("entropy_update takes integer weights (the weights lane)")
    hist = histogram(keys, weights, log2_width=state.log2_width,
                     mult=int(_row_multiplier(0)), salt=row_salt(0))
    state.counts.add_(hist.to(torch.float32))
    return state


def entropy_estimate(state: EntropySketch) -> torch.Tensor:
    """H in bits, in the reference's float32 arithmetic on the CPU: XLA's
    ``log``, ``log2`` as ``log`` times the float32 reciprocal of
    ``log 2``, XLA's summation order, and the final ``log2(N) - S/N``
    contracted to one fused multiply-add, as XLA's CPU backend emits it.
    So a harvest's entropy is bit-identical to the reference's on the
    same counts, and every device runs the same arithmetic."""
    c = state.counts
    n = xla_sum_f32(c)
    inv_ln2 = torch.tensor(_INV_LN2, dtype=torch.float32, device=c.device)
    log2c = xla_logf(torch.clamp(c, min=1.0)) * inv_ln2
    plogp = xla_sum_f32(torch.where(c > 0, c * log2c, torch.zeros_like(c)))
    nn = torch.clamp(n, min=1.0)
    h = fma_f32(xla_logf(nn.reshape(1))[0], _INV_LN2, -(plogp / nn))
    return torch.where(n > 0, h, torch.zeros_like(n))


def entropy_merge(a: EntropySketch, b: EntropySketch) -> EntropySketch:
    return EntropySketch(counts=a.counts + b.counts, log2_width=a.log2_width)


def entropy_psum(lanes: Sequence[EntropySketch], group=None) -> EntropySketch:
    """Cluster-wide merge (reference ``ops/entropy.py:63``): the float32
    counts summed in lane order, then across `group`. Exact while each
    bucket's sum stays below 2**24."""
    return EntropySketch(counts=psum([s.counts for s in lanes], group),
                         log2_width=lanes[0].log2_width)
