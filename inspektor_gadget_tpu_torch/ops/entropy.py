"""Streaming entropy sketch over hashed buckets (PyTorch port of
``inspektor_gadget_tpu/ops/entropy.py``).

H = log2(N) - (1/N) * sum_i c_i*log2(c_i) over float32 bucket counts.
The update is the K1 histogram: the hand-written CUDA kernel for CUDA
tensors (where the reference takes its Pallas kernel on the TPU), its
plain version for CPU tensors. Weights are integers, the bundle's
weights lane.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from .hashing import _row_multiplier, row_salt
from .kernels import histogram


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
    """Add the batch's weighted bucket histogram (row-0 hash). In place."""
    if weights is None:
        weights = torch.ones(keys.shape, dtype=torch.int32, device=keys.device)
    if weights.is_floating_point():
        raise TypeError("entropy_update takes integer weights (the weights lane)")
    hist = histogram(keys, weights, log2_width=state.log2_width,
                     mult=int(_row_multiplier(0)), salt=row_salt(0))
    state.counts.add_(hist.to(torch.float32))
    return state


def entropy_estimate(state: EntropySketch) -> torch.Tensor:
    c = state.counts
    n = c.sum()
    plogp = torch.where(c > 0, c * torch.log2(torch.clamp(c, min=1.0)), torch.zeros_like(c))
    nn = torch.clamp(n, min=1.0)
    return torch.where(n > 0, torch.log2(nn) - plogp.sum() / nn, torch.zeros_like(n))


def entropy_merge(a: EntropySketch, b: EntropySketch) -> EntropySketch:
    return EntropySketch(counts=a.counts + b.counts, log2_width=a.log2_width)
