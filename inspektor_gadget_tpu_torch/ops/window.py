"""Sliding-window sketches (PyTorch port of
``inspektor_gadget_tpu/ops/window.py:26-91``) and the tpusketch
operator's two window steps (``operators/tpusketch.py:165-172``).

A WindowedCMS is a ring of S epoch slots of count-min tables: updates
land in the current slot, a query sums the most recent k slots, and
advancing the epoch zeroes the oldest slot. The epoch stays a 0-dim
tensor on the state's device, so no step reads it back to the host.
Leaves are identical to the reference's: int32 tables wrap as its do.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from .hashing import bits32, row_hashes
from .hll import HLL, hll_update


@dataclass
class WindowedCMS:
    slots: torch.Tensor  # (S, depth, width) int32: epoch ring of count-min tables
    epoch: torch.Tensor  # () int32: the current slot
    log2_width: int

    @property
    def n_slots(self) -> int:
        return self.slots.shape[0]

    @property
    def depth(self) -> int:
        return self.slots.shape[1]


def wcms_init(n_slots: int = 8, depth: int = 4, log2_width: int = 14,
              device: str | torch.device = "cuda") -> WindowedCMS:
    d = resolve_device(device)
    return WindowedCMS(
        slots=torch.zeros((n_slots, depth, 1 << log2_width), dtype=torch.int32, device=d),
        epoch=torch.zeros((), dtype=torch.int32, device=d), log2_width=log2_width)


def wcms_update(state: WindowedCMS, keys: torch.Tensor,
                weights: torch.Tensor | None = None) -> WindowedCMS:
    """Scatter-add the batch into the current epoch slot. In place."""
    if weights is None:
        weights = torch.ones(keys.shape, dtype=torch.int32, device=keys.device)
    depth, width = state.depth, 1 << state.log2_width
    idx = row_hashes(keys, depth, state.log2_width)  # (depth, n)
    base = state.epoch.to(torch.int64) * (depth * width)
    rows = torch.arange(depth, device=idx.device)[:, None] * width
    state.slots.view(-1).index_add_(0, (idx + rows + base).reshape(-1),
                                    bits32(weights).repeat(depth))
    return state


def wcms_advance(state: WindowedCMS) -> WindowedCMS:
    """Rotate: move to the next slot and zero it (the oldest epoch goes).
    In place."""
    nxt = (state.epoch + 1) % state.n_slots
    state.slots.index_fill_(0, nxt.to(torch.int64).view(1), 0)
    state.epoch.copy_(nxt)
    return state


def wcms_query(state: WindowedCMS, keys: torch.Tensor,
               last_k: int | None = None) -> torch.Tensor:
    """Count estimate (int32) over the most recent `last_k` epochs
    (default: every slot)."""
    k = state.n_slots if last_k is None else min(last_k, state.n_slots)
    offsets = torch.arange(k, dtype=torch.int32, device=state.slots.device)
    live = ((state.epoch - offsets) % state.n_slots).to(torch.int64)  # newest first
    table = bits32(state.slots[live].sum(dim=0, dtype=torch.int64))  # int32, wrapping
    idx = row_hashes(keys, state.depth, state.log2_width)
    return table.gather(1, idx).min(dim=0).values


def wcms_merge(a: WindowedCMS, b: WindowedCMS) -> WindowedCMS:
    """Slot-wise merge (epochs aligned across nodes)."""
    return WindowedCMS(slots=a.slots + b.slots, epoch=a.epoch.clone(),
                       log2_width=a.log2_width)


# -- the operator's window steps -------------------------------------------------
# Each absorbs a staged batch in place and returns nothing: on the card
# one CUDA event recorded after the bundle step and both window steps is
# the fence for all three (the reference fences a tuple of tokens).

def wcms_ingest_step(state: WindowedCMS, keys: torch.Tensor, weights: torch.Tensor) -> None:
    """The window ring's current slot absorbs the batch's keys at their
    int32 weights."""
    wcms_update(state, keys, bits32(weights))


def hll_ingest_step(state: HLL, keys: torch.Tensor, weights: torch.Tensor) -> None:
    """The window's HLL absorbs the batch's keys whose uint32 weight is
    nonzero (the reference's ``weights > 0`` on uint32)."""
    hll_update(state, keys, weights != 0)
