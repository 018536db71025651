"""Streaming top-k heavy-hitter candidate table (PyTorch port of
``inspektor_gadget_tpu/ops/topk.py``).

The order among equal counts feeds `bundle_digest`, so it must be the
reference's: ``jnp.lexsort((-counts, keys))`` then ``lax.top_k``, which
puts the lower index first among ties. ``torch.topk`` promises no tie
order, so both steps are built from stable sorts here. The update
returns a new table; the `overflow` flag latches exactly as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..device import resolve_device
from .countmin import CountMin, cms_query
from .hashing import u32
from .lanes import group_gather, psum


@dataclass
class TopK:
    keys: torch.Tensor      # (k,) int64 lanes of uint32 keys (0 = empty slot)
    counts: torch.Tensor    # (k,) int32 estimated counts
    overflow: torch.Tensor  # () int32: candidate population ever > k


def topk_init(k: int = 128, device: str | torch.device = "cuda") -> TopK:
    d = resolve_device(device)
    return TopK(keys=torch.zeros(k, dtype=torch.int64, device=d),
                counts=torch.zeros(k, dtype=torch.int32, device=d),
                overflow=torch.zeros((), dtype=torch.int32, device=d))


def _stable_order(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (primary, secondary) ascending, ties by
    position — ``jnp.lexsort((secondary, primary))``."""
    o1 = torch.sort(secondary, stable=True).indices
    return o1[torch.sort(primary[o1], stable=True).indices]


def _dedupe_topk(keys: torch.Tensor, counts: torch.Tensor, k: int,
                 overflow: torch.Tensor) -> TopK:
    """Keep the best-counted unique keys: group duplicates with each run's
    max count first, keep the first of each run, then the k largest
    counts, lower position first among ties."""
    counts = counts.to(torch.int64)
    order = _stable_order(keys, -counts)
    sk, sc = keys[order], counts[order]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    valid = first & (sk != 0)
    sc = torch.where(valid, sc, torch.full_like(sc, -1))
    top = torch.sort(-sc, stable=True).indices[:k]
    top_counts, top_keys = sc[top], sk[top]
    empty = top_counts < 0
    overflow = torch.maximum(overflow, (valid.sum() > k).to(torch.int32))
    return TopK(keys=torch.where(empty, torch.zeros_like(top_keys), top_keys),
                counts=torch.where(empty, torch.zeros_like(top_counts),
                                   top_counts).to(torch.int32),
                overflow=overflow)


def topk_update(state: TopK, cms: CountMin, batch_keys: torch.Tensor,
                mask: torch.Tensor | None = None) -> TopK:
    """Refresh candidates against a CMS that has already absorbed the batch."""
    bk = u32(batch_keys)
    if mask is not None:
        bk = torch.where(mask != 0, bk, torch.zeros_like(bk))
    all_keys = torch.cat([state.keys, bk])
    est = cms_query(cms, all_keys).to(torch.int64)
    est = torch.where(all_keys == 0, torch.full_like(est, -1), est)
    return _dedupe_topk(all_keys, est, state.keys.shape[0], state.overflow)


def topk_merge(a: TopK, b: TopK, cms: CountMin | None = None) -> TopK:
    keys = torch.cat([a.keys, b.keys])
    if cms is not None:
        est = cms_query(cms, keys).to(torch.int64)
        counts = torch.where(keys == 0, torch.full_like(est, -1), est)
    else:
        counts = torch.cat([a.counts, b.counts])
    return _dedupe_topk(keys, counts, a.keys.shape[0],
                        torch.maximum(a.overflow, b.overflow))


def topk_values(state: TopK) -> tuple[torch.Tensor, torch.Tensor]:
    return state.keys, state.counts


def topk_gather_merge(lanes: Sequence[TopK], cms_merged: CountMin, group=None) -> TopK:
    """Cluster-wide merge (reference ``ops/topk.py:92``): every lane's
    candidates in global lane order (this process's lanes in order, then
    gathered across `group` in rank order), refreshed against the merged
    count-min and re-ranked by ONE `_dedupe_topk`; `overflow` is the max
    over the lanes. A pairwise `topk_merge` fold would not do: the stable
    sorts break ties by position, so the candidates' order is part of the
    answer."""
    dev = cms_merged.table.device
    keys = group_gather(torch.cat([s.keys.to(dev) for s in lanes]), group)
    est = cms_query(cms_merged, keys).to(torch.int64)
    counts = torch.where(keys == 0, torch.full_like(est, -1), est)
    overflow = psum([s.overflow for s in lanes], group, op="max")
    return _dedupe_topk(keys, counts, lanes[0].keys.shape[0], overflow)
