"""Count-min sketch (PyTorch port of ``inspektor_gadget_tpu/ops/countmin.py``).

Update is a scatter-add over `depth` hashed rows, query the min over
rows, merge an elementwise add. Updates change the state in place (the
reference donates its buffers instead) and return it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from .hashing import row_hashes, sum_wrap32


@dataclass
class CountMin:
    table: torch.Tensor  # (depth, width) int32
    total: torch.Tensor  # () float32
    log2_width: int

    @property
    def depth(self) -> int:
        return self.table.shape[0]

    @property
    def width(self) -> int:
        return self.table.shape[1]


def cms_init(depth: int = 4, log2_width: int = 16,
             device: str | torch.device = "cuda") -> CountMin:
    d = resolve_device(device)
    return CountMin(table=torch.zeros((depth, 1 << log2_width), dtype=torch.int32, device=d),
                    total=torch.zeros((), dtype=torch.float32, device=d),
                    log2_width=log2_width)


def cms_update(state: CountMin, keys: torch.Tensor,
               weights: torch.Tensor | None = None) -> CountMin:
    """Scatter-add a batch of keys; `weights` defaults to 1 per event and
    padded slots pass 0. In place."""
    if weights is None:
        weights = torch.ones(keys.shape, dtype=torch.int32, device=keys.device)
    w = weights.to(torch.int32)
    idx = row_hashes(keys, state.depth, state.log2_width)
    rows = torch.arange(state.depth, device=idx.device)[:, None] * state.width
    state.table.view(-1).index_add_(0, (idx + rows).reshape(-1), w.repeat(state.depth))
    # the reference sums the int32 weights in int32, wrapping (countmin.py:59)
    state.total.add_(sum_wrap32(w).to(torch.float32))
    return state


def cms_query(state: CountMin, keys: torch.Tensor) -> torch.Tensor:
    """Point estimate: min over depth rows (int32)."""
    idx = row_hashes(keys, state.depth, state.log2_width)
    return state.table.gather(1, idx).min(dim=0).values


def cms_merge(a: CountMin, b: CountMin) -> CountMin:
    return CountMin(table=a.table + b.table, total=a.total + b.total,
                    log2_width=a.log2_width)
