"""The two forms of a cluster merge: lanes in one process, ranks of a
process group.

The reference merges per-node state with one collective over the mesh's
node axis (``jax.lax.psum``, ``pmax``, ``all_gather``). The port has two
places state lives:

- **Lanes in one process.** A list of per-lane tensors, lane k on its own
  device. They fold in lane order onto lane 0's device into a fresh
  tensor; no lane is changed.
- **Ranks of a `torch.distributed` group.** Each rank folds its own lanes,
  then one ``all_reduce`` (SUM or MAX) or ``all_gather`` crosses the
  group: NCCL for CUDA tensors, gloo on the CPU. ``group=None`` means no
  group (lanes only); the world group is ``torch.distributed.group.WORLD``.

Integer sums wrap as the reference's do (int32 two's complement). The
port keeps uint32 lanes as int64, so their callers mask with `MASK32`
after every sum. Float32 sums (events, totals, entropy counts) are exact
only while every partial sum stays below 2**24, whatever the order; that
is the regime in which they equal the reference's (PERF.md §1).
"""

from __future__ import annotations

from typing import Sequence

import torch


def lane_fold(tensors: Sequence[torch.Tensor], op: str = "sum") -> torch.Tensor:
    """`tensors` (one a lane) folded in lane order onto lane 0's device:
    ``sum`` or ``max``. A fresh tensor."""
    if not tensors:
        raise ValueError("no lanes to fold")
    dev = tensors[0].device
    out = tensors[0].clone()
    for t in tensors[1:]:
        t = t.to(dev)
        if op == "sum":
            out.add_(t)
        elif op == "max":
            torch.maximum(out, t, out=out)
        else:
            raise ValueError(f"unknown fold {op!r}: sum or max")
    return out


def group_reduce_(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """All-reduce `t` in place across `group` (``sum`` or ``max``) and
    return it; without a group, `t` as it is."""
    if group is None:
        return t
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=group)
    return t


def psum(tensors: Sequence[torch.Tensor], group=None, op: str = "sum") -> torch.Tensor:
    """The lanes folded, then reduced across `group`'s ranks."""
    return group_reduce_(lane_fold(tensors, op), op, group)


def group_gather(t: torch.Tensor, group) -> torch.Tensor:
    """`t` of every rank of `group` concatenated along dim 0 in rank
    order (every rank's `t` has the same shape); without a group, `t`."""
    if group is None:
        return t
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)
