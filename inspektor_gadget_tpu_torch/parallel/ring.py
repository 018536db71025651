"""Ring all-reduces over the lanes of a mesh (PyTorch port of
``inspektor_gadget_tpu/parallel/ring.py``).

A lane tensor list holds one tensor a lane, lane k's on the mesh's k-th
device (`parallel.mesh`). A hop is the reference's ``ppermute`` from
lane i to lane i + 1: every lane takes its left neighbour's buffer, a
copy to its own device. Both schedules keep the reference's hop order,
so a float sum is the reference ring's, not ``psum``'s order.

- `ring_psum`: N-1 hops of the whole tensor; lane r ends with
  ``((x_r + x_{r-1}) + x_{r-2}) + ...``.
- `ring_psum_chunked`: reduce-scatter then all-gather over N chunks
  (the bandwidth-optimal 2(N-1)/N schedule): after the reduce-scatter
  lane r holds chunk (r + 1) mod N summed over every lane, and the
  all-gather circulates the reduced chunks.

Both are exact on integer tables and return new tensors; no input is
changed.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _hop(bufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """One ppermute i -> i + 1: lane r receives lane r - 1's buffer."""
    n = len(bufs)
    return [bufs[(r - 1) % n].to(bufs[r].device) for r in range(n)]


def ring_psum(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """All-reduce by N-1 ring hops of the full tensor: every lane's sum,
    on its own device."""
    n = len(xs)
    if n == 1:
        return [xs[0]]
    acc, buf = list(xs), list(xs)
    for _ in range(n - 1):
        buf = _hop(buf)
        acc = [a + b for a, b in zip(acc, buf)]
    return acc


def ring_psum_chunked(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Reduce-scatter + all-gather ring schedule: each lane's tensor is
    split into N chunks (zero-padded to a multiple of N); lane r reduces
    one chunk over N-1 hops, then the reduced chunks ride N-1 more hops
    to every lane."""
    n = len(xs)
    if n == 1:
        return [xs[0]]
    shape = xs[0].shape
    flat = [x.reshape(-1) for x in xs]
    pad = (-flat[0].shape[0]) % n
    if pad:
        flat = [torch.cat([f, f.new_zeros(pad)]) for f in flat]
    chunks = [list(f.reshape(n, -1).unbind(0)) for f in flat]
    # reduce-scatter: after step s, lane r holds the partial sum of chunk
    # (r - s - 1) mod n over s + 2 lanes
    send = [chunks[r][r] for r in range(n)]
    for s in range(n - 1):
        recv = _hop(send)
        for r in range(n):
            idx = (r - s - 1) % n
            chunks[r][idx] = chunks[r][idx] + recv[r]
            send[r] = chunks[r][idx]
    # all-gather: circulate each fully reduced chunk
    send = [chunks[r][(r + 1) % n] for r in range(n)]
    for s in range(n - 1):
        recv = _hop(send)
        for r in range(n):
            chunks[r][(r - s) % n] = recv[r]
            send[r] = recv[r]
    out = []
    for r in range(n):
        f = torch.stack(chunks[r]).reshape(-1)
        out.append((f[:-pad] if pad else f).reshape(shape))
    return out


__all__ = ["ring_psum", "ring_psum_chunked"]
