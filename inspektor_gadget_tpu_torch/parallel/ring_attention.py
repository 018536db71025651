"""Attention of the sequence plane (PyTorch port of
``inspektor_gadget_tpu/parallel/ring_attention.py``).

Layout [B, T, H, D], as in the reference. Scores, softmax state and the
accumulator are float32 whatever the input type: a bf16 product is exact
in float32, so ``q.float() @ k.float()`` is the reference's bf16 dot
with ``preferred_element_type=float32``.

- `full_attention`: materialised [T, T] scores.
- `blockwise_attention`: streaming softmax over KV chunks,
  O(T·chunk) memory (`streaming_attention`, which K3's plain version
  shares).

The sequence shards over the lanes of a mesh (`parallel.mesh`): lane r
holds rows ``r * T_local`` to ``(r + 1) * T_local - 1`` of every
sequence, on its own device, and each function below takes and returns
one tensor a lane.

- `ring_attention`: KV blocks rotate lane -> lane + 1 for N hops while
  each lane folds its queries' streaming softmax; the queries never
  move.
- `ulysses_attention`: one all-to-all re-shards sequence <-> heads, full
  attention runs on each lane's head subset, a second all-to-all
  restores the sequence shards. H must divide by the lane count.
- `make_ring_attention`: either of them on whole [B, T, H, D] tensors.

A hop or an all-to-all is a copy to the receiving lane's device, so
autograd runs across the lanes in one process.
"""

from __future__ import annotations

from typing import Sequence

import torch

_NEG = -1e30  # finite "-inf": a fully masked block gives exp() = 0, not NaN


def _block_update(q, k, v, o, m, l, pos_q, pos_k, causal: bool, scale):
    """One streaming-softmax step. q: [B,H,Tq,D]; k, v: [B,H,Tk,D];
    o: [B,H,Tq,D] f32; m, l: [B,H,Tq] f32. Returns the new (o, m, l)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = torch.where(pos_q[:, None] >= pos_k[None, :], s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o_new, m_new, l_new


def _finish(o, l, dtype):
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def full_attention(q, k, v, causal: bool = True, scale: float | None = None,
                   q_offset: int = 0):
    """Materialised-scores reference. Layout [B, T, H, D]; q may be the
    rows from `q_offset` on of a longer sequence (causal masking counts
    positions from there), and k, v any prefix of its keys."""
    scale = scale or q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos_q = q_offset + torch.arange(q.shape[1], device=q.device)
        pos_k = torch.arange(k.shape[1], device=q.device)
        s = torch.where(pos_q[:, None] >= pos_k[None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def streaming_attention(q, k, v, causal: bool, chunk: int, scale: float, dtype):
    """Streaming softmax over KV chunks of `chunk` keys, the last one
    possibly short. Layout [B, T, H, D]; the output is cast to `dtype`."""
    b, t, h, d = q.shape
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [B,H,T,D]
    pos = torch.arange(t, device=q.device)
    o = torch.zeros(b, h, t, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, h, t, dtype=torch.float32, device=q.device)
    for c0 in range(0, t, chunk):
        sl = slice(c0, c0 + chunk)
        o, m, l = _block_update(qt, kt[:, :, sl], vt[:, :, sl], o, m, l, pos, pos[sl],
                                causal, scale)
    return _finish(o, l, dtype).transpose(1, 2)


def blockwise_attention(q, k, v, causal: bool = True, chunk: int = 128,
                        scale: float | None = None):
    """Streaming softmax over KV chunks of `chunk` keys. Layout
    [B, T, H, D]; T must be divisible by `chunk`, as in the reference."""
    t = q.shape[1]
    if t % chunk:
        raise ValueError(f"T={t} is not divisible by chunk={chunk}")
    return streaming_attention(q, k, v, causal, chunk, scale or q.shape[-1] ** -0.5, q.dtype)


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], causal: bool = True,
                   scale: float | None = None) -> list[torch.Tensor]:
    """Ring attention over a sequence sharded across lanes: lane r's
    shards [B, T_local, H, D] hold the global rows from ``r * T_local``.
    At hop s lane r folds the KV block of lane (r - s) mod N, as the
    reference's ``ppermute`` delivers it. Returns each lane's output
    shard, in q's dtype, on its device."""
    n = len(qs)
    b, t, h, d = qs[0].shape
    scale = scale or d ** -0.5
    state = []
    for r, q in enumerate(qs):
        dev = q.device
        pos_q = r * t + torch.arange(t, device=dev)
        state.append([q.transpose(1, 2),
                      torch.zeros(b, h, t, d, dtype=torch.float32, device=dev),
                      torch.full((b, h, t), _NEG, dtype=torch.float32, device=dev),
                      torch.zeros(b, h, t, dtype=torch.float32, device=dev), pos_q])
    kt = [k.transpose(1, 2) for k in ks]
    vt = [v.transpose(1, 2) for v in vs]
    for s in range(n):
        for r, (qt, o, m, l, pos_q) in enumerate(state):
            src = (r - s) % n  # whose block lane r holds at this hop
            dev = qt.device
            pos_k = src * t + torch.arange(t, device=dev)
            state[r][1:4] = _block_update(qt, kt[src].to(dev), vt[src].to(dev), o, m, l,
                                          pos_q, pos_k, causal, scale)
    return [_finish(o, l, q.dtype).transpose(1, 2)
            for (_, o, _, l, _), q in zip(state, qs)]


def _all_to_all(xs: Sequence[torch.Tensor], split: int, concat: int) -> list[torch.Tensor]:
    """The reference's tiled ``lax.all_to_all``: lane j receives chunk j
    of every lane's `split` dim, concatenated along `concat` in lane
    order, on its own device."""
    n = len(xs)
    parts = [x.chunk(n, dim=split) for x in xs]
    return [torch.cat([parts[i][j].to(xs[j].device) for i in range(n)], dim=concat)
            for j in range(n)]


def ulysses_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                      vs: Sequence[torch.Tensor], causal: bool = True,
                      scale: float | None = None) -> list[torch.Tensor]:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism: sequence
    shards [B, T_local, H, D] become head shards [B, T, H / N, D], each
    lane runs `full_attention` on its heads, and the output goes back to
    sequence shards."""
    n = len(qs)
    h = qs[0].shape[2]
    if h % n:
        raise ValueError(f"heads {h} not divisible by the {n} lane(s)")
    qg, kg, vg = (_all_to_all(xs, 2, 1) for xs in (qs, ks, vs))
    og = [full_attention(q, k, v, causal=causal, scale=scale) for q, k, v in zip(qg, kg, vg)]
    return _all_to_all(og, 1, 2)


def make_ring_attention(mesh: Sequence[torch.device], axis: str = "seq", causal: bool = True,
                        impl: str = "ring"):
    """Attention on whole [B, T, H, D] tensors with T sharded over the
    lanes of `mesh`: ``fn(q, k, v)`` returns [B, T, H, D] on q's device.
    T must divide by the lane count. `axis` names the sharded axis, as
    in the reference."""
    inner = {"ring": ring_attention, "ulysses": ulysses_attention}[impl]
    lanes = [torch.device(d) for d in mesh]
    n = len(lanes)

    def fn(q, k, v):
        if q.shape[1] % n:
            raise ValueError(f"T={q.shape[1]} is not divisible by the {n} lane(s)")
        shard = [[c.to(d) for c, d in zip(x.chunk(n, dim=1), lanes)] for x in (q, k, v)]
        out = inner(*shard, causal=causal)
        return torch.cat([o.to(q.device) for o in out], dim=1)

    return fn
