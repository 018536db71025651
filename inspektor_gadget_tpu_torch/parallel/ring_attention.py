"""Single-device attention of the sequence plane (PyTorch port of
``inspektor_gadget_tpu/parallel/ring_attention.py:43-112``).

Layout [B, T, H, D], as in the reference. Scores, softmax state and the
accumulator are float32 whatever the input type: a bf16 product is exact
in float32, so ``q.float() @ k.float()`` is the reference's bf16 dot
with ``preferred_element_type=float32``.

- `full_attention`: materialised [T, T] scores.
- `blockwise_attention`: streaming softmax over KV chunks,
  O(T·chunk) memory (`streaming_attention`, which K3's plain version
  shares).

``ring_attention`` and ``ulysses_attention`` shard the sequence over a
mesh axis; they wait for the port of the training-side parallelism
(ROADMAP queue A item 13).
"""

from __future__ import annotations

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
