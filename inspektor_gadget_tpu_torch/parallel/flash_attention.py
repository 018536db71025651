"""K3, flash attention: the fused forward of the seq scorer's
``attn="flash"`` backend, its plain version, and its backward.

`flash_attention` replaces ``inspektor_gadget_tpu/parallel/flash_attention.py:86``.
Layout [B, T, H, D], as in the reference. For CUDA tensors it launches
``ig_flash_attention`` (``csrc/flash_attention.cu``, which also says what
bounds it and how it is built) and counts the launch in
``flash_attention.launches``; for CPU tensors it computes
`flash_attention_plain`. Any T; on the card D is 16, 32, 64 or 128, in
float32 or bfloat16. The kernel reads q, k and v through their strides
(the seq model's are views of one qkv tensor), so nothing is copied; the
last dim must have unit stride.

Differentiable, as the reference's ``custom_vjp``: the forward is the
kernel (or the plain version), the backward is the reference's
``_recompute_ref`` (``:142``) in PyTorch, one query chunk of 128 at a
time, so the backward keeps O(chunk·T) scores and never the [T, T]
matrix. The reference's backward is plain XLA, not a Pallas kernel; a
hand-written backward kernel is later work (ROADMAP).
"""

from __future__ import annotations

import ctypes

import torch

from ..native import CudaLibrary, check, on_cpu, stream
from .ring_attention import full_attention, streaming_attention

BLOCK = 128  # the reference's block; the plain version's key block
CHUNK = 128  # query rows per backward recompute (the reference's chunk)
KERNEL_D = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib) -> None:
    vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.ig_flash_attention.argtypes = [vp, vp, vp, vp, i, i, i, i, i,
                                       ll, ll, ll, ll, ll, ll, ll, ll, ll, i, f, vp]
    lib.ig_flash_attention.restype = i


LIBRARY = CudaLibrary("flash_attention.cu", _bind)


def flash_attention_plain(q, k, v, causal: bool = True, block: int = BLOCK,
                          scale: float | None = None) -> torch.Tensor:
    """Plain version of K3, the reference kernel's schedule: q cast to f32
    and scaled, then a streaming softmax over key blocks of `block`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return streaming_attention(q.float() * scale, k, v, causal, block, 1.0, q.dtype)


def _launch(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """K3 on the card: a contiguous [B, T, H, D] output in q's type."""
    b, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"K3 takes float32 or bfloat16 q, k, v of one type, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in KERNEL_D:
        raise ValueError(f"K3 takes head dims {KERNEL_D}, got {d}")
    if q.device != k.device or q.device != v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("K3 needs unit stride over the head dim")
    dev = q.device
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
    if b * t * h == 0:
        return out
    lib = LIBRARY.get()
    with torch.cuda.device(dev):
        check(lib.ig_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            b, t, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
            scale, stream(dev)), "ig_flash_attention")
    flash_attention.launches += 1
    return out


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block: int, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        if on_cpu(q, k, v):
            return flash_attention_plain(q, k, v, causal, block, scale)
        return _launch(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        t = q.shape[1]
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        with torch.enable_grad():
            for c0 in range(0, t, CHUNK):
                c1 = min(c0 + CHUNK, t)
                # causal: keys past the chunk's last row weigh exactly 0
                n_k = c1 if ctx.causal else t
                qc = q[:, c0:c1].detach().requires_grad_()
                kc = k[:, :n_k].detach().requires_grad_()
                vc = v[:, :n_k].detach().requires_grad_()
                # the reference's _recompute_ref: scores scaled after the dot
                out = full_attention(qc, kc, vc, ctx.causal, ctx.scale, q_offset=c0)
                gq, gk, gv = torch.autograd.grad(out, (qc, kc, vc), g[:, c0:c1])
                dq[:, c0:c1] = gq
                dk[:, :n_k] += gk
                dv[:, :n_k] += gv
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention(q, k, v, causal: bool = True, block: int = BLOCK,
                    scale: float | None = None) -> torch.Tensor:
    """Fused attention, layout [B, T, H, D] -> [B, T, H, D] in q's type.
    CUDA tensors launch K3, CPU tensors take `flash_attention_plain`
    (`block` is its key block; the kernel's tiles are its own)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Flash.apply(q, k, v, causal, block, scale)


flash_attention.launches = 0
