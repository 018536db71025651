"""K3, flash attention: the fused forward of the seq scorer's
``attn="flash"`` backend, its plain version, and its backward.

`flash_attention` replaces ``inspektor_gadget_tpu/parallel/flash_attention.py:86``.
Layout [B, T, H, D], as in the reference. For CUDA tensors it launches
``ig_flash_attention`` (``csrc/flash_attention.cu``, which also says what
bounds it and how it is built) and counts the launch in
``flash_attention.launches``; for CPU tensors it computes
`flash_attention_plain`. Any T; on the card D is 16, 32, 64 or 128.
bfloat16 inputs go to the tensor-core kernel, float32 inputs to the
CUDA-core one. The kernels read q, k and v through their strides (the
seq model's are views of one qkv tensor), so nothing is copied; the last
dim must have unit stride, and for bfloat16 every row must start on 16
bytes (`check_kernel_inputs`): the wrapper raises, it never copies.

The bfloat16 kernel rounds the softmax weights P to bfloat16 before
P·V, where the reference keeps them in f32; `k3_tolerance` states how
far that may move its output.

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
BF16_STEP = 2.0 ** -7  # one bfloat16 rounding step, relative
P_ROUND = 2.0 ** -9  # the weights P rounded to bfloat16, relative to max|v|


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


def k3_tolerance(want: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """How far K3's bfloat16 output may lie from `want`, its plain
    version's, elementwise: for output (b, i, h, d)

        2^-7·|want| + 2^-9·max_{j seen by row i} max_d |v[b, j, h, d]| + 1e-6

    - 2^-7·|want|: one bfloat16 rounding step of the output; the two
      sides round different f32 values, which may straddle a step.
    - 2^-9·max|v|: the tensor cores take P·V with P rounded to bfloat16
      (the denominator sums the f32 weights). Rounding to nearest moves a
      weight by at most 2^-8 of itself (8 significant bits), so the
      weighted mean of v moves by at most 2^-8·sum(p·|v|)/sum(p). Where
      v has one sign that is 2^-8·|want|; where its signs cancel (|want|
      near 0) each sign holds at most half the weight, and the move
      reaches 2^-8·max|v| only if every weight rounds toward the sign of
      its v. The weights round independently, so the bound takes half
      that worst case. max|v| is over the keys the row sees: all keys,
      or keys j <= i when causal.
    - 1e-6: bf16 products are exact in f32; the f32 sum order, the scale
      applied after the product and exp2 for exp move the rest by ~1e-7
      relative."""
    vmax = v.float().abs().amax(dim=-1, keepdim=True)  # [B, T, H, 1]
    vmax = vmax.cummax(dim=1).values if causal else vmax.amax(dim=1, keepdim=True)
    return BF16_STEP * want.float().abs() + P_ROUND * vmax + 1e-6


def check_kernel_inputs(metas) -> None:
    """Raise ValueError for q, k, v that K3 does not take. `metas` holds
    (shape, strides, data pointer, dtype, device) of q, k and v, so the
    checks need no tensor on the card. Every input: one [B, T, H, D]
    shape, one type (float32 or bfloat16), one device, D in `KERNEL_D`,
    unit stride over D. bfloat16 (the tensor-core kernel's cp.async
    copies 16-byte row chunks): every data pointer 16-byte aligned and
    every batch, time and head stride of a dim longer than 1 a multiple
    of 8 elements. Nothing is copied to make an input fit."""
    (shape, _, _, dtype, device), *rest = metas
    if any(tuple(m[0]) != tuple(shape) for m in rest) or len(shape) != 4:
        raise ValueError(f"q, k, v shapes differ or are not [B, T, H, D]: "
                         f"{[tuple(m[0]) for m in metas]}")
    if any(m[3] != dtype for m in rest) or dtype not in _DTYPES:
        raise ValueError(f"K3 takes float32 or bfloat16 q, k, v of one type, "
                         f"got {[m[3] for m in metas]}")
    if shape[-1] not in KERNEL_D:
        raise ValueError(f"K3 takes head dims {KERNEL_D}, got {shape[-1]}")
    if any(m[4] != device for m in rest):
        raise ValueError(f"q, k, v on {[m[4] for m in metas]}")
    if any(m[1][-1] != 1 for m in metas):
        raise ValueError("K3 needs unit stride over the head dim")
    if dtype == torch.bfloat16:
        for name, (_, strides, ptr, _, _) in zip("qkv", metas):
            if ptr % 16 or any(n > 1 and st % 8 for n, st in zip(shape[:3], strides[:3])):
                raise ValueError(
                    f"K3 bfloat16 needs 16-byte aligned rows: {name} at {ptr:#x} with "
                    f"strides {tuple(strides)} (pointer % 16 == 0, batch, time and head "
                    f"strides multiples of 8)")


def _launch(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """K3 on the card: a contiguous [B, T, H, D] output in q's type."""
    check_kernel_inputs([(x.shape, x.stride(), x.data_ptr(), x.dtype, x.device)
                         for x in (q, k, v)])
    b, t, h, d = q.shape
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
