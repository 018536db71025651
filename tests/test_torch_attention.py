"""The port's attention (K3's plain version and backward, full and
blockwise attention) against the JAX package.

The JAX side of K3 runs as ``tests/test_flash_attention.py`` runs it:
``flash_attention(..., interpret=True)``, the Pallas kernel in the
interpreter, and ``jax.grad`` through it for gradients. The CUDA kernel
itself needs the card; ``chip_smoke.py`` holds it to the plain version
there. Tolerances: float32 outputs within 2e-4 and gradients within
2e-3, as the JAX tests hold the reference; bfloat16 outputs within one
bfloat16 rounding step (2^-7 relative), since both sides compute in
float32 and round once.

The bfloat16 kernel runs on the tensor cores and rounds the softmax
weights to bfloat16 before P·V. Its bound, `FA.k3_tolerance`, is held
here against an emulation of the kernel's numerics in torch on the CPU
(`_k3_bf16_emulation`), and shown to catch a faulty emulation.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inspektor_gadget_tpu.parallel.flash_attention import flash_attention as ref_flash
from inspektor_gadget_tpu.parallel.ring_attention import blockwise_attention as ref_blockwise
from inspektor_gadget_tpu.parallel.ring_attention import full_attention as ref_full
from inspektor_gadget_tpu_torch.parallel import flash_attention as FA
from inspektor_gadget_tpu_torch.parallel.ring_attention import blockwise_attention, full_attention

torch.set_num_threads(2)

SHAPES = [  # tests/test_flash_attention.py:14-19
    ((2, 256, 4, 32), True),
    ((1, 200, 2, 16), False),
    ((2, 128, 1, 128), True),
    ((1, 384, 2, 64), True),
]
BF16_ULP = 2.0 ** -7


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _jax(xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def _torch(xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _assert_bf16_close(got: torch.Tensor, want: jnp.ndarray):
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-6), \
        np.abs(got - want).max()


@pytest.mark.parametrize("shape,causal", SHAPES)
def test_flash_plain_matches_pallas_interpret(shape, causal):
    xs = _qkv(shape, 0)
    want = ref_flash(*_jax(xs), causal=causal, interpret=True)
    before = FA.flash_attention.launches
    got = FA.flash_attention(*_torch(xs), causal=causal)
    assert FA.flash_attention.launches == before  # the CPU takes the plain version
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_flash_plain_bf16_at_the_operator_window():
    """The operator's window: 256 tokens scored as T=255, heads of 32, bf16."""
    shape = (2, 255, 4, 32)
    xs = _qkv(shape, 5)
    want = ref_flash(*_jax(xs, jnp.bfloat16), causal=True, interpret=True)
    got = FA.flash_attention(*_torch(xs, torch.bfloat16), causal=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("shape,causal", SHAPES + [((2, 255, 4, 32), True)])
def test_full_attention_matches_jax(shape, causal):
    xs = _qkv(shape, 1)
    want = ref_full(*_jax(xs), causal=causal)
    got = full_attention(*_torch(xs), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape,causal,chunk", [
    ((2, 256, 4, 32), True, 128),
    ((1, 200, 2, 16), False, 40),
    ((1, 384, 2, 64), True, 128),
    ((2, 255, 4, 32), True, 85),
])
def test_blockwise_attention_matches_jax(shape, causal, chunk):
    xs = _qkv(shape, 2)
    want = ref_blockwise(*_jax(xs), causal=causal, chunk=chunk)
    got = blockwise_attention(*_torch(xs), causal=causal, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_blockwise_refuses_a_ragged_chunk():
    q = torch.zeros(1, 10, 1, 16)
    with pytest.raises(ValueError):
        blockwise_attention(q, q, q, chunk=4)


@pytest.mark.parametrize("shape", [(1, 128, 2, 32), (1, 251, 2, 16), (2, 255, 4, 32)])
def test_flash_gradients_match_jax(shape):
    """The autograd Function's recompute backward against ``jax.grad``
    through the reference (prime T=251: a ragged last chunk)."""
    xs = _qkv(shape, 4)

    def loss(q, k, v):
        return (ref_flash(q, k, v, causal=True, interpret=True) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*_jax(xs))
    ts = [t.requires_grad_() for t in _torch(xs)]
    (FA.flash_attention(*ts, causal=True) ** 2).sum().backward()
    for name, t, w in zip("qkv", ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_matches_autograd_through_the_plain_version(causal):
    """The chunked recompute (keys past a causal chunk dropped) gives the
    gradients of autograd through the streaming forward itself."""
    xs = _qkv((2, 200, 2, 32), 6)
    a = [t.requires_grad_() for t in _torch(xs)]
    b = [t.requires_grad_() for t in _torch(xs)]
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 200, 2, 32)).astype(np.float32))
    FA.flash_attention(*a, causal=causal).backward(g)
    FA.flash_attention_plain(*b, causal=causal).backward(g)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=2e-4, atol=2e-5)


def test_flash_first_row_attends_only_self():
    """Causal row 0 equals v[0] (a softmax over one key)."""
    q, k, v = _torch(_qkv((1, 128, 1, 32), 1))
    out = FA.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), v[0, 0, 0].numpy(), rtol=1e-5, atol=1e-5)


def test_flash_takes_strided_views():
    """The seq model hands K3 views of one qkv tensor; the plain version
    takes them as they are (the kernel reads their strides)."""
    qkv = torch.from_numpy(_qkv((2, 70, 3, 2, 16), 8)[0])
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    got = FA.flash_attention(q, k, v)
    want = FA.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


def test_flash_refuses_mixed_devices_and_kernel_shapes():
    x = torch.zeros(1, 8, 1, 16)
    meta = torch.zeros(1, 8, 1, 16, device="meta")
    with pytest.raises(ValueError):
        FA.flash_attention(x, meta, x)
    with pytest.raises(ValueError):  # the kernel's checks run before any launch
        FA._launch(*[torch.zeros(1, 8, 1, 24, device="meta")] * 3, True, 1.0)
    with pytest.raises(ValueError):
        FA._launch(*[torch.zeros(1, 8, 1, 16, dtype=torch.float16, device="meta")] * 3,
                   True, 1.0)


def _k3_bf16_emulation(q, k, v, causal: bool, shift: int = 0, rescale: bool = True):
    """The bfloat16 kernel's numerics in torch: bf16 Q·K^T into f32, the
    scale (folded with log2 e, for exp2) applied after the product, 64-key
    tiles, the running max and denominator in f32 rescaled once a tile,
    P rounded to bf16 before P·V. `shift` moves the causal mask by that
    many keys and `rescale=False` drops the rescale: two faults the
    tolerance must catch."""
    b, t, h, d = q.shape
    c = d ** -0.5 * math.log2(math.e)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # [B, H, T, D], exact
    m = torch.full((b, h, t), -1e30)
    l = torch.zeros(b, h, t)
    o = torch.zeros(b, h, t, d)
    rows = torch.arange(t)[:, None]
    for k0 in range(0, t, 64):
        s = (qf @ kf[:, :, k0:k0 + 64].transpose(-1, -2)) * c
        if causal:
            s = torch.where(torch.arange(k0, min(k0 + 64, t)) <= rows + shift, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp2(m - m_new) if rescale else torch.ones_like(m)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + p.bfloat16().float() @ vf[:, :, k0:k0 + 64]
        m = m_new
    return (o / l.clamp(min=1e-30)[..., None]).to(torch.bfloat16).transpose(1, 2)


def _bf16_qkv(shape, seed):
    return _torch(_qkv(shape, seed), torch.bfloat16)


def _within_k3_tolerance(got, want, v, causal) -> bool:
    return bool(((got.float() - want.float()).abs() <= FA.k3_tolerance(want, v, causal)).all())


@pytest.mark.parametrize("shape,causal", [((2, 255, 4, 32), True), ((1, 200, 2, 16), False),
                                          ((1, 384, 2, 64), True)])
def test_k3_bf16_emulation_within_tolerance(shape, causal):
    q, k, v = _bf16_qkv(shape, 10)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    got = _k3_bf16_emulation(q, k, v, causal)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    assert _within_k3_tolerance(got, want, v, causal)


@pytest.mark.parametrize("shape,causal,fault", [
    ((2, 255, 4, 32), True, "mask shifted"),
    ((2, 255, 4, 32), True, "no rescale"),
    ((1, 200, 2, 16), False, "no rescale"),
    ((1, 384, 2, 64), True, "mask shifted"),
    ((1, 384, 2, 64), True, "no rescale"),
])
def test_k3_tolerance_catches_a_fault(shape, causal, fault):
    """The tolerance is no blanket: a causal mask one key too wide, or a
    softmax that never rescales its running sums, falls outside it."""
    q, k, v = _bf16_qkv(shape, 10)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    got = _k3_bf16_emulation(q, k, v, causal, shift=int(fault == "mask shifted"),
                             rescale=fault != "no rescale")
    assert not _within_k3_tolerance(got, want, v, causal)


@pytest.mark.parametrize("causal,row_vmax", [(True, [2.0, 2.0, 8.0]), (False, [8.0, 8.0, 8.0])])
def test_k3_tolerance_takes_max_v_over_the_keys_a_row_sees(causal, row_vmax):
    """2^-7·|want| + 2^-9·max|v| + 1e-6, max|v| over every dim of the keys
    row i sees: keys j <= i when causal, all keys otherwise."""
    v = torch.zeros(1, 3, 1, 2)
    v[0, 0, 0] = torch.tensor([1.0, -2.0])
    v[0, 1, 0] = torch.tensor([0.5, 0.25])
    v[0, 2, 0] = torch.tensor([0.0, 8.0])
    want = torch.tensor([1.0, -4.0, 0.0]).reshape(1, 3, 1, 1).expand(1, 3, 1, 2)
    tol = FA.k3_tolerance(want.bfloat16(), v.bfloat16(), causal)
    expect = 2.0 ** -7 * want.abs() + 2.0 ** -9 * torch.tensor(row_vmax).reshape(1, 3, 1, 1) + 1e-6
    assert tol.shape == want.shape
    torch.testing.assert_close(tol, expect, rtol=0, atol=0)


def _metas(*xs):
    return [(x.shape, x.stride(), x.data_ptr(), x.dtype, x.device) for x in xs]


@pytest.mark.parametrize("d", FA.KERNEL_D)
def test_flash_accepts_the_seq_models_qkv_views(d):
    """The seq model hands K3 views of one [B, T, 3, H, D] qkv tensor
    (models/seqmodel.py seq_apply): their rows start on 16 bytes."""
    qkv = torch.zeros(2, 255, 3, 4, d, dtype=torch.bfloat16)
    FA.check_kernel_inputs(_metas(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]))


@pytest.mark.parametrize("case", ["time stride 20", "pointer off 16 bytes", "float32 any rows"])
def test_flash_bf16_refuses_rows_off_16_bytes(case):
    """The bfloat16 kernel copies rows by 16-byte cp.async: a time stride
    that is not a multiple of 8 elements, or a data pointer off 16 bytes,
    is refused (never copied); the float32 kernel reads any row."""
    if case == "time stride 20":
        x = torch.zeros(1, 8, 1, 20, dtype=torch.bfloat16)[..., :16]
    elif case == "pointer off 16 bytes":
        x = torch.zeros(1, 8, 1, 24, dtype=torch.bfloat16)[..., 4:20]
    else:
        x = torch.zeros(1, 8, 1, 20)[..., 2:18]
    assert x.stride(-1) == 1
    if x.dtype == torch.float32:
        FA.check_kernel_inputs(_metas(x, x, x))
        return
    with pytest.raises(ValueError, match="16-byte"):
        FA.check_kernel_inputs(_metas(x, x, x))
