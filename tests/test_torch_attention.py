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
"""

from __future__ import annotations

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
