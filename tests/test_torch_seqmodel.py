"""The port's sequence scorer against the JAX package, from carried
weights.

Both sides start from the reference's ``seq_init`` weights (carried into
the port with `params_from_numpy`) and see the same token matrix: a full
row, two rows padded with -1 and a filler row of -1, as the operator
builds it. T = 129 after the next-token shift, so K3's plain version
walks a ragged second block. Tolerances: a float32 config is held within
1e-4 (logits, scores, losses, and parameters after three AdamW steps);
the bf16 default, whose activations round to 8 bits of mantissa at other
places in the two frameworks, within 3e-2 on logits and scores, 1e-2 on
losses and 5e-3 on parameters (an Adam step moves a weight by about lr
= 1e-3 whatever its gradient's size).

The key bias (``qkv.b[d:2d]``) is not compared across frameworks: adding
a constant to every key shifts each query's scores by one constant,
which the softmax ignores, so its gradient is zero up to rounding, and
Adam, which normalises a gradient by its own size, moves it by up to lr
in a direction set by rounding noise. It is held to that bound instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inspektor_gadget_tpu.models import seqmodel as R
from inspektor_gadget_tpu_torch.models import (adam_state_from_optax, params_from_numpy,
                                               params_to_numpy, seq_window_matrix)
from inspektor_gadget_tpu_torch.models import seqmodel as P
from inspektor_gadget_tpu_torch.models.params import _flatten
from inspektor_gadget_tpu_torch.parallel import flash_attention as FA

torch.set_num_threads(2)

SMALL = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(out=1e-4, loss=1e-4, param=1e-4),
       "bf16": dict(out=3e-2, loss=1e-2, param=5e-3)}
ATTNS = ("full", "flash", "blockwise")


def _configs(dtype: str):
    jd, td = DTYPES[dtype]
    return R.SeqConfig(**SMALL, dtype=jd), P.SeqConfig(**SMALL, dtype=td)


def _tokens(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, SMALL["vocab"], (4, 130)).astype(np.int32)
    toks[1, 70:] = -1
    toks[2, 9:] = -1
    toks[3] = -1
    return toks


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _pair(dtype: str, seed: int = 0):
    """A reference scorer and a port scorer holding its weights."""
    rcfg, pcfg = _configs(dtype)
    ref = R.seq_init(rcfg, seed=seed)
    port = P.seq_init(pcfg, seed=seed, device="cpu")
    params_from_numpy(port, _numpy_tree(ref.params))
    return ref, port


def _assert_params_close(port, ref_params, tol, steps, ctx=""):
    want = _flatten(_numpy_tree(ref_params))
    got = _flatten(params_to_numpy(port))
    assert set(want) == set(got)
    d, lr = port.config.d_model, port.config.lr
    for name in want:
        g, w = got[name], want[name]
        if name.endswith("qkv.b"):
            for x in (g, w):  # the key bias: Adam's step bound from its initial zero
                assert np.abs(x[d:2 * d]).max() <= 2 * lr * steps, (ctx, name)
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=f"{ctx} {name}")


def test_weight_carry_round_trip_is_identity():
    ref, port = _pair("bf16", seed=3)
    back = params_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(_numpy_tree(ref.params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_numpy_tree(ref.params))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("attn", ATTNS)
def test_seq_apply_matches_jax(attn, dtype):
    ref, port = _pair(dtype)
    toks = _tokens()[:, :-1]
    want = np.asarray(R.seq_apply(ref.params, jnp.asarray(toks), ref.config, attn=attn))
    got = P.seq_apply(port.model, torch.from_numpy(toks).long(), port.config, attn)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = TOL[dtype]["out"]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("attn", ATTNS)
def test_seq_score_matches_jax(attn, dtype):
    ref, port = _pair(dtype, seed=1)
    toks = _tokens(1)
    want = np.asarray(R.seq_score(ref, jnp.asarray(toks), attn=attn))
    before = FA.flash_attention.launches
    got = P.seq_score(port, toks, attn).numpy()
    assert FA.flash_attention.launches == before
    assert np.isfinite(got).all() and got[3] == 0.0  # the filler row is masked out
    tol = TOL[dtype]["out"]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("attn", ["full", "flash"])
def test_three_train_steps_match_jax(attn, dtype):
    ref, port = _pair(dtype, seed=2)
    tol = TOL[dtype]
    for i in range(3):
        toks = _tokens(10 + i)
        ref, want = R.seq_train_step(ref, jnp.asarray(toks), attn=attn)
        port, got = P.seq_train_step(port, toks, attn)
        np.testing.assert_allclose(float(got), float(want), rtol=tol["loss"], atol=tol["loss"],
                                   err_msg=f"loss {i}")
        _assert_params_close(port, ref.params, tol["param"], i + 1, ctx=f"step {i}")
    assert port.steps == ref.steps == 3


def test_step_from_a_carried_adamw_state_matches_jax():
    """Two reference steps, then the params, AdamW moments and step count
    carried into a fresh port scorer: the third step matches."""
    ref, _ = _pair("f32", seed=4)
    for i in range(2):
        ref, _ = R.seq_train_step(ref, jnp.asarray(_tokens(20 + i)), attn="full")
    port = P.seq_init(_configs("f32")[1], seed=99, device="cpu")
    params_from_numpy(port, _numpy_tree(ref.params))
    adam = ref.opt_state[0]
    adam_state_from_optax(port, _numpy_tree(adam.mu), _numpy_tree(adam.nu), int(adam.count))
    toks = _tokens(22)
    ref, want = R.seq_train_step(ref, jnp.asarray(toks), attn="full")
    port, got = P.seq_train_step(port, toks, "full")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-4)
    _assert_params_close(port, ref.params, 1e-4, 3, ctx="carried")


def test_tokens_from_keys_matches_jax():
    keys = np.random.default_rng(5).integers(0, 2**63, 1000, dtype=np.uint64)
    assert np.array_equal(P.tokens_from_keys(keys, 512), R.tokens_from_keys(keys, 512))


def test_seq_window_matrix_is_the_operators():
    """tpusketch.py:1544-1557: containers under 4 tokens left out, width
    the longest window rounded up to a power of two (at most the window),
    rows rounded up to a power of two, -1 padding and filler."""
    windows = [list(range(10)), [1, 2, 3], list(range(5)), list(range(32)), [7] * 4]
    mat, n = seq_window_matrix(windows, window=32)
    assert n == 4 and mat.shape == (4, 32) and mat.dtype == np.int32
    assert list(mat[0, :10]) == list(range(10)) and (mat[0, 10:] == -1).all()
    assert list(mat[2]) == list(range(32)) and list(mat[3, :5]) == [7, 7, 7, 7, -1]
    mat, n = seq_window_matrix([list(range(6)), list(range(5)), [1] * 9], window=256)
    assert n == 3 and mat.shape == (4, 16) and (mat[3] == -1).all()
    assert seq_window_matrix([[1, 2]], window=256) is None


def test_moe_weights_carry_round_trip_from_jax():
    """The MoE configuration (ROADMAP item 13) builds the reference's
    parameter tree: its weights carry in and back out unchanged, and the
    scores of both packages agree (tests/test_torch_moe_pipeline.py
    holds its steps, the EP and SP steps)."""
    small = dict(SMALL, n_experts=4)
    ref = R.seq_init(R.SeqConfig(**small, dtype=jnp.float32), seed=5)
    port = P.seq_init(P.SeqConfig(**small, dtype=torch.float32), seed=5, device="cpu")
    params_from_numpy(port, _numpy_tree(ref.params))
    back = params_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(_numpy_tree(ref.params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_numpy_tree(ref.params))):
        assert np.array_equal(a, b)
    toks = _tokens(5)
    np.testing.assert_allclose(P.seq_score(port, toks, "full").numpy(),
                               np.asarray(R.seq_score(ref, jnp.asarray(toks), attn="full")),
                               rtol=1e-3, atol=1e-3)


def test_lane_backends_and_unknown_backends():
    """``ring`` and ``ulysses`` on one lane attend over the whole window;
    an unknown backend raises."""
    q = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 8, 2, 16)).astype(np.float32))
    want = P.full_attention(q, q, q, causal=True)
    for attn in ("ring", "ulysses"):
        (got,) = P._LANE_ATTN[attn]([q], [q], [q], causal=True)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError):
        P._attend(q, q, q, "nope")
