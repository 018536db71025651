"""The port's AE and VAE scorers, and the harvest tick of all three
families, against the JAX package from carried weights.

Inputs are per-container event-count matrices made with numpy from a
seed, normalised as the operator does. The VAE's reparameterisation
noise is the reference's own draw, fed to the port. Tolerances: a
float32 compute type is held within 1e-4 (scores, losses, parameters);
the bf16 default, which rounds activations at other places in the two
frameworks, within 2e-2 relative on scores and losses and 5e-3 on
parameters (an Adam step moves a weight by about lr = 1e-3 whatever its
gradient's size).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inspektor_gadget_tpu.models import autoencoder as RA
from inspektor_gadget_tpu.models import seqmodel as RS
from inspektor_gadget_tpu.models import vae as RV
from inspektor_gadget_tpu_torch.models import (adam_state_from_optax, harvest_tick,
                                               params_from_numpy, params_to_numpy,
                                               seq_window_matrix)
from inspektor_gadget_tpu_torch.models import autoencoder as PA
from inspektor_gadget_tpu_torch.models import seqmodel as PS
from inspektor_gadget_tpu_torch.models import vae as PV

torch.set_num_threads(2)

DIMS = dict(input_dim=64, hidden_dim=32, latent_dim=8)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(out=1e-4, param=1e-4), "bf16": dict(out=2e-2, param=5e-3)}


def _counts(seed: int, rows: int = 8) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.zipf(1.5, (rows, DIMS["input_dim"])).clip(max=1000).astype(np.float32)
    c[rng.random(c.shape) < 0.5] = 0
    c[-1] = 0  # a container with no events yet
    return c


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _pair(family: str, dtype: str, seed: int = 0):
    jd, td = DTYPES[dtype]
    if family == "ae":
        ref = RA.ae_init(RA.AEConfig(**DIMS, compute_dtype=jd), seed=seed)
        port = PA.ae_init(PA.AEConfig(**DIMS, compute_dtype=td), seed=seed, device="cpu")
    else:
        ref = RV.vae_init(RV.VAEConfig(**DIMS, compute_dtype=jd), seed=seed)
        port = PV.vae_init(PV.VAEConfig(**DIMS, compute_dtype=td), seed=seed, device="cpu")
    params_from_numpy(port, _numpy_tree(ref.params))
    return ref, port


def _x(seed: int):
    c = _counts(seed)
    return RA.normalize_counts(jnp.asarray(c)), PA.normalize_counts(torch.from_numpy(c))


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol,
                               err_msg=what)


def _assert_params_close(port, ref, tol):
    for a, b in zip(jax.tree.leaves(params_to_numpy(port)), jax.tree.leaves(_numpy_tree(ref.params))):
        _close(torch.from_numpy(a), b, tol)


def _vae_eps(ref) -> jnp.ndarray:
    """The noise the reference's vae_train_step draws from its state."""
    key, _ = jax.random.split(ref.rng)
    return jax.random.normal(key, (8, DIMS["latent_dim"]), jnp.float32)


def test_normalize_counts_matches_jax():
    rx, px = _x(0)
    _close(px, rx, 1e-6)
    assert float(px[-1].abs().sum()) == 0.0  # an empty row stays zero, not NaN


@pytest.mark.parametrize("family", ["ae", "vae"])
def test_weight_carry_round_trip_is_identity(family):
    ref, port = _pair(family, "bf16", seed=3)
    back = params_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(_numpy_tree(ref.params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_numpy_tree(ref.params))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("family", ["ae", "vae"])
def test_score_matches_jax(family, dtype):
    ref, port = _pair(family, dtype, seed=1)
    rx, px = _x(1)
    score = (RA.ae_score, PA.ae_score) if family == "ae" else (RV.vae_score, PV.vae_score)
    want, got = score[0](ref, rx), score[1](port, px)
    assert got.shape == (8,) and torch.isfinite(got).all()
    _close(got, want, TOL[dtype]["out"] * max(1.0, float(np.abs(np.asarray(want)).max())))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vae_elbo_terms_with_the_reference_noise(dtype):
    ref, port = _pair("vae", dtype, seed=2)
    rx, px = _x(2)
    eps = _vae_eps(ref)
    want = RV.vae_elbo_terms(ref.params, rx, jax.random.split(ref.rng)[0], ref.config)
    got = PV.vae_elbo_terms(port.model, px, torch.from_numpy(np.array(eps)), port.config)
    for g, w, name in zip(got, want, ("reconstruction", "kl")):
        _close(g, w, TOL[dtype]["out"] * max(1.0, float(np.abs(np.asarray(w)).max())), name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("family", ["ae", "vae"])
def test_train_step_matches_jax(family, dtype):
    ref, port = _pair(family, dtype, seed=4)
    rx, px = _x(4)
    if family == "ae":
        ref, want = RA.ae_train_step(ref, rx)
        port, got = PA.ae_train_step(port, px)
    else:
        eps = torch.from_numpy(np.array(_vae_eps(ref)))
        ref, want = RV.vae_train_step(ref, rx)
        port, got = PV.vae_train_step(port, px, eps)
    tol = TOL[dtype]
    _close(got, want, tol["out"] * max(1.0, abs(float(want))), "loss")
    _assert_params_close(port, ref, tol["param"])
    assert port.steps == int(ref.steps) == 1


@pytest.mark.parametrize("family", ["ae", "vae"])
def test_step_from_a_carried_adam_state_matches_jax(family):
    """Two reference steps, then the weights, Adam moments and count
    carried into a fresh port scorer: the third step matches."""
    ref, _ = _pair(family, "f32", seed=5)
    steps = (RA.ae_train_step if family == "ae" else RV.vae_train_step)
    for i in range(2):
        ref, _ = steps(ref, _x(10 + i)[0])
    _, port = _pair(family, "f32", seed=77)
    params_from_numpy(port, _numpy_tree(ref.params))
    adam = ref.opt_state[0]
    adam_state_from_optax(port, _numpy_tree(adam.mu), _numpy_tree(adam.nu), int(adam.count))
    rx, px = _x(12)
    if family == "ae":
        ref, want = RA.ae_train_step(ref, rx)
        port, got = PA.ae_train_step(port, px)
    else:
        eps = torch.from_numpy(np.array(_vae_eps(ref)))
        ref, want = RV.vae_train_step(ref, rx)
        port, got = PV.vae_train_step(port, px, eps)
    _close(got, want, 1e-4 * max(1.0, abs(float(want))), "loss")
    _assert_params_close(port, ref, 1e-4)


def test_ae_harvest_tick_matches_the_operators():
    """tpusketch.py:1909-1918 for anomaly-model=ae: normalise the counts,
    one step, then score, three ticks over growing counts."""
    ref, port = _pair("ae", "f32", seed=6)
    counts = np.zeros((8, DIMS["input_dim"]), np.float32)
    for i in range(3):
        counts += _counts(20 + i)
        x = RA.normalize_counts(jnp.asarray(counts))
        ref, want_loss = RA.ae_train_step(ref, x)
        want = RA.ae_score(ref, x)
        loss, got = harvest_tick(port, counts)
        _close(loss, want_loss, 1e-4, f"loss {i}")
        _close(got, want, 1e-4 * max(1.0, float(np.abs(np.asarray(want)).max())), f"tick {i}")


def test_vae_harvest_tick_draws_fresh_noise_each_tick():
    _, port = _pair("vae", "f32", seed=7)
    counts = _counts(30)
    draws = []
    for _ in range(2):
        draws.append(port.gen.get_state().clone())
        loss, scores = harvest_tick(port, counts)
        assert scores.shape == (8,) and torch.isfinite(scores).all() and torch.isfinite(loss)
    assert port.steps == 2 and not torch.equal(draws[0], draws[1])


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_seq_harvest_tick_matches_the_operators(attn):
    """tpusketch.py:1540-1560 for anomaly-model=seq: the windows' token
    matrix, one step, then the score, two ticks."""
    cfg = dict(vocab=32, d_model=32, n_heads=2, n_layers=1, d_ff=64)
    ref = RS.seq_init(RS.SeqConfig(**cfg, dtype=jnp.float32), seed=8)
    port = PS.seq_init(PS.SeqConfig(**cfg, dtype=torch.float32), seed=8, device="cpu")
    params_from_numpy(port, _numpy_tree(ref.params))
    rng = np.random.default_rng(8)
    windows = [list(rng.integers(0, 32, n)) for n in (40, 64, 2, 17, 64, 9)]
    for i in range(2):
        mat, n_ready = seq_window_matrix(windows, window=64)
        assert mat.shape == (8, 64) and n_ready == 5 + i  # the 2-token window joins at tick 1
        ref, want_loss = RS.seq_train_step(ref, jnp.asarray(mat), attn=attn)
        want = RS.seq_score(ref, jnp.asarray(mat), attn=attn)
        loss, got = harvest_tick(port, mat, attn)
        _close(loss, want_loss, 1e-4, f"loss {i}")
        _close(got, want, 1e-4, f"tick {i}")
        windows = [(w + list(rng.integers(0, 32, 9)))[-64:] for w in windows]
