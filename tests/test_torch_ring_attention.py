"""The port's sequence parallelism against the JAX package on its eight
forced CPU devices (tests/conftest.py): `ring_attention`,
`ulysses_attention` and `make_ring_attention` over lanes, the ring
all-reduces, and the sequence-parallel train step.

The port's lanes are ``["cpu"] * n``. Inputs are seeded numpy arrays,
the same on both sides; float32, so a streaming softmax folded in
another order stays within 2e-5 of the materialised one (the
reference's own tolerance). The ring sums keep the reference's hop
order: integer tables are compared with ``np.array_equal``, and float
tables too, since both rings add in the same order. The SP step is held
to the reference's SP step and its one-device `seq_train_step`: the
losses before and after the update within 1e-5, the gradient (AdamW's
first moment after one step) within 1e-5 of its leaf's largest, and the
update of every element within 5e-6, half a percent of lr = 1e-3, but
where the gradient is zero up to rounding (`_torch_update`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from inspektor_gadget_tpu.models import seqmodel as RS
from inspektor_gadget_tpu.parallel import ring as RR
from inspektor_gadget_tpu.parallel import ring_attention as RA
from inspektor_gadget_tpu.parallel.compat import shard_map
from inspektor_gadget_tpu_torch.models import params_from_numpy
from inspektor_gadget_tpu_torch.models import seqmodel as PS
from inspektor_gadget_tpu_torch.models.params import _flatten, params_to_numpy
from inspektor_gadget_tpu_torch.parallel import ring as port_ring
from inspektor_gadget_tpu_torch.parallel import ring_attention as PA

from _torch_update import assert_same_update

torch.set_num_threads(2)

B, T, H, D = 2, 256, 4, 16
ATOL = 2e-5


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))


def _lanes(n):
    return [torch.device("cpu")] * n


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sharded_attention_matches_full_and_the_reference(impl, causal):
    q, k, v = _qkv()
    ref_full = np.asarray(RA.full_attention(*map(jnp.asarray, (q, k, v)), causal=causal))
    want = np.asarray(RA.make_ring_attention(Mesh(np.array(jax.devices()[:4]), ("seq",)),
                                             causal=causal, impl=impl)(
        *map(jnp.asarray, (q, k, v))))
    got = PA.make_ring_attention(_lanes(4), causal=causal, impl=impl)(*_t(q, k, v))
    full = PA.full_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), ref_full, rtol=ATOL, atol=ATOL)


def test_ring_attention_eight_way():
    q, k, v = _qkv(seed=3)
    want = np.asarray(RA.full_attention(*map(jnp.asarray, (q, k, v)), causal=True))
    got = PA.make_ring_attention(_lanes(8), causal=True, impl="ring")(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)


def test_ring_attention_on_lane_shards_and_its_gradient():
    """The lane form takes and returns one shard a lane; its gradient
    through the KV hops equals the materialised attention's."""
    q, k, v = (x.requires_grad_() for x in _t(*_qkv(seed=5)))
    shards = [list(x.chunk(4, dim=1)) for x in (q, k, v)]
    out = PA.ring_attention(*shards, causal=True)
    assert [o.shape for o in out] == [(B, T // 4, H, D)] * 4
    g = torch.from_numpy(np.random.default_rng(6).normal(size=(B, T, H, D)).astype(np.float32))
    got = torch.autograd.grad(torch.cat(out, dim=1), (q, k, v), g)
    want = torch.autograd.grad(PA.full_attention(q, k, v, causal=True), (q, k, v), g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_ulysses_needs_heads_divisible_by_lanes():
    q = torch.zeros(1, 8, 3, 4)
    with pytest.raises(ValueError, match="heads 3 not divisible"):
        PA.ulysses_attention([q[:, :4], q[:, 4:]], [q[:, :4], q[:, 4:]], [q[:, :4], q[:, 4:]])


def test_blockwise_matches_the_reference():
    q, k, v = _qkv(seed=7)
    for causal in (False, True):
        want = np.asarray(RA.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                                 chunk=64))
        got = PA.blockwise_attention(*_t(q, k, v), causal=causal, chunk=64)
        np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)


# -- ring all-reduces ---------------------------------------------------------------

def _ref_ring(fn, x: np.ndarray, n: int) -> np.ndarray:
    mesh = Mesh(np.array(jax.devices()[:n]), ("node",))
    f = jax.jit(shard_map(lambda v: fn(v[0], "node")[None], mesh=mesh,
                          in_specs=(P("node"),), out_specs=P("node"), check_vma=False))
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("name", ["ring_psum", "ring_psum_chunked"])
def test_ring_psums_equal_the_reference(name, n):
    """Integer tables (with a padded tail at 37 columns) exactly equal
    the plain sum and the reference's ring; float tables equal the
    reference's ring bit for bit (the same hop order)."""
    rng = np.random.default_rng(n)
    ints = rng.integers(-2**20, 2**20, (n, 37)).astype(np.int32)
    floats = rng.normal(size=(n, 5, 7)).astype(np.float32) * 1e3
    for x in (ints, floats):
        got = getattr(port_ring, name)([torch.from_numpy(r) for r in x])
        got = np.stack([g.numpy() for g in got])
        if x.dtype == np.int32:
            assert np.array_equal(got, np.broadcast_to(x.sum(0), x.shape))
        if n > 1:
            assert np.array_equal(got, _ref_ring(getattr(RR, name), x, n)), x.dtype


def test_ring_psum_leaves_its_inputs():
    xs = [torch.arange(10) * (i + 1) for i in range(4)]
    before = [x.clone() for x in xs]
    port_ring.ring_psum_chunked(xs)
    port_ring.ring_psum(xs)
    assert all(torch.equal(a, b) for a, b in zip(xs, before))


# -- the sequence-parallel train step -------------------------------------------------

def _cfgs():
    small = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
    return (RS.SeqConfig(**small, dtype=jnp.float32),
            PS.SeqConfig(**small, dtype=torch.float32))


def _pair(seed=0):
    rcfg, pcfg = _cfgs()
    ref = RS.seq_init(rcfg, seed=seed)
    port = PS.seq_init(pcfg, seed=seed, device="cpu")
    params_from_numpy(port, jax.tree.map(np.array, ref.params))
    return ref, port


def _close(got_tree, want_tree, tol):
    want, got = _flatten(jax.tree.map(np.array, want_tree)), _flatten(got_tree)
    assert set(want) == set(got)
    for name in want:
        g, w = got[name], want[name]
        if name.endswith("qkv.b"):  # the key bias: zero gradient up to rounding
            d = g.shape[0] // 3
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


def _np_tree(tree) -> dict[str, np.ndarray]:
    return _flatten(jax.tree.map(np.array, tree))


def _moments(scorer) -> dict[str, np.ndarray]:
    return {name: scorer.opt.state[p]["exp_avg"].numpy().copy()
            for name, p in scorer.model.named_parameters()}


def _grads(scorer) -> dict[str, np.ndarray]:
    """The gradient of the scorer's last step, by name."""
    return {name: p.grad.numpy().copy() for name, p in scorer.model.named_parameters()}


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_sp_train_step_matches_one_device_and_the_reference(attn):
    """One SP step over 4 lanes from the reference's weights, against the
    reference's SP step over 4 devices and its one-device step: the loss
    before the step and the next step's (after the update) within 1e-5;
    the gradient, read as AdamW's first moment (0.1 g after one step),
    within 1e-5 of the leaf's largest; the update within 5e-6. The
    reference's SP moment is 4 g's: its ``psum`` transposes to a psum
    under shard_map, so its gradient comes out n times the loss's, which
    AdamW's update does not see but for eps."""
    ref, port = _pair()
    toks = np.random.default_rng(2).integers(0, 64, size=(2, 128)).astype(np.int32)
    w0 = _np_tree(ref.params)
    grad = _np_tree(jax.grad(RS.seq_loss)(ref.params, jnp.asarray(toks), ref.config))
    ref_loss = float(RS.seq_loss(ref.params, jnp.asarray(toks), ref.config))
    one, _ = RS.seq_train_step(RS.seq_init(ref.config, seed=0), jnp.asarray(toks))
    _, one_loss = RS.seq_train_step(one, jnp.asarray(toks))
    r_sp = RS.make_sp_train_step(Mesh(np.array(jax.devices()[:4]), ("seq",)), ref.config,
                                 attn=attn)
    w0_tree = jax.tree.map(jnp.array, ref.params)  # the step donates its inputs
    p_sp, o_sp, r_loss = r_sp(ref.params, ref.opt_state, jnp.asarray(toks))
    o_sp_mu = jax.tree.map(np.array, o_sp[0].mu)
    sp_mu = _flatten(o_sp_mu)
    _, _, r_loss2 = r_sp(p_sp, o_sp, jnp.asarray(toks))

    step = PS.make_sp_train_step(_lanes(4), port.config, port, attn=attn)
    loss = step(toks)
    got, mu = _flatten(params_to_numpy(port)), _moments(port)
    loss2 = step(toks)
    for a, b in ((loss, ref_loss), (loss, r_loss), (loss2, r_loss2), (loss2, one_loss)):
        assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-6)
    for name, g in grad.items():
        scale = np.abs(0.1 * g).max()
        np.testing.assert_allclose(mu[name], 0.1 * g, rtol=0, atol=1e-5 * scale, err_msg=name)
        np.testing.assert_allclose(4 * mu[name], sp_mu[name], rtol=0, atol=4e-5 * scale,
                                   err_msg=name)
    # the reference's AdamW on its SP step's gradient over n: its SP update
    # as the loss's own gradient would give it
    opt = RS._optimizer(ref.config)
    sp_g = jax.tree.map(lambda m: jnp.asarray(m) / 0.1 / 4, o_sp_mu)
    upd, _ = opt.update(sp_g, opt.init(w0_tree), w0_tree)
    sp_w = _np_tree(optax.apply_updates(w0_tree, upd))
    assert_same_update(w0, got, w0, sp_w, grad, port.config.lr, 5e-6,
                       what="vs the reference's SP step")
    assert port.steps == 2


def test_sp_step_equals_the_one_device_step_of_the_reference():
    """The port's SP step against the reference's one-device
    `seq_train_step` from the same weights: the update within 5e-6."""
    ref, port = _pair(seed=4)
    toks = np.random.default_rng(5).integers(0, 64, size=(2, 128)).astype(np.int32)
    w0 = _np_tree(ref.params)
    grad = _np_tree(jax.grad(RS.seq_loss)(ref.params, jnp.asarray(toks), ref.config))
    one, want = RS.seq_train_step(ref, jnp.asarray(toks))
    got_loss = PS.make_sp_train_step(_lanes(4), port.config, port, attn="ring")(toks)
    assert float(got_loss) == pytest.approx(float(want), rel=1e-5)
    assert_same_update(w0, _flatten(params_to_numpy(port)), w0, _np_tree(one.params), grad,
                       port.config.lr, 5e-6, what="vs the one-device step")


def test_lane_steps_and_one_device_steps_interleave():
    """The scorer is the one copy of the weights and AdamW state: an SP
    step, a one-device step and another SP step on one scorer equal three
    one-device steps on its twin, each update within 5e-6 (f32)."""
    _, port = _pair(seed=6)
    _, twin = _pair(seed=6)
    sp = PS.make_sp_train_step(_lanes(2), port.config, port, attn="ring")
    rng = np.random.default_rng(7)
    for i, lanes in enumerate((True, False, True)):
        toks = rng.integers(0, 64, size=(2, 64)).astype(np.int32)
        before, twin_before = _flatten(params_to_numpy(port)), _flatten(params_to_numpy(twin))
        loss = sp(toks) if lanes else PS.seq_train_step(port, toks)[1]
        _, want = PS.seq_train_step(twin, toks)
        assert float(loss) == pytest.approx(float(want), rel=1e-5), f"step {i}"
        assert_same_update(before, _flatten(params_to_numpy(port)), twin_before,
                           _flatten(params_to_numpy(twin)), _grads(twin), port.config.lr, 5e-6,
                           what=f"step {i}")
    assert port.steps == twin.steps == 3


def test_sp_step_continues_from_the_scorers_adamw_state():
    """Two one-device steps, then an SP step from the same scorer: it
    continues the AdamW state (the third step of a one-device run)."""
    _, port = _pair(seed=1)
    _, twin = _pair(seed=1)
    rng = np.random.default_rng(3)
    for _ in range(2):
        toks = rng.integers(0, 64, size=(2, 64)).astype(np.int32)
        PS.seq_train_step(port, toks)
        PS.seq_train_step(twin, toks)
    toks = rng.integers(0, 64, size=(2, 64)).astype(np.int32)
    loss = PS.make_sp_train_step(_lanes(2), port.config, port, attn="ring")(toks)
    _, want = PS.seq_train_step(twin, toks)
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
    _close(params_to_numpy(port), params_to_numpy(twin), 1e-4)
    assert port.steps == twin.steps == 3


def test_sp_step_rejects_a_local_backend_and_uneven_shards():
    _, port = _pair()
    with pytest.raises(ValueError, match="sequence-parallel"):
        PS.make_sp_train_step(_lanes(2), port.config, port, attn="full")
    with pytest.raises(ValueError, match="not divisible"):
        PS.make_sp_train_step(_lanes(3), port.config, port)(np.zeros((1, 64), np.int32))


def test_seq_model_with_ring_backend_on_one_lane():
    """`ring` on a single lane is the streaming softmax over the whole
    window: the scores equal `full`'s."""
    _, port = _pair()
    toks = np.random.default_rng(0).integers(0, 64, (2, 65)).astype(np.int32)
    np.testing.assert_allclose(PS.seq_score(port, toks, "ring").numpy(),
                               PS.seq_score(port, toks, "full").numpy(), rtol=2e-5, atol=2e-5)
