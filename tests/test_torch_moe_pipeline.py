"""The port's expert parallelism (`parallel/moe.py`), the MoE seq model's
steps and the pipeline (`parallel/pipeline.py`) against the JAX package
on its eight forced CPU devices (tests/conftest.py).

The port's lanes are ``["cpu"] * n``. Both sides take the same weights
(the reference's, carried into the port) and the same seeded numpy
inputs. Routing is compared first and exactly: the dense dispatch
tensor (which expert, which slot, kept or not) with ``np.array_equal``,
the balance term and the dropped fraction to float32 rounding. Outputs
pass through bf16 expert matmuls in two frameworks and are held to 2e-2
(the reference's own EP tolerance); the pipeline's eight bf16 blocks to
2e-2 of the output's largest magnitude; parameters after a few steps to 5e-3
(an Adam step moves a weight by about lr = 1e-3 whatever its gradient).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from inspektor_gadget_tpu.models import seqmodel as RS
from inspektor_gadget_tpu.parallel import moe as RM
from inspektor_gadget_tpu.parallel import pipeline as RP
from inspektor_gadget_tpu_torch.models import adam_state_from_optax, params_from_numpy
from inspektor_gadget_tpu_torch.models import seqmodel as PS
from inspektor_gadget_tpu_torch.models.params import _flatten, params_to_numpy
from inspektor_gadget_tpu_torch.parallel import moe as PM
from inspektor_gadget_tpu_torch.parallel import pipeline as PP

torch.set_num_threads(2)

OUT_TOL = 2e-2
PARAM_TOL = 5e-3


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _mesh(n: int, axis: str) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), (axis,))


def _lanes(n: int) -> list[torch.device]:
    return [torch.device("cpu")] * n


def _moe_pair(seed: int, e: int, d: int, f: int):
    ref = RM.moe_init(jax.random.PRNGKey(seed), n_experts=e, d_model=d, d_ff=f)
    port = PM.moe_init(0, e, d, f)
    with torch.no_grad():
        for k, v in _np(ref).items():
            getattr(port, k).copy_(torch.from_numpy(v))
    return ref, port.requires_grad_(False)


def _x(seed: int, t: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)


@pytest.mark.parametrize("seed,t,cap", [(0, 128, 32), (1, 256, 8), (2, 64, 1), (3, 33, 9)])
def test_routing_decisions_equal_the_reference(seed, t, cap):
    """Expert, slot and kept of every token (the dense dispatch tensor),
    the gate's combine weights, the balance term and the dropped
    fraction, at ample and at starved capacities."""
    ref, port = _moe_pair(seed, 8, 32, 64)
    x = _x(seed + 10, t, 32)
    r_disp, r_comb, (r_bal, r_drop) = RM._route(jnp.asarray(x), ref["gate"], cap)
    got = PM._route(torch.from_numpy(x), port.gate, cap)
    assert np.array_equal(got.dispatch().numpy(), np.asarray(r_disp))
    np.testing.assert_allclose(got.combine().detach().numpy(), np.asarray(r_comb), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(got.balance.detach()), float(r_bal), rtol=1e-6)
    assert float(got.dropped) == pytest.approx(float(r_drop), abs=1e-7)
    assert int(got.keep.sum()) == int(np.asarray(r_disp).sum())


def test_moe_reference_routes_and_balances():
    """The reference's own case, on the port, and the port's output
    against the reference's at both capacities."""
    ref, port = _moe_pair(0, 8, 32, 64)
    x = _x(1, 128, 32)
    y, (bal, drop) = PM.moe_apply(port, torch.from_numpy(x), capacity_factor=2.0)
    assert y.shape == x.shape
    assert float(bal) >= 1.0 - 1e-5  # the balance term is least, 1, when balanced
    assert 0.0 <= float(drop) <= 1.0
    y2, (_, drop2) = PM.moe_apply(port, torch.from_numpy(x), capacity_factor=8.0)
    assert float(drop2) == 0.0 and float(y2.abs().sum()) > 0
    for cf, got in ((2.0, (y, bal, drop)), (8.0, (y2, None, drop2))):
        want, (wbal, wdrop) = RM.moe_apply(ref, jnp.asarray(x), capacity_factor=cf)
        np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want),
                                   rtol=OUT_TOL, atol=OUT_TOL)
        assert float(got[2]) == pytest.approx(float(wdrop), abs=1e-7)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ep_moe_matches_the_per_shard_reference(n):
    """EP over n lanes: each shard's routing equals the reference's
    per-shard `moe_apply` (capacity is per shard in EP), and the output
    equals both that and the reference's own EP over n devices."""
    ref, port = _moe_pair(0, 8, 32, 64)
    x = _x(1, 256, 32)
    ep = PM.make_ep_moe(_lanes(n), n_experts=8, capacity_factor=2.0)
    y, (bal, drop) = ep(port, torch.from_numpy(x))
    shard = 256 // n
    for i in range(n):
        xs = x[i * shard:(i + 1) * shard]
        cap = max(1, int(shard / 8 * 2.0))
        r_disp, _, _ = RM._route(jnp.asarray(xs), ref["gate"], cap)
        got = PM._route(torch.from_numpy(xs), port.gate, cap)
        assert np.array_equal(got.dispatch().numpy(), np.asarray(r_disp)), f"shard {i}"
    per_shard = [RM.moe_apply(ref, jnp.asarray(x[i * shard:(i + 1) * shard]), 2.0)
                 for i in range(n)]
    want = np.concatenate([np.asarray(s[0]) for s in per_shard])
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=OUT_TOL, atol=OUT_TOL)
    r_y, (r_bal, r_drop) = RM.make_ep_moe(_mesh(n, "expert"), 8, 2.0)(ref, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(r_y), rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(float(bal.detach()), float(r_bal), rtol=1e-5)
    assert float(drop) == pytest.approx(float(r_drop), abs=1e-6)
    # the shards are the experts of their lanes, and a second call on them agrees
    shards = PM.moe_shard(port, _lanes(n))
    assert [s.w1.shape[0] for s in shards] == [8 // n] * n
    assert torch.equal(ep(shards, torch.from_numpy(x))[0], y)


def test_ep_moe_capacity_drops_are_reported():
    ref, port = _moe_pair(2, 8, 16, 32)
    x = np.tile(_x(3, 1, 16), (256, 1))  # identical tokens: all to one expert
    _, (_, drop) = PM.make_ep_moe(_lanes(8), n_experts=8, capacity_factor=1.0)(
        port, torch.from_numpy(x))
    # capacity 32 / 8 * 1 = 4 a shard; 32 tokens a shard to one expert
    assert float(drop) > 0.8
    _, (_, r_drop) = RM.make_ep_moe(_mesh(8, "expert"), 8, 1.0)(ref, jnp.asarray(x))
    assert float(drop) == pytest.approx(float(r_drop), abs=1e-7)


def test_ep_moe_rejects_uneven_splits():
    with pytest.raises(ValueError, match="not divisible"):
        PM.make_ep_moe(_lanes(3), n_experts=8)
    _, port = _moe_pair(0, 8, 16, 32)
    with pytest.raises(ValueError, match="not divisible"):
        PM.make_ep_moe(_lanes(4), n_experts=8)(port, torch.zeros(6, 16))


def test_moe_pspecs_name_the_reference_layout():
    want = RM.moe_pspecs("expert")
    got = PM.moe_pspecs("expert")
    assert set(got) == set(want)
    for k, spec in want.items():
        assert got[k] == tuple(spec)


# -- the MoE seq model ------------------------------------------------------------

SMALL = dict(vocab=32, d_model=32, n_heads=2, d_ff=64)


def _seq_pair(n_layers: int, n_experts: int, seed: int, dtype=("f32")):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rcfg = RS.SeqConfig(**SMALL, n_layers=n_layers, n_experts=n_experts, dtype=jd)
    pcfg = PS.SeqConfig(**SMALL, n_layers=n_layers, n_experts=n_experts, dtype=td)
    ref = RS.seq_init(rcfg, seed=seed)
    port = PS.seq_init(pcfg, seed=seed, device="cpu")
    params_from_numpy(port, _np(ref.params))
    return ref, port


def _bigrams(seed: int, rows: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.tile(rng.integers(0, 32, (rows, 2)), (1, 16)).astype(np.int32)


def _assert_params_close(got_tree, want_tree, tol, ctx=""):
    want, got = _flatten(_np(want_tree)), _flatten(got_tree)
    assert set(want) == set(got)
    for name in want:
        g, w = got[name], want[name]
        if name.endswith("qkv.b"):  # the key bias: zero gradient up to rounding (Adam's bound)
            d = g.shape[0] // 3
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=f"{ctx} {name}")


def test_moe_seq_model_has_the_reference_tree_and_trains():
    """`n_experts` swaps the dense FF for routed experts under the
    reference's names; the LM learns (the reference's case) and scores."""
    ref, port = _seq_pair(2, 4, 0)
    assert "moe" in ref.params["layers"][0] and "ff1" not in ref.params["layers"][0]
    tree = params_to_numpy(port)
    assert set(tree["layers"][0]["moe"]) == {"gate", "w1", "b1", "w2", "b2"}
    assert "ff1" not in tree["layers"][0]
    toks = _bigrams(0, 4)
    losses = []
    for _ in range(30):
        port, loss = PS.seq_train_step(port, toks)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7
    scores = PS.seq_score(port, toks)
    assert scores.shape == (4,) and np.isfinite(scores.numpy()).all()


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_moe_seq_loss_score_and_steps_match_jax(attn):
    """Loss (NLL plus the balance term), scores and three AdamW steps of
    the MoE model against the reference's, from carried weights."""
    ref, port = _seq_pair(2, 4, 1)
    toks = _bigrams(1, 4)
    want = float(RS.seq_loss(ref.params, jnp.asarray(toks), ref.config, attn=attn))
    got = float(PS.seq_loss(port.model, torch.from_numpy(toks).long(), port.config, attn).detach())
    assert got == pytest.approx(want, rel=1e-4, abs=1e-4)
    np.testing.assert_allclose(PS.seq_score(port, toks, attn).numpy(),
                               np.asarray(RS.seq_score(ref, jnp.asarray(toks), attn=attn)),
                               rtol=1e-3, atol=1e-3)
    for i in range(3):
        t = _bigrams(10 + i, 4)
        ref, want = RS.seq_train_step(ref, jnp.asarray(t), attn=attn)
        port, got = PS.seq_train_step(port, t, attn)
        assert float(got) == pytest.approx(float(want), rel=1e-3, abs=1e-3), f"step {i}"
    _assert_params_close(params_to_numpy(port), ref.params, PARAM_TOL, "3 steps")


def test_moe_adamw_state_carries_from_jax():
    """Two reference steps, then the MoE weights, AdamW moments and count
    carried into a fresh port scorer: the third step matches."""
    ref, _ = _seq_pair(1, 4, 2)
    for i in range(2):
        ref, _ = RS.seq_train_step(ref, jnp.asarray(_bigrams(20 + i, 4)))
    port = PS.seq_init(PS.SeqConfig(**SMALL, n_layers=1, n_experts=4, dtype=torch.float32),
                       seed=9, device="cpu")
    params_from_numpy(port, _np(ref.params))
    adam = ref.opt_state[0]
    adam_state_from_optax(port, _np(adam.mu), _np(adam.nu), int(adam.count))
    t = _bigrams(22, 4)
    ref, want = RS.seq_train_step(ref, jnp.asarray(t))
    port, got = PS.seq_train_step(port, t)
    assert float(got) == pytest.approx(float(want), rel=1e-4, abs=1e-4)
    _assert_params_close(params_to_numpy(port), ref.params, 1e-4, "carried")


def test_seq_param_pspecs_shard_only_the_expert_stacks():
    ref, port = _seq_pair(2, 4, 0)
    want = _flatten(jax.tree.map(lambda s: np.array(tuple(s), dtype=object),
                                 RS.seq_param_pspecs(ref.params, "expert"),
                                 is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
    got = PS.seq_param_pspecs(port, "expert")
    assert set(got) == set(want)
    for name, spec in got.items():
        assert spec == tuple(want[name]), name
    assert got["layers.0.moe.w1"] == ("expert",) and got["layers.0.moe.gate"] == ()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ep_train_step_matches_jax(n):
    """Three expert-parallel steps over n lanes against the reference's
    over n devices, from the same weights and tokens: losses, and every
    weight (experts gathered in lane order) after the steps."""
    ref, port = _seq_pair(1, 8, 1)
    rstep = RS.make_ep_train_step(_mesh(n, "expert"), ref.config, ref)
    pstep = PS.make_ep_train_step(_lanes(n), port.config, port)
    p, o = ref.params, ref.opt_state
    for i in range(3):
        toks = _bigrams(30 + i, 8)
        p, o, want = rstep(p, o, jnp.asarray(toks))
        got = pstep(toks)
        assert float(got) == pytest.approx(float(want), rel=1e-3, abs=1e-3), f"step {i}"
    _assert_params_close(params_to_numpy(port), p, PARAM_TOL, f"EP over {n}")
    assert port.steps == 3
    assert [m.layers[0].moe.w1.shape[0] for m in pstep.models] == [8 // n] * n


def test_ep_train_step_learns():
    """The reference's case: experts over eight lanes, the loss falls and
    the gathered expert stack keeps its global shape."""
    _, port = _seq_pair(1, 8, 1)
    step = PS.make_ep_train_step(_lanes(8), port.config, port)
    toks = _bigrams(1, 8)
    losses = [float(step(toks)) for _ in range(25)]
    assert losses[-1] < losses[0] * 0.8
    assert params_to_numpy(port)["layers"][0]["moe"]["w1"].shape == (8, 32, 64)


def test_ep_train_step_equals_one_lane_with_per_shard_capacity():
    """EP over 4 lanes is one model whose loss sums the NLL of each row
    shard, routed with that shard's own capacity: the same step without
    moving an expert."""
    _, port = _seq_pair(1, 8, 3)
    one = PS.seq_init(port.config, seed=0, device="cpu")
    params_from_numpy(one, params_to_numpy(port))
    toks = torch.from_numpy(_bigrams(5, 8)).long()
    step = PS.make_ep_train_step(_lanes(4), port.config, port)
    got = step(toks)
    one.opt.zero_grad()
    s_sum, c_sum, bal = 0.0, 0.0, []
    for part in toks.chunk(4):
        s, c, b = PS._next_token_terms(one.model, part, one.config, "full")
        s_sum, c_sum = s_sum + s.sum(), c_sum + c.sum()
        bal.append(b)
    loss = s_sum / c_sum + one.config.balance_coef * torch.stack(bal).mean()
    loss.backward()
    one.opt.step()
    assert float(got) == pytest.approx(float(loss.detach()), rel=1e-6)
    lr = port.config.lr
    for (name, a), b in zip(_flatten(params_to_numpy(port)).items(),
                            _flatten(params_to_numpy(one)).values()):
        # the gradients are summed in another order, so an element whose
        # gradient is zero up to rounding moves by noise, within Adam's
        # step bound lr; every other element agrees to 1e-5
        diff = np.abs(a - b)
        assert diff.max() <= 2 * lr, name
        assert (diff > 1e-5).mean() <= 5e-3, name


# -- the pipeline -----------------------------------------------------------------

def _pp_pair(seed: int, s: int, d: int, f: int):
    ref = RP.pp_block_init(jax.random.PRNGKey(seed), n_stages=s, d_model=d, d_ff=f)
    port = {k: torch.from_numpy(v) for k, v in _np(ref).items()}
    return ref, port


def test_pp_forward_matches_sequential_and_the_reference():
    ref, port = _pp_pair(0, 8, 32, 64)
    x = np.random.default_rng(1).normal(size=(4, 8, 32)).astype(np.float32)  # [M, mb, d]
    got = PP.make_pp_forward(_lanes(8))(port, torch.from_numpy(x))
    seq = torch.stack([PP.pp_reference(port, torch.from_numpy(x[i])) for i in range(4)])
    assert torch.equal(got, seq)  # the same blocks in the same order
    # eight residual blocks of bf16 matmuls and gelus in two frameworks:
    # within 2e-2 of the output's largest magnitude
    want = np.asarray(RP.make_pp_forward(_mesh(8, "stage"))(ref, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_TOL * np.abs(want).max())
    want_seq = np.stack([np.asarray(RP.pp_reference(ref, jnp.asarray(x[i]))) for i in range(4)])
    assert np.array_equal(want, want_seq)
    np.testing.assert_allclose(seq.numpy(), want_seq, rtol=0,
                               atol=OUT_TOL * np.abs(want_seq).max())


@pytest.mark.parametrize("stages,m", [(4, 4), (4, 7), (2, 1)])
def test_pp_schedule_over_fewer_stages(stages, m):
    """The tick schedule at other stage and microbatch counts (m < s,
    m > s) still equals the sequential forward."""
    _, port = _pp_pair(stages, stages, 16, 32)
    x = torch.from_numpy(np.random.default_rng(m).normal(size=(m, 4, 16)).astype(np.float32))
    got = PP.make_pp_forward(_lanes(stages))(port, x)
    assert torch.equal(got, torch.stack([PP.pp_reference(port, x[i]) for i in range(m)]))


def test_pp_train_step_learns_and_matches_jax():
    ref, port = _pp_pair(0, 8, 16, 32)
    rng = np.random.default_rng(2)
    head = (rng.normal(size=(16, 4)) * 0.1).astype(np.float32)
    x = rng.normal(size=(4, 8, 16)).astype(np.float32)
    y = rng.normal(size=(4, 8, 4)).astype(np.float32)
    rstep = RP.make_pp_train_step(_mesh(8, "stage"), lr=1e-2)
    pstep = PP.make_pp_train_step(_lanes(8), lr=1e-2)
    rp, rh = ref, jnp.asarray(head)
    pp, ph = port, torch.from_numpy(head)
    losses = []
    for i in range(20):
        rp, rh, rloss = rstep(rp, rh, jnp.asarray(x), jnp.asarray(y))
        pp, ph, loss = pstep(pp, ph, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(loss))
        assert float(loss) == pytest.approx(float(rloss), rel=2e-2), f"step {i}"
    assert losses[-1] < losses[0] * 0.7
    assert pp["w1"].shape == port["w1"].shape
    for k in pp:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]), rtol=OUT_TOL, atol=OUT_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(ph.numpy(), np.asarray(rh), rtol=OUT_TOL, atol=OUT_TOL)


def test_pp_pspecs_split_every_leaf_by_stage():
    want = RP.pp_pspecs("stage")
    assert {k: tuple(v) for k, v in want.items()} == PP.pp_pspecs("stage")
