"""The port's tensor parallelism against the JAX package on its eight
forced CPU devices (tests/conftest.py): the Megatron-split autoencoder
(`ae_apply_tp`, `ae_loss_tp`, `ae_score_tp`, `ae_train_step_tp`), its
placement (`ae_param_pspecs`, `scorer_pspecs`) and the cluster step on a
(node, model) mesh.

The port's lanes are ``["cpu"] * n``. Both sides take the reference's
weights and the same seeded numpy counts. A float32 config holds the
split forward within 1e-5 of the replicated one (the reference's own
tolerance); the bf16 default, whose partial products round to bf16
before the model axis' sum, within 2e-2 of the output's largest
magnitude. Bundles of the cluster step are compared with
``np.array_equal``. Its autoencoder step is held in float32, step by
step, to the reference's replicated (data-parallel) step and to the
port's: losses within 1e-5 and every update within 1e-6, a thousandth
of lr, but where the gradient is zero up to rounding
(`_torch_update`). The reference's own tensor-parallel step is not that
step: its replicated enc2 bias takes each model lane's partial gradient,
so its replicas part after one step, and the leaves before a model-axis
``psum`` take n_model times their gradient (the psum transposes to a
psum under shard_map), which moves Adam's update where the gradient is
near eps. Against it the port's update keeps the sign of every element
of the other leaves whose gradient is not zero up to rounding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from inspektor_gadget_tpu.models import autoencoder as RA
from inspektor_gadget_tpu.parallel import cluster as RC
from inspektor_gadget_tpu.parallel import make_cluster_step as ref_make_cluster_step
from inspektor_gadget_tpu.parallel import make_mesh as ref_make_mesh
from inspektor_gadget_tpu.parallel.compat import shard_map
from inspektor_gadget_tpu_torch.models import autoencoder as PA
from inspektor_gadget_tpu_torch.models import params_from_numpy
from inspektor_gadget_tpu_torch.models.params import params_to_numpy
from inspektor_gadget_tpu_torch.ops import bundle_to_numpy
from inspektor_gadget_tpu_torch.parallel import cluster as C
from inspektor_gadget_tpu_torch.parallel import mesh as M

from _torch_update import assert_same_update

torch.set_num_threads(2)

CPU = torch.device("cpu")
DIM = 128


def _pair(dtype: str, seed: int = 3, hidden: int = 128, latent: int = 32):
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = RA.ae_init(RA.AEConfig(input_dim=DIM, hidden_dim=hidden, latent_dim=latent,
                                 compute_dtype=jd), seed=seed)
    port = PA.ae_init(PA.AEConfig(input_dim=DIM, hidden_dim=hidden, latent_dim=latent,
                                  compute_dtype=td), device="cpu")
    params_from_numpy(port, jax.tree.map(np.array, ref.params))
    return ref, port


def _x(seed: int = 0, rows: int = 8) -> np.ndarray:
    counts = np.random.default_rng(seed).poisson(4.0, (rows, DIM)).astype(np.float32)
    return np.array(RA.normalize_counts(jnp.asarray(counts)))


def _flat(tree) -> dict[str, np.ndarray]:
    """A parameter tree ({layer: {w, b}}) by dotted name, as numpy."""
    return {f"{layer}.{leaf}": np.array(v) for layer, d in tree.items() for leaf, v in d.items()}


def _mean_grad(ref_params, ae_batch: np.ndarray, cfg) -> dict[str, np.ndarray]:
    """The reference's gradient of the node lanes' mean loss, by name."""
    def loss(p):
        return sum(RA.ae_loss(p, RA.normalize_counts(jnp.asarray(b)), cfg)
                   for b in ae_batch) / len(ae_batch)
    return _flat(jax.grad(loss)(ref_params))


def _ref_tp_apply(ref, x, n_model: int):
    mesh = ref_make_mesh(n_nodes=8 // n_model, n_model=n_model)
    specs = RC.scorer_pspecs(ref)
    fn = jax.jit(shard_map(lambda p, xx: RA.ae_apply_tp(p, xx, ref.config, model_axis="model"),
                           mesh=mesh, in_specs=(specs.params, P()), out_specs=P(),
                           check_vma=False))
    params = jax.device_put(ref.params, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs.params, is_leaf=lambda v: isinstance(v, P)))
    return np.asarray(fn(params, jnp.asarray(x)))


@pytest.mark.parametrize("n_model", [2, 4, 8])
def test_tp_forward_matches_replicated_and_the_reference_f32(n_model):
    ref, port = _pair("f32")
    x = _x()
    tp = PA.ae_shard_tp(port, [CPU] * n_model)
    got = PA.ae_apply_tp(tp.shards, torch.from_numpy(x), port.config).detach().numpy()
    whole = PA.ae_apply(port.model, torch.from_numpy(x), port.config).detach().numpy()
    np.testing.assert_allclose(got, whole, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(RA.ae_apply(ref.params, jnp.asarray(x),
                                                           ref.config)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _ref_tp_apply(ref, x, n_model), rtol=1e-5, atol=1e-5)


def test_tp_forward_loss_and_score_bf16():
    ref, port = _pair("bf16")
    x = _x(1)
    tp = PA.ae_shard_tp(port, [CPU] * 2)
    got = PA.ae_apply_tp(tp.shards, torch.from_numpy(x), port.config).detach().numpy()
    want = _ref_tp_apply(ref, x, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
    loss = float(PA.ae_loss_tp(tp.shards, torch.from_numpy(x), port.config).detach())
    assert loss == pytest.approx(float(RA.ae_loss(ref.params, jnp.asarray(x), ref.config)),
                                 rel=2e-2)
    score = PA.ae_score_tp(tp, torch.from_numpy(x)).numpy()
    whole = PA.ae_score(port, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(score, whole, rtol=2e-2, atol=0)


def test_shard_and_gather_round_trip_with_adam_state():
    """Splitting a scorer (weights and Adam moments) over model lanes and
    gathering it back gives the same tree; the split follows
    `ae_param_pspecs`."""
    _, port = _pair("f32")
    PA.ae_train_step(port, torch.from_numpy(_x(2)))
    tp = PA.ae_shard_tp(port, [CPU] * 4)
    back = PA.ae_gather_tp(tp)
    want = params_to_numpy(port)
    for layer in want:
        for leaf in ("w", "b"):
            assert np.array_equal(back[layer][leaf].numpy(), want[layer][leaf])
    assert tp.shards[1].enc1.w.shape == (DIM, 32) and tp.shards[1].enc2.w.shape == (32, 32)
    assert tp.shards[1].enc2.b.shape == (32,) and tp.steps == 1
    p = port.model.dec1.w
    st = tp.opts[2].state[tp.shards[2].dec1.w]
    assert torch.equal(st["exp_avg"], port.opt.state[p]["exp_avg"][:, 64:96])
    with pytest.raises(ValueError, match="not divisible"):
        PA.ae_shard_tp(port, [CPU] * 3)


def test_tp_train_steps_match_the_replicated_steps_f32():
    """Three data x tensor steps (two data lanes, two model lanes) equal
    three replicated steps on the mean loss (Adam is elementwise)."""
    _, port = _pair("f32")
    _, twin = _pair("f32")
    tp = PA.ae_shard_tp(port, [CPU] * 2)
    for i in range(3):
        xs = [torch.from_numpy(_x(10 + i)), torch.from_numpy(_x(20 + i))]
        _, loss = PA.ae_train_step_tp(tp, xs, rows=[[CPU, CPU], [CPU, CPU]])
        twin.opt.zero_grad()
        want = sum(PA.ae_loss(twin.model, x, twin.config) for x in xs) / 2
        want.backward()
        twin.opt.step()
        assert float(loss) == pytest.approx(float(want.detach()), rel=1e-5)
    got = PA.ae_gather_tp(tp)
    for name, p in twin.model.named_parameters():
        layer, leaf = name.split(".")
        np.testing.assert_allclose(got[layer][leaf].numpy(), p.detach().numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert tp.steps == 3


def test_param_pspecs_equal_the_references():
    want = RA.ae_param_pspecs("model")
    got = PA.ae_param_pspecs("model")
    for layer in want:
        for leaf in ("w", "b"):
            assert got[layer][leaf] == tuple(want[layer][leaf]), (layer, leaf)
    ref, port = _pair("f32")
    rspecs = RC.scorer_pspecs(ref)
    specs = C.scorer_pspecs(port)
    for layer in want:
        for leaf in ("w", "b"):
            assert specs["params"][f"{layer}.{leaf}"] == tuple(rspecs.params[layer][leaf])
            assert specs["mu"][f"{layer}.{leaf}"] == tuple(rspecs.opt_state[0].mu[layer][leaf])


@pytest.mark.parametrize("nodes,model", [(4, 2), (2, 4)])
def test_cluster_tp_step_matches_the_reference_and_the_dp_step(nodes, model):
    """Two steps of cluster_sketch_step(use_tp=True) on a (node, model)
    mesh, float32: bundles equal the reference's TP step and the port's
    DP step bit for bit; each step's loss and update equal the
    reference's replicated step and the port's DP step (1e-5, 1e-6);
    against the reference's TP step, the first loss within 1e-5 and the
    update's signs (see the module's docstring)."""
    kw = dict(depth=4, log2_width=10, hll_p=8, entropy_log2_width=8, k=16)
    ref, port = _pair("f32", hidden=128, latent=32)
    _, dp_port = _pair("f32", hidden=128, latent=32)
    rdp, _ = _pair("f32", hidden=128, latent=32)
    rmesh = ref_make_mesh(n_nodes=nodes, n_model=model)
    rstate = RC.cluster_init(rmesh, ref, **kw)
    rstep, rmerge = ref_make_cluster_step(rmesh, rstate)
    rdp_mesh = ref_make_mesh(n_nodes=nodes)
    rdp_state = RC.cluster_init(rdp_mesh, rdp, **kw)
    rdp_step, _ = ref_make_cluster_step(rdp_mesh, rdp_state)
    mesh = M.make_mesh(n_nodes=nodes, n_model=model, devices=["cpu"] * 8)
    state = C.cluster_init(mesh, port, **kw)
    step, merge = C.make_cluster_step(mesh, state)
    dp_mesh = M.make_mesh(n_nodes=nodes, devices=["cpu"] * 8)
    dp_state = C.cluster_init(dp_mesh, dp_port, **kw)
    dp_step, _ = C.make_cluster_step(dp_mesh, dp_state)
    lr = port.config.learning_rate
    rng = np.random.default_rng(nodes)
    for i in range(2):
        keys = rng.zipf(1.3, (nodes, 256)).clip(1, 5000).astype(np.uint32)
        mask = rng.random((nodes, 256)) < 0.9
        ae_batch = rng.poisson(3.0, (nodes, 8, DIM)).astype(np.float32)
        grad = _mean_grad(rdp_state.scorer.params, ae_batch, rdp.config)
        before = {"tp": _flat(PA.ae_gather_tp(state.scorer)),
                  "dp": _flat(params_to_numpy(dp_state.scorer)),
                  "ref_dp": _flat(rdp_state.scorer.params),
                  "ref_tp": _flat(rstate.scorer.params)}
        ref_args = (*(jnp.asarray(keys),) * 3, jnp.asarray(mask), jnp.asarray(ae_batch))
        rstate, rloss = rstep(rstate, *ref_args)
        rdp_state, rdp_loss = rdp_step(rdp_state, *ref_args)
        args = [torch.from_numpy(r.view(np.int32).copy()) for r in keys]
        rows = [torch.from_numpy(r.copy()) for r in mask]
        counts = [torch.from_numpy(r.copy()) for r in ae_batch]
        state, loss = step(state, args, args, args, rows, counts)
        dp_state, dp_loss = dp_step(dp_state, args, args, args, rows, counts)
        after = {"tp": _flat(PA.ae_gather_tp(state.scorer)),
                 "dp": _flat(params_to_numpy(dp_state.scorer)),
                 "ref_dp": _flat(rdp_state.scorer.params),
                 "ref_tp": _flat(rstate.scorer.params)}
        assert float(loss) == pytest.approx(float(rdp_loss), rel=1e-5), f"step {i}"
        assert float(loss) == pytest.approx(float(dp_loss), rel=1e-5), f"step {i}"
        for other in ("ref_dp", "dp"):
            assert_same_update(before["tp"], after["tp"], before[other], after[other], grad, lr,
                               1e-6, what=f"step {i} vs {other}")
        if i == 0:
            assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
            d_tp = {n: after["tp"][n] - before["tp"][n] for n in grad}
            d_ref = {n: after["ref_tp"][n] - before["ref_tp"][n] for n in grad}
            for name, g in grad.items():
                if name == "enc2.b":
                    continue
                clear = np.abs(g) > 1e-4 * np.abs(g).max()
                assert np.array_equal(np.sign(d_tp[name])[clear], np.sign(d_ref[name])[clear]), \
                    name
            # the reference's replicated enc2 bias after one step: one copy a
            # model lane, and they differ
            shards = rstate.scorer.params["enc2"]["b"].addressable_shards
            assert len({np.array(s.data).tobytes() for s in shards}) > 1
        else:
            assert float(loss) == pytest.approx(float(rloss), rel=5e-2)
    merged = merge(state.lanes)
    for i, (g, w, d) in enumerate(zip(bundle_to_numpy(merged), jax.tree.leaves(rmerge(
            rstate.bundle)), bundle_to_numpy(merge(dp_state.lanes)))):
        assert np.array_equal(g, np.asarray(w)) and np.array_equal(g, d), f"leaf {i}"
    for lane, dp_lane in zip(state.lanes, dp_state.lanes):
        assert all(np.array_equal(a, b) for a, b in zip(bundle_to_numpy(lane),
                                                       bundle_to_numpy(dp_lane)))
    assert state.scorer.steps == 2 and int(rstate.scorer.steps) == 2


def test_tp_step_needs_a_split_scorer():
    mesh = M.make_mesh(n_nodes=2, devices=["cpu"] * 2)
    _, port = _pair("f32")
    state = C.cluster_init(mesh, port, depth=2, log2_width=6, hll_p=4, entropy_log2_width=4, k=4)
    one = [torch.ones(4, dtype=torch.int32)] * 2
    with pytest.raises(ValueError, match="tensor-parallel scorer"):
        C.cluster_sketch_step(state, one, one, one, [torch.ones(4, dtype=torch.bool)] * 2,
                              [torch.ones(2, DIM)] * 2, use_tp=True)
