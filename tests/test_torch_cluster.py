"""The port's lane meshes, cluster step and cluster merge against the JAX
package's `make_cluster_step` on its eight forced CPU devices
(tests/conftest.py).

The port's lanes are ``["cpu"] * 8``. One step of both packages from the
same weights (the reference's, carried into the port) and the same
seeded batches: the merged bundle's leaves equal the reference's merge
exactly; the data-parallel autoencoder step (each lane's gradient, their
mean, one Adam step) leaves every weight within 5% of that leaf's
largest magnitude of the reference's (bf16 matmuls in two frameworks,
PERF.md §2) and the loss within 2%.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inspektor_gadget_tpu.models import AEConfig as RefAEConfig
from inspektor_gadget_tpu.models import ae_init as ref_ae_init
from inspektor_gadget_tpu.ops import bundle_init as ref_bundle_init
from inspektor_gadget_tpu.ops import bundle_update as ref_bundle_update
from inspektor_gadget_tpu.parallel import cluster_init as ref_cluster_init
from inspektor_gadget_tpu.parallel import make_cluster_step as ref_make_cluster_step
from inspektor_gadget_tpu.parallel import make_mesh as ref_make_mesh
from inspektor_gadget_tpu_torch.models import AEConfig, ae_init, params_from_numpy
from inspektor_gadget_tpu_torch.models.params import _flatten, params_to_numpy
from inspektor_gadget_tpu_torch.ops import bundle_init, bundle_to_numpy, bundle_update, hll_estimate
from inspektor_gadget_tpu_torch.parallel import cluster as C
from inspektor_gadget_tpu_torch.parallel import distributed as D
from inspektor_gadget_tpu_torch.parallel import mesh as M

from _torch_update import assert_same_update

torch.set_num_threads(2)

BATCH = 256
DIM = 256
NODES = 8
CPU = torch.device("cpu")
BUNDLE_KW = dict(depth=4, log2_width=12, hll_p=10, entropy_log2_width=8, k=32)


def _port_state(ref_scorer):
    mesh = M.make_mesh(devices=[CPU] * NODES)
    scorer = ae_init(AEConfig(input_dim=DIM, hidden_dim=128, latent_dim=32), device="cpu")
    params_from_numpy(scorer, jax.tree.map(np.array, ref_scorer.params))
    return mesh, C.cluster_init(mesh, scorer, **BUNDLE_KW)


def _ref_state():
    mesh = ref_make_mesh(n_nodes=NODES)
    scorer = ref_ae_init(RefAEConfig(input_dim=DIM, hidden_dim=128, latent_dim=32))
    return mesh, ref_cluster_init(mesh, scorer, **BUNDLE_KW)


def _rows(a: np.ndarray) -> list[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(r)) for r in a]


def _keys32(a: np.ndarray) -> list[torch.Tensor]:
    return _rows(a.astype(np.uint32).view(np.int32))


def _mean_grads(scorer, ae_batch: np.ndarray) -> dict[str, np.ndarray]:
    """The mean over the lanes of each lane's autoencoder gradient, by
    parameter name, at the scorer's current weights."""
    from inspektor_gadget_tpu_torch.models import ae_loss, normalize_counts
    names, params = zip(*scorer.model.named_parameters())
    loss = sum(ae_loss(scorer.model, normalize_counts(torch.from_numpy(x)), scorer.config)
               for x in ae_batch) / len(ae_batch)
    return {n: g.numpy() for n, g in zip(names, torch.autograd.grad(loss, params))}


def test_mesh_axes_and_the_model_axis():
    assert (M.NODE_AXIS, M.MODEL_AXIS) == ("node", "model")
    assert M.make_mesh(devices=["cpu"] * NODES) == [CPU] * NODES
    assert M.make_mesh(n_nodes=4, devices=["cpu"] * NODES) == [CPU] * 4
    assert M.MeshSpec(4).n_model == 1
    # the model axis: rows of n_model lanes, row-major as the reference's grid
    devs = ["cpu"] * NODES
    mesh2 = M.make_mesh(n_nodes=4, n_model=2, devices=devs)
    assert M.mesh_shape(mesh2) == ref_make_mesh(n_nodes=4, n_model=2).shape == \
        {"node": 4, "model": 2}
    assert mesh2 == [[CPU, CPU]] * 4
    assert M.mesh_shape(M.make_mesh(n_model=4, devices=devs)) == {"node": 2, "model": 4}
    with pytest.raises(ValueError, match="n_model=2"):
        M.make_mesh(n_nodes=5, n_model=2, devices=devs)


def test_ingest_mesh_shape_and_validation():
    assert M.ingest_mesh(4, ["cpu"] * NODES) == [CPU] * 4
    assert M.ingest_mesh(1, ["cpu"]) == [CPU]
    with pytest.raises(ValueError, match="exceeds the 8 local device"):
        M.ingest_mesh(99, ["cpu"] * NODES)
    with pytest.raises(ValueError, match=">= 1"):
        M.ingest_mesh(0, ["cpu"] * NODES)
    # the default lanes are this process's cards: none here
    assert M.local_devices() == [] or torch.cuda.is_available()


def test_cluster_step_matches_the_reference():
    """One step of each package: the merge equals the reference's merge
    leaf by leaf and the sequential union's count-min and HLL; the DP
    scorer step lands within the AE tolerance of the reference's."""
    rmesh, rstate = _ref_state()
    rstep, rmerge = ref_make_cluster_step(rmesh, rstate)
    mesh, state = _port_state(rstate.scorer)
    step, merge = C.make_cluster_step(mesh, state)
    rng = np.random.default_rng(1)
    keys = rng.zipf(1.3, (NODES, BATCH)).clip(1, 10_000).astype(np.uint32)
    mask = np.ones((NODES, BATCH), dtype=bool)
    ae_batch = rng.poisson(3.0, (NODES, 16, DIM)).astype(np.float32)

    grads = _mean_grads(state.scorer, ae_batch)
    rstate, rloss = rstep(rstate, *(jnp.asarray(keys),) * 3, jnp.asarray(mask),
                          jnp.asarray(ae_batch))
    state, loss = step(state, *(_keys32(keys),) * 3, _rows(mask), _rows(ae_batch))
    merged, rmerged = merge(state.lanes), rmerge(rstate.bundle)
    for i, (g, w) in enumerate(zip(bundle_to_numpy(merged), jax.tree.leaves(rmerged))):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w), f"merged leaf {i}"
    assert float(merged.events) == NODES * BATCH

    seq = bundle_init(**BUNDLE_KW, device="cpu")
    for k in _keys32(keys):
        bundle_update(seq, k, k, k, torch.ones(BATCH, dtype=torch.bool))
    assert torch.equal(merged.cms.table, seq.cms.table)
    assert torch.equal(merged.hll.registers, seq.hll.registers)
    uniq, counts = np.unique(keys, return_counts=True)
    assert int(uniq[np.argmax(counts)]) in merged.topk.keys.tolist()

    assert np.isclose(float(loss), float(rloss), rtol=2e-2)
    got = params_to_numpy(state.scorer)
    want = jax.tree.map(np.array, rstate.scorer.params)
    for layer in want:
        for leaf in ("w", "b"):
            g, w, gr = got[layer][leaf], want[layer][leaf], grads[f"{layer}.{leaf}"]
            # an element whose mean gradient is zero up to rounding moves by
            # noise (Adam's first step is lr * g / (|g| + eps)): it is held
            # to Adam's step bound, lr, as the seq key bias is elsewhere
            noise = np.abs(gr) < 1e-3 * np.abs(gr).max()
            assert noise.mean() <= 0.02, f"{layer}.{leaf}: {noise.sum()} zero gradients"
            diff = np.abs(g - w)
            assert diff[~noise].max() <= 0.05 * np.abs(w).max(), f"{layer}.{leaf}"
            assert (diff[noise] <= 2e-3).all(), f"{layer}.{leaf} beyond Adam's step bound"
    assert state.scorer.steps == 1


def test_dp_step_is_one_adam_step_on_the_mean_gradient():
    """Eight lanes with one batch each step the scorer as one Adam step on
    the mean of the eight lanes' gradients: the same as one step on the
    mean loss, computed directly."""
    cfg = AEConfig(input_dim=64, hidden_dim=32, latent_dim=8, compute_dtype=torch.float32)
    lanes = M.make_mesh(devices=[CPU] * 4)
    rng = np.random.default_rng(4)
    batch = rng.poisson(3.0, (4, 8, 64)).astype(np.float32)
    keys = _keys32(np.ones((4, 32), np.uint32))
    mask = _rows(np.ones((4, 32), bool))
    a, b = ae_init(cfg, seed=3, device="cpu"), ae_init(cfg, seed=3, device="cpu")
    state = C.cluster_init(lanes, a, depth=2, log2_width=6, hll_p=4, entropy_log2_width=4,
                           k=4)
    C.cluster_sketch_step(state, keys, keys, keys, mask, _rows(batch))
    from inspektor_gadget_tpu_torch.models import ae_loss, normalize_counts
    b.opt.zero_grad()
    loss = sum(ae_loss(b.model, normalize_counts(torch.from_numpy(x)), cfg) for x in batch) / 4
    loss.backward()
    b.opt.step()
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-7, msg=name)


def test_cluster_distinct_counting_across_nodes():
    """Disjoint key ranges on every lane: the merged HLL counts the union."""
    _, rstate = _ref_state()
    mesh, state = _port_state(rstate.scorer)
    step, merge = C.make_cluster_step(mesh, state)
    keys = (np.arange(NODES * BATCH, dtype=np.uint32).reshape(NODES, BATCH)
            * np.uint32(2654435761))
    state, _ = step(state, *(_keys32(keys),) * 3, _rows(np.ones((NODES, BATCH), bool)),
                    _rows(np.ones((NODES, 8, DIM), np.float32)))
    est = float(hll_estimate(merge(state.lanes).hll))
    assert abs(est - NODES * BATCH) / (NODES * BATCH) < 0.1


def test_merge_reads_and_changes_no_lane():
    _, rstate = _ref_state()
    mesh, state = _port_state(rstate.scorer)
    rng = np.random.default_rng(2)
    keys = rng.integers(1, 500, (NODES, BATCH)).astype(np.uint32)
    for lane, k in zip(state.lanes, _keys32(keys)):
        bundle_update(lane, k, k, k, torch.ones(BATCH, dtype=torch.bool))
    before = [bundle_to_numpy(lane) for lane in state.lanes]
    first = bundle_to_numpy(C.cluster_merge(state.lanes))
    assert all(np.array_equal(a, b) for a, b in zip(first, bundle_to_numpy(
        C.cluster_merge(state.lanes))))
    for lane, want in zip(state.lanes, before):
        assert all(np.array_equal(a, b) for a, b in zip(bundle_to_numpy(lane), want))


def test_reference_merge_of_stacked_rows_matches_the_port(tmp_path):
    """The same per-node rows merged by each package: equal leaves, with
    the invertible and DDSketch planes on (uint32 lanes masked, int32
    counts wrapping alike)."""
    from inspektor_gadget_tpu.fleet.collective import make_fleet_merge as ref_fleet_merge
    geom = dict(BUNDLE_KW, inv_rows=3, inv_log2_buckets=8, quantiles=True,
                quantile_buckets=512)
    rng = np.random.default_rng(6)
    keys = rng.zipf(1.3, (NODES, BATCH)).clip(1, 10_000).astype(np.uint32)
    rows, lanes = [], []
    for k in keys:
        rb = ref_bundle_init(**geom)
        kj = jnp.asarray(k)
        rows.append(ref_bundle_update(rb, kj, kj, kj, jnp.ones(BATCH, bool), values=kj))
        pb = bundle_init(**geom, device="cpu")
        kt = torch.from_numpy(k.view(np.int32))
        lanes.append(bundle_update(pb, kt, kt, kt, torch.ones(BATCH, dtype=torch.bool),
                                   values=kt))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *rows)
    want = ref_fleet_merge(ref_make_mesh(n_nodes=NODES))(stacked)
    got = C.cluster_merge(lanes)
    for i, (g, w) in enumerate(zip(bundle_to_numpy(got), jax.tree.leaves(want))):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w), f"leaf {i}"


def test_tensor_parallel_step_matches_the_reference():
    """The (node, model) mesh's step, float32: bundles equal the
    reference's TP step leaf by leaf; the loss and the update of the
    tensor-parallel scorer (gathered from its model shards) equal the
    reference's replicated step on the same node rows (1e-5; 1e-6, a
    thousandth of lr, but where the gradient is zero up to rounding), as
    `tests/test_torch_tensor_parallel.py` holds them and says why the
    reference's own TP step is not that step."""
    from inspektor_gadget_tpu.models import ae_loss as ref_ae_loss
    from inspektor_gadget_tpu.models.autoencoder import normalize_counts as ref_normalize_counts
    from inspektor_gadget_tpu_torch.models import ae_gather_tp

    def cfg(dtype):
        return dict(input_dim=DIM, hidden_dim=128, latent_dim=32, compute_dtype=dtype)

    rmesh = ref_make_mesh(n_nodes=4, n_model=2)
    ref = ref_ae_init(RefAEConfig(**cfg(jnp.float32)))
    rstate = ref_cluster_init(rmesh, ref, **BUNDLE_KW)
    rstep, rmerge = ref_make_cluster_step(rmesh, rstate)
    rdp_mesh = ref_make_mesh(n_nodes=4)
    rdp_state = ref_cluster_init(rdp_mesh, ref_ae_init(RefAEConfig(**cfg(jnp.float32))),
                                 **BUNDLE_KW)
    rdp_step, _ = ref_make_cluster_step(rdp_mesh, rdp_state)
    mesh = M.make_mesh(n_nodes=4, n_model=2, devices=["cpu"] * NODES)
    scorer = ae_init(AEConfig(**cfg(torch.float32)), device="cpu")
    params_from_numpy(scorer, jax.tree.map(np.array, rstate.scorer.params))
    w0 = _flatten(params_to_numpy(scorer))
    state = C.cluster_init(mesh, scorer, **BUNDLE_KW)
    step, merge = C.make_cluster_step(mesh, state)
    rng = np.random.default_rng(9)
    keys = rng.integers(1, 2**32, (4, BATCH), dtype=np.uint32)
    mask = np.ones((4, BATCH), bool)
    ae_batch = rng.poisson(3.0, (4, 8, DIM)).astype(np.float32)
    grad = _flatten(jax.tree.map(np.array, jax.grad(lambda p: sum(
        ref_ae_loss(p, ref_normalize_counts(jnp.asarray(b)), ref.config) for b in ae_batch)
        / len(ae_batch))(rdp_state.scorer.params)))
    ref_args = (*(jnp.asarray(keys),) * 3, jnp.asarray(mask), jnp.asarray(ae_batch))
    rstate, rloss = rstep(rstate, *ref_args)
    rdp_state, rdp_loss = rdp_step(rdp_state, *ref_args)
    state, loss = step(state, *(_keys32(keys),) * 3, _rows(mask), _rows(ae_batch))
    assert float(loss) == pytest.approx(float(rdp_loss), rel=1e-5)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    merged, rmerged = merge(state.lanes), rmerge(rstate.bundle)
    for i, (g, w) in enumerate(zip(bundle_to_numpy(merged), jax.tree.leaves(rmerged))):
        assert np.array_equal(g, np.asarray(w)), f"merged leaf {i}"
    assert float(merged.events) == 4 * BATCH
    got = _flatten({k: {kk: t.numpy() for kk, t in v.items()}
                    for k, v in ae_gather_tp(state.scorer).items()})
    assert_same_update(w0, got, w0, _flatten(jax.tree.map(np.array, rdp_state.scorer.params)),
                       grad, state.scorer.config.learning_rate, 1e-6,
                       what="vs the reference's replicated step")
    assert state.scorer.steps == 1


def test_distributed_without_a_group():
    """No process group: one process of one, rank 0; `init_distributed`
    without a process count does nothing; the backend follows the
    device."""
    import torch.distributed as dist
    D.init_distributed()
    assert not dist.is_initialized()
    assert (D.world_size(), D.local_node_index()) == (1, 0)
    assert D.backend_for("cpu") == "gloo"
    assert D.make_multihost_mesh(devices=["cpu", "cpu"]) == [CPU, CPU]
    assert D.make_multihost_mesh(n_model=2, devices=["cpu"] * 4) == [[CPU, CPU]] * 2
