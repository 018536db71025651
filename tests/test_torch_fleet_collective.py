"""The collective merge tier: `make_fleet_merge` is `cluster_merge`
itself, bit-identical to it in one process, and across two processes on
a gloo group; and its `bundle_digest` is the reference's for the same
state.

The two-process case runs the port's worker (torch only) as two
processes joined by `init_distributed` over ``tcp://127.0.0.1:<free
port>``, each holding two of four lane rows (rank-major), and the
reference's own two-process worker (tests/test_fleet_collective.py) on
the same rows: both ranks' digests, the in-process `cluster_merge` of
the four rows and the reference's two-process digest are one hex
string. Each worker runs under its own timeout, so a hung rank fails
this test and not the suite.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inspektor_gadget_tpu.fleet.collective import bundle_digest as ref_bundle_digest
from inspektor_gadget_tpu.fleet.collective import make_fleet_merge as ref_make_fleet_merge
from inspektor_gadget_tpu.ops import bundle_init as ref_bundle_init
from inspektor_gadget_tpu.ops import bundle_update as ref_bundle_update
from inspektor_gadget_tpu.parallel import make_mesh as ref_make_mesh
from inspektor_gadget_tpu_torch.fleet.collective import (bundle_digest, fleet_collective_merge,
                                                         make_fleet_merge, shard_over_nodes)
from inspektor_gadget_tpu_torch.ops import bundle_init, bundle_to_numpy, bundle_update
from inspektor_gadget_tpu_torch.parallel.cluster import cluster_merge

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
N_NODES = 8
BATCH = 256
BUNDLE_KW = dict(depth=4, log2_width=10, hll_p=8, entropy_log2_width=7, k=16)
WORKER_TIMEOUT_S = 180


def _keys(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.zipf(1.3, (n, BATCH)).clip(1, 10_000).astype(np.uint32)


def port_rows(keys: np.ndarray, **geom) -> list:
    rows = []
    for k in keys:
        b = bundle_init(**{**BUNDLE_KW, **geom}, device="cpu")
        kt = torch.from_numpy(k.view(np.int32))
        rows.append(bundle_update(b, kt, kt, kt, torch.ones(BATCH, dtype=torch.bool)))
    return rows


def ref_stacked(keys: np.ndarray, **geom):
    rows = []
    for k in keys:
        b = ref_bundle_init(**{**BUNDLE_KW, **geom})
        kj = jnp.asarray(k)
        rows.append(ref_bundle_update(b, kj, kj, kj, jnp.ones(BATCH, bool)))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *rows)


def test_fleet_merge_bit_identical_to_cluster_merge():
    rows = port_rows(_keys(0, N_NODES))
    merged = make_fleet_merge()(rows)
    assert bundle_digest(merged) == bundle_digest(cluster_merge(rows))
    assert bundle_digest(merged) == bundle_digest(fleet_collective_merge(rows))


def test_fleet_merge_deterministic_and_placement_independent():
    rows = port_rows(_keys(3, N_NODES))
    merge = make_fleet_merge()
    d1, d2 = bundle_digest(merge(rows)), bundle_digest(merge(rows))
    assert d1 == d2
    placed = shard_over_nodes(["cpu"] * N_NODES, rows)
    assert all(p is not r for p, r in zip(placed, rows))
    assert bundle_digest(merge(placed)) == d1
    with pytest.raises(ValueError, match="3 rows for a mesh of 8"):
        shard_over_nodes(["cpu"] * N_NODES, rows[:3])


def test_fleet_merge_integer_lanes_are_exact_sums():
    keys = _keys(5, N_NODES)
    rows = port_rows(keys)
    merged = make_fleet_merge()(rows)
    np.testing.assert_array_equal(merged.cms.table.numpy(),
                                  np.sum([r.cms.table.numpy() for r in rows], axis=0))
    np.testing.assert_array_equal(merged.hll.registers.numpy(),
                                  np.max([r.hll.registers.numpy() for r in rows], axis=0))
    assert float(merged.events) == float(N_NODES * BATCH)


@pytest.mark.parametrize("geom", [{}, {"inv_rows": 3, "inv_log2_buckets": 9},
                                  {"quantiles": True, "quantile_buckets": 256},
                                  {"inv_rows": 2, "inv_log2_buckets": 8, "quantiles": True}],
                         ids=["base", "inv", "qt", "inv+qt"])
def test_digest_and_merge_equal_the_references(geom):
    """The reference's `make_fleet_merge` over the same rows on its eight
    forced CPU devices: the same leaves, and `bundle_digest` gives the
    reference's hex string (dtype names, shapes, bytes, tree structure),
    every optional plane on or off."""
    keys = _keys(9, N_NODES)
    rows = port_rows(keys, **geom)
    stacked = ref_stacked(keys, **geom)
    for p, k in zip(rows, range(N_NODES)):
        assert bundle_digest(p) == ref_bundle_digest(jax.tree.map(lambda x, k=k: x[k], stacked))
    want = ref_make_fleet_merge(ref_make_mesh(n_nodes=N_NODES))(stacked)
    got = make_fleet_merge()(rows)
    for i, (g, w) in enumerate(zip(bundle_to_numpy(got), jax.tree.leaves(want))):
        assert np.array_equal(g, np.asarray(w)), f"leaf {i}"
    assert bundle_digest(got) == ref_bundle_digest(want)


# -- two processes, one gloo group ------------------------------------------------------

PORT_WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from inspektor_gadget_tpu_torch.fleet.collective import bundle_digest, make_fleet_merge
    from inspektor_gadget_tpu_torch.models import AEConfig, ae_init
    from inspektor_gadget_tpu_torch.ops import bundle_init, bundle_update
    from inspektor_gadget_tpu_torch.parallel import cluster as C
    from inspektor_gadget_tpu_torch.parallel.distributed import (
        init_distributed, make_multihost_mesh, world_size)
    import torch.distributed as dist

    coord, pid = sys.argv[1], int(sys.argv[2])
    init_distributed(coord, num_processes=2, process_id=pid, device="cpu", timeout_s=120)
    assert world_size() == 2 and dist.get_backend() == "gloo"
    mesh = make_multihost_mesh(devices=["cpu", "cpu"])
    rng = np.random.default_rng(0)
    keys = rng.zipf(1.3, (4, 256)).clip(1, 10_000).astype(np.uint32)
    rows = []
    for k in keys[pid * 2:(pid + 1) * 2]:
        b = bundle_init(depth=4, log2_width=10, hll_p=8, entropy_log2_width=7, k=16,
                        device="cpu")
        kt = torch.from_numpy(k.view(np.int32))
        rows.append(bundle_update(b, kt, kt, kt, torch.ones(256, dtype=torch.bool)))
    merged = make_fleet_merge(dist.group.WORLD)(rows)

    # the data-parallel step across the ranks: each rank's two lanes, one
    # mean gradient over all four, one Adam step on each replica
    cfg = AEConfig(input_dim=64, hidden_dim=32, latent_dim=8, compute_dtype=torch.float32)
    scorer = ae_init(cfg, seed=5, device="cpu")
    state = C.cluster_init(mesh, scorer, depth=2, log2_width=6, hll_p=4,
                           entropy_log2_width=4, k=4)
    ae = np.random.default_rng(1).poisson(3.0, (4, 8, 64)).astype(np.float32)
    one = [torch.ones(16, dtype=torch.int32)] * 2
    mask = [torch.ones(16, dtype=torch.bool)] * 2
    step, _ = C.make_cluster_step(mesh, state, group=dist.group.WORLD)
    state, loss = step(state, one, one, one, mask,
                       [torch.from_numpy(x) for x in ae[pid * 2:(pid + 1) * 2]])
    params = torch.cat([p.detach().reshape(-1) for p in scorer.model.parameters()])
    print(json.dumps({"pid": pid, "digest": bundle_digest(merged),
                      "events": float(merged.events), "loss": float(loss),
                      "params": params.tolist()}), flush=True)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_processes(script: str) -> list[dict]:
    """`script` as ranks 0 and 1 on a fresh loopback port; each must exit
    0 within WORKER_TIMEOUT_S (a hung rank is killed and fails the test).
    Returns each rank's last JSON line."""
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", script, coord, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=ROOT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_process_fleet_merge_digests_match():
    """Both ranks hold the same fleet bundle; its digest is the in-process
    `cluster_merge` of the four rows and the reference's two-process
    digest; the scorer's replicas stay equal and match the in-process
    four-lane step."""
    from test_fleet_collective import WORKER as REF_WORKER
    port = _two_processes(PORT_WORKER)
    ref = _two_processes(REF_WORKER)
    if any("skip" in o for o in ref):
        pytest.fail(f"the reference's backend ran no multiprocess collective: {ref}")
    rows = port_rows(np.random.default_rng(0).zipf(1.3, (4, 256)).clip(1, 10_000)
                     .astype(np.uint32))
    want = bundle_digest(cluster_merge(rows))
    assert port[0]["digest"] == port[1]["digest"] == want
    assert ref[0]["digest"] == ref[1]["digest"] == want
    assert port[0]["events"] == 4 * 256
    assert port[0]["params"] == port[1]["params"]
    from inspektor_gadget_tpu_torch.models import AEConfig, ae_init
    from inspektor_gadget_tpu_torch.parallel import cluster as C
    scorer = ae_init(AEConfig(input_dim=64, hidden_dim=32, latent_dim=8,
                              compute_dtype=torch.float32), seed=5, device="cpu")
    state = C.cluster_init(["cpu"] * 4, scorer, depth=2, log2_width=6, hll_p=4,
                           entropy_log2_width=4, k=4)
    ae = np.random.default_rng(1).poisson(3.0, (4, 8, 64)).astype(np.float32)
    one = [torch.ones(16, dtype=torch.int32)] * 4
    _, loss = C.cluster_sketch_step(state, one, one, one, [torch.ones(16, dtype=torch.bool)] * 4,
                                    [torch.from_numpy(x) for x in ae])
    params = torch.cat([p.detach().reshape(-1) for p in scorer.model.parameters()])
    np.testing.assert_allclose(port[0]["params"], params.numpy(), rtol=1e-5, atol=1e-7)
    assert np.isclose(port[0]["loss"], float(loss), rtol=1e-5)
