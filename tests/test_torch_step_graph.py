"""The staged-ingest step replayed as a CUDA graph holds the eager step's
state bit for bit.

On the card `bundle_ingest_step` runs a key's first step eagerly,
captures the second and replays the rest (`ops/sketches.py`). The card's
cases (marked ``card``; they skip without CUDA) feed one stream to a
bundle through the step and to a clone through the eager
`bundle_update_fused`, with fresh input tensors a batch as the stager
hands them over, and hold every leaf (`np.array_equal`) and every
digest's bytes equal: both geometries (the production one with the
invertible and quantile planes, and the benchmark cell's), the three key
lanes as one tensor and as three, nonzero drops, a pad change
mid-stream, a bundle replaced as the operator's resume replaces it, a
leaf at a new address, and two sharded lanes on one device. The
outcome counter reads one eager step and one capture a key, the rest
replays, and K2's launch count one a step. The CPU cases: the drops'
scalar add is the old host tensor's float32 add, the CPU never
captures, and the operator's update span names the outcome.

On the card: ``python -m pytest --noconftest tests/test_torch_step_graph.py``
(the repository's conftest imports JAX, which the card's machine lacks).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from inspektor_gadget_tpu_torch.operators import operators as O
from inspektor_gadget_tpu_torch.operators import tpusketch as P
from inspektor_gadget_tpu_torch.ops import kernels as K
from inspektor_gadget_tpu_torch.ops import sketches as S
from inspektor_gadget_tpu_torch.sources.batch import EventBatch, FoldedBatch
from inspektor_gadget_tpu_torch.telemetry.tracing import TRACER

torch.set_num_threads(2)

CELL_GEOMETRY = dict(depth=4, log2_width=16, hll_p=14, entropy_log2_width=12, k=128)
SMALL_GEOMETRY = dict(depth=3, log2_width=9, hll_p=7, entropy_log2_width=6, k=16, inv_rows=2,
                      inv_log2_buckets=6, quantiles=True, quantile_buckets=256)
OUTCOMES = ("eager", "capture", "replay")
BATCHES = 20


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph path runs only there")
    return torch.device("cuda", torch.cuda.current_device())


def counts() -> dict[str, float]:
    return {o: S._OUTCOMES[o].value for o in OUTCOMES}


def since(before: dict[str, float]) -> dict[str, float]:
    now = counts()
    return {o: now[o] - before[o] for o in OUTCOMES}


def lane(x: np.ndarray, dev) -> torch.Tensor:
    """A uint32 host lane as the stager hands it over: a fresh int32 bit
    view on the device."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32).view(np.int32)).to(dev)


def make_batch(rng, n: int, dev, *, aliased: bool, values: bool):
    """(hh, distinct, dist, weights, values) of a padded batch of n slots,
    zipf keys over 4000 names, weights 1-3, the last slots padding."""
    fill = int(n * rng.uniform(0.6, 1.0))

    def keys():
        k = (rng.zipf(1.2, n) % 4000 + 1).astype(np.uint64) * np.uint64(0x9E3779B1)
        k = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        k[fill:] = 0
        return k

    w = np.zeros(n, np.uint32)
    w[:fill] = rng.integers(1, 4, fill)
    hh = lane(keys(), dev)
    distinct, dist = (hh, hh) if aliased else (lane(keys(), dev), lane(keys(), dev))
    v = None
    if values:
        vals = rng.lognormal(4.0, 2.0, n).astype(np.uint32)
        vals[fill:] = 0
        v = lane(vals, dev)
    return hh, distinct, dist, lane(w, dev), v


def clone(b: S.SketchBundle) -> S.SketchBundle:
    return S.bundle_map(lambda t: t.clone(), b)


def assert_same(a: S.SketchBundle, b: S.SketchBundle) -> None:
    for i, (x, y) in enumerate(zip(S.bundle_to_numpy(a), S.bundle_to_numpy(b), strict=True)):
        assert x.dtype == y.dtype and np.array_equal(x, y), f"leaf {i}"
    assert S.bundle_digest(a).cpu().numpy().tobytes() == S.bundle_digest(b).cpu().numpy().tobytes()


def feed(graph_b, eager_b, batch, drops) -> None:
    hh, distinct, dist, w, v = batch
    _, fence = S.bundle_ingest_step(graph_b, hh, distinct, dist, w, drops, v)
    S.bundle_update_fused(eager_b, hh, distinct, dist, w, drops, v)
    assert isinstance(fence, torch.cuda.Event)


# -- the card ------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("geometry", ["production", "cell"])
@pytest.mark.parametrize("aliased", [True, False], ids=["one-key-lane", "three-key-lanes"])
def test_graph_state_equals_the_eager_step(card, geometry, aliased):
    geom = S.PRODUCTION_GEOMETRY if geometry == "production" else CELL_GEOMETRY
    rng = np.random.default_rng(sum(map(ord, geometry)) + aliased)
    a = S.bundle_init(**geom, device=card)
    b = clone(a)
    before, launches = counts(), K.fused_planes.launches
    for i in range(BATCHES):
        batch = make_batch(rng, S.PRODUCTION_BATCH, card, aliased=aliased,
                           values=geometry == "production")
        feed(a, b, batch, float(i % 3) * 2.5)
        assert a.graphs.last == OUTCOMES[min(i, 2)]
        if i % 5 == 4:
            assert_same(a, b)
    assert since(before) == {"eager": 1, "capture": 1, "replay": BATCHES - 2}
    assert K.fused_planes.launches - launches == 2 * BATCHES  # the graph's and the clone's
    assert float(a.drops) == sum(float(np.float32(i % 3 * 2.5)) for i in range(BATCHES))
    assert len(a.graphs.graphs) == 1


@pytest.mark.card
def test_a_pad_change_warms_and_captures_its_own_key(card):
    rng = np.random.default_rng(11)
    a = S.bundle_init(**S.PRODUCTION_GEOMETRY, device=card)
    b = clone(a)
    before = counts()
    for i in range(BATCHES):
        n = S.PRODUCTION_BATCH // 2 if i < BATCHES // 2 else S.PRODUCTION_BATCH
        feed(a, b, make_batch(rng, n, card, aliased=True, values=False), 1.0)
    assert_same(a, b)
    assert since(before) == {"eager": 2, "capture": 2, "replay": BATCHES - 4}
    assert len(a.graphs.graphs) == 2


@pytest.mark.card
def test_a_replaced_bundle_captures_again(card):
    rng = np.random.default_rng(12)
    a = S.bundle_init(**S.PRODUCTION_GEOMETRY, device=card)
    b = clone(a)
    resumed = S.bundle_init(**S.PRODUCTION_GEOMETRY, device="cpu")
    for _ in range(2):
        hh, distinct, dist, w, v = make_batch(rng, 4096, "cpu", aliased=True, values=True)
        S.bundle_update_fused(resumed, hh, distinct, dist, w, 1.0, v)
    leaves = S.bundle_to_numpy(resumed)
    before = counts()
    for i in range(BATCHES):
        if i == BATCHES // 2:  # as the operator's resume does
            a = S.bundle_merge(a, S.bundle_from_numpy(leaves, device=card))
            b = S.bundle_merge(b, S.bundle_from_numpy(leaves, device=card))
            assert not a.graphs.graphs
        feed(a, b, make_batch(rng, S.PRODUCTION_BATCH, card, aliased=True, values=True), 0.0)
    assert_same(a, b)
    assert since(before) == {"eager": 2, "capture": 2, "replay": BATCHES - 4}


@pytest.mark.card
def test_a_leaf_at_a_new_address_captures_again(card):
    rng = np.random.default_rng(13)
    a = S.bundle_init(**CELL_GEOMETRY, device=card)
    b = clone(a)
    before = counts()
    for i in range(BATCHES):
        if i == BATCHES // 2:
            a.cms = dataclasses.replace(a.cms, table=a.cms.table.clone())
        feed(a, b, make_batch(rng, S.PRODUCTION_BATCH, card, aliased=True, values=False), 0.0)
    assert_same(a, b)
    assert since(before) == {"eager": 1, "capture": 2, "replay": BATCHES - 3}


@pytest.mark.card
def test_two_sharded_lanes_on_one_device(card):
    rng = np.random.default_rng(14)
    mesh = [card, card]
    like = S.bundle_init(**S.PRODUCTION_GEOMETRY, device=card)
    lanes = S.bundle_stack_sharded(like, mesh)
    eager = [clone(x) for x in lanes]
    step = S.make_bundle_ingest_sharded(mesh, like)
    before, launches = counts(), K.fused_planes.launches
    for i in range(BATCHES):
        batches = [make_batch(rng, S.PRODUCTION_BATCH, card, aliased=True, values=True)
                   for _ in mesh]
        cols = list(zip(*batches))
        drops = [float(i), 0.0]
        lanes, tokens = step(lanes, *cols[:4], drops, cols[4])
        assert len(tokens) == 2
        for x, bt, d in zip(eager, batches, drops):
            S.bundle_update_fused(x, *bt[:4], d, bt[4])
    for x, y in zip(lanes, eager):
        assert_same(x, y)
    assert lanes[0].graphs is not lanes[1].graphs
    assert since(before) == {"eager": 2, "capture": 2, "replay": 2 * BATCHES - 4}
    assert K.fused_planes.launches - launches == 4 * BATCHES


# -- the CPU -------------------------------------------------------------------

@pytest.mark.parametrize("base", [0.0, 5.5, float(2 ** 24), 3.0e38])
@pytest.mark.parametrize("drops", [0, 1, 3.7, 2 ** 24 + 1, 1e30])
def test_the_drops_scalar_add_is_the_host_tensors_float32_add(base, drops):
    b = S.bundle_init(**SMALL_GEOMETRY, device="cpu")
    b.drops.fill_(base)
    old = b.drops.clone().add_(torch.as_tensor(drops, dtype=torch.float32))
    S._add_drops(b, drops)
    assert b.drops.view(torch.int32).item() == old.view(torch.int32).item()
    S._add_drops(b, torch.tensor(drops, dtype=torch.float64))  # a tensor adds as float32
    assert b.drops.view(torch.int32).item() == old.add_(
        torch.as_tensor(drops, dtype=torch.float32)).view(torch.int32).item()


def test_the_cpu_never_captures_and_keeps_the_plain_state():
    rng = np.random.default_rng(5)
    a = S.bundle_init(**SMALL_GEOMETRY, device="cpu")
    b = clone(a)
    before = counts()
    for i in range(4):
        hh, distinct, dist, w, v = make_batch(rng, 2048, "cpu", aliased=i % 2 == 0, values=True)
        _, fence = S.bundle_ingest_step(a, hh, distinct, dist, w, float(i), v)
        S.bundle_update(b, hh, distinct, dist, w, float(i), v)
        assert a.graphs.last == "eager" and not a.graphs.graphs and not a.graphs.warm
        assert torch.equal(fence, a.events)
    assert_same(a, b)
    assert since(before) == {"eager": 4, "capture": 0, "replay": 0}


def test_lanes_alias_by_tensor():
    x = torch.arange(8, dtype=torch.int32)
    y = x.clone()
    assert S._alias((x, x, x, y, None)) == (0, 0, 0, 3, -1)
    assert S._alias((x, y, x.view(torch.int32), y, x)) == (0, 1, 0, 1, 0)
    assert S._alias((x, x.view(torch.uint32), x[:4], y, y)) == (0, 1, 2, 3, 3)


@pytest.fixture()
def inst():
    cfg = P.SketchConfig(depth=3, log2_width=10, hll_p=8, entropy_log2_width=6, topk=8,
                         harvest_interval=3600.0)
    inst = P.TpuSketchInstance(cfg, P.SketchContext(run_id="step-graph"), device="cpu")
    TRACER.reset()
    yield inst
    inst.post_gadget_run()
    TRACER.reset()


def test_the_update_span_names_how_the_step_ran(inst):
    rng = np.random.default_rng(6)
    chain = O.Operators([inst])
    b = EventBatch.alloc(1000, with_comm=False)
    b.cols["key_hash"][:] = rng.integers(1, 300, 1000).astype(np.uint64) * \
        np.uint64(0x9E3779B97F4A7C15)
    b.cols["ts"][:] = 1_700_000_000_000_000_000
    b.count = 1000
    chain.enrich_batch(b)
    pb = inst.folded_block()
    folded = pb.numpy()
    folded[0, :500] = np.arange(1, 501, dtype=np.uint32)
    folded[1, :500] = 1
    inst.ingest_folded(FoldedBatch(lanes=folded, count=500, block=pb))
    updates = [r for r in TRACER.records() if r.name == "tpusketch/update"]
    assert [r.attrs.get("graph") for r in updates] == ["eager", "eager"]
