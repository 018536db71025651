"""The port's sharded ingest against its single-lane fold and the JAX
package's sharded harvest, on the CPU.

One bundle a lane, batches dealt round-robin onto the lanes, the lanes
merged only at harvest (`cluster_merge`): the harvested bundle must equal
the single-lane fold of the same stream leaf by leaf (`np.array_equal`),
and the reference's `make_bundle_harvest_sharded` at the same lane count
on its forced CPU devices (tests/conftest.py), and the reference's
single-chip fold. The port's lanes are ``["cpu"] * n``: lanes sharing a
device are how the lane algebra is checked without n cards. Streams keep
the heavy-hitter vocabulary under the top-k size k, where the streaming
candidate set is exact on every path (the reference's own note in
tests/test_sharded_ingest.py), and batch weight sums below 2**24 (the
float32 regime of PERF.md §1).

The operator tier patches `_lane_devices`, as the reference's tests pin
a topology, and holds `TpuSketchInstance` summaries at chips 2 and 4 to
the unsharded instance's and to the reference's sharded instance's:
estimates bit for bit, the ae scores within 5%.
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu.gadgets import GadgetContext as RefGadgetContext
from inspektor_gadget_tpu.gadgets import get as ref_get
from inspektor_gadget_tpu.operators import tpusketch as R
from inspektor_gadget_tpu.operators.operators import get as ref_get_op
from inspektor_gadget_tpu.ops import sketches as RS
from inspektor_gadget_tpu.parallel.mesh import NODE_AXIS
from inspektor_gadget_tpu.parallel.mesh import ingest_mesh as ref_ingest_mesh
from inspektor_gadget_tpu.sources.synthetic import PySyntheticSource as RefSource
from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
from inspektor_gadget_tpu_torch.history import SealedWindow, window_digest
from inspektor_gadget_tpu_torch.models.params import params_from_numpy
from inspektor_gadget_tpu_torch.operators import tpusketch as P
from inspektor_gadget_tpu_torch.operators.operators import get as get_op
from inspektor_gadget_tpu_torch.ops import sketches as S
from inspektor_gadget_tpu_torch.params import ParamError
from inspektor_gadget_tpu_torch.parallel.mesh import ingest_mesh
from inspektor_gadget_tpu_torch.sources.batch import EventBatch, FoldedBatch
from inspektor_gadget_tpu_torch.sources.synthetic import PySyntheticSource

torch.set_num_threads(2)

KW = dict(depth=3, log2_width=9, hll_p=7, entropy_log2_width=6, k=64)
PLANES = dict(inv_rows=3, inv_log2_buckets=8, quantiles=True, quantile_buckets=512)
BATCH = 512
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _release_instances():
    """Drain and unregister the instances a test built (neither package's
    post_gadget_run ran for some), so no gauge or live row leaks."""
    before = {mod: set(mod._live) for mod in (R, P)}
    yield
    for mod, ids in before.items():
        with mod._live_mu:
            fresh = [mod._live.pop(rid) for rid in list(mod._live) if rid not in ids]
        for inst in fresh:
            if getattr(inst, "_stager", None) is not None:
                inst._stager.drain()
            for st in getattr(inst, "_lane_stagers", []):
                st.drain()
            inst._stats.unregister()
            inst._pstats.unregister()


# -- the library tier ---------------------------------------------------------------

def _mixed_batches(rng, count: int = 13, planes: bool = False) -> list[tuple]:
    """(keys, weights, values, drops): ragged tails, per-batch drops, a
    key vocabulary under k; with `planes`, weights in {0, 1, 3} and
    values on the DDSketch's gamma**i boundaries."""
    out = []
    for i in range(count):
        n = BATCH if i % 3 else 300 + i
        keys = np.zeros(BATCH, np.uint32)
        keys[:n] = rng.integers(1, 50, n)
        w = np.zeros(BATCH, np.uint32)
        w[:n] = rng.choice(np.array([0, 1, 3], np.uint32), n) if planes else 1
        g = 1.01 / 0.99
        v = np.clip(np.floor(g ** rng.integers(0, 600, BATCH)), 0, 2**32 - 1).astype(np.uint32)
        out.append((keys, w, v, float(i % 2)))
    return out


def _lanes(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32))


def _port_fold(batches, geom) -> S.SketchBundle:
    b = S.bundle_init(**geom, device="cpu")
    for k, w, v, dr in batches:
        S.bundle_ingest_step(b, _lanes(k), _lanes(k), _lanes(k), _lanes(w), dr,
                             _lanes(v) if geom.get("quantiles") else None)
    return b


def _ref_fold(batches, geom):
    b = RS.bundle_init(**geom)
    for k, w, v, dr in batches:
        args = (jnp.asarray(k),) * 3 + (jnp.asarray(w), jnp.float32(dr))
        b, _ = RS.bundle_ingest_jit(b, *args, *((jnp.asarray(v),) if geom.get("quantiles")
                                                 else ()))
    return b


class _RoundRobin:
    """The operator's dealing, for either package's sharded maker pair:
    batch i to lane `next % chips`, a full round dispatched, a harvest
    flushing the open round with zero-weight fillers (the next batch then
    goes on at `next`, not at lane 0)."""

    def __init__(self, chips: int, step, harvest, state):
        self.chips, self.step, self.harvest_fn, self.state = chips, step, harvest, state
        self.next, self.pending, self.rounds = 0, {}, 0

    def add(self, batch) -> None:
        self.pending[self.next] = batch
        self.next = (self.next + 1) % self.chips
        if len(self.pending) == self.chips:
            self.flush()

    def flush(self) -> None:
        if not self.pending:
            return
        zero = (np.zeros(BATCH, np.uint32),) * 3 + (0.0,)
        rnd = [self.pending.get(k, zero) for k in range(self.chips)]
        self.state = self.step(self.state, rnd)
        self.pending, self.rounds = {}, self.rounds + 1

    def harvest(self):
        self.flush()
        return self.harvest_fn(self.state)


def _port_sharded(chips: int, geom) -> _RoundRobin:
    mesh = ingest_mesh(chips, [CPU] * chips)
    like = S.bundle_init(**geom, device="cpu")
    step = S.make_bundle_ingest_sharded(mesh, like)

    def do(lanes, rnd):
        keys = [_lanes(b[0]) for b in rnd]
        vals = [_lanes(b[2]) for b in rnd] if geom.get("quantiles") else None
        lanes, tokens = step(lanes, keys, keys, keys, [_lanes(b[1]) for b in rnd],
                             [b[3] for b in rnd], vals)
        assert len(tokens) == chips
        return lanes

    return _RoundRobin(chips, do, S.make_bundle_harvest_sharded(mesh, like),
                       S.bundle_stack_sharded(like, mesh))


def _ref_sharded(chips: int, geom) -> _RoundRobin:
    from jax.sharding import NamedSharding, PartitionSpec as Ps
    mesh = ref_ingest_mesh(chips)
    like = RS.bundle_init(**geom)
    step = RS.make_bundle_ingest_sharded(mesh, like)
    sh = NamedSharding(mesh, Ps(NODE_AXIS))

    def do(state, rnd):
        keys = jax.device_put(np.stack([b[0] for b in rnd]), sh)
        wts = jax.device_put(np.stack([b[1] for b in rnd]), sh)
        drs = jax.device_put(np.asarray([b[3] for b in rnd], np.float32), sh)
        extra = ((jax.device_put(np.stack([b[2] for b in rnd]), sh),)
                 if geom.get("quantiles") else ())
        state, _ = step(state, keys, keys, keys, wts, drs, *extra)
        return state

    return _RoundRobin(chips, do, RS.make_bundle_harvest_sharded(mesh, like),
                       RS.bundle_stack_sharded(like, mesh))


def _assert_leaves(got: S.SketchBundle, want, ctx: str) -> None:
    g = S.bundle_to_numpy(got)
    w = (S.bundle_to_numpy(want) if isinstance(want, S.SketchBundle)
         else [np.asarray(x) for x in jax.tree.leaves(want)])
    assert len(g) == len(w), ctx
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{ctx}: leaf {i} diverged"


@pytest.mark.parametrize("planes", [False, True], ids=["base", "inv+qt"])
@pytest.mark.parametrize("chips", [1, 2, 4, 8])
def test_sharded_harvest_bit_identical_across_1_2_4_8(chips, planes):
    """Every leaf of the harvest at `chips` lanes equals the port's
    single-lane fold, the reference's sharded harvest at as many lanes
    and its single-chip fold; over ragged tails and per-batch drops, with
    a mid-round harvest after 5 batches (the open round flushed with
    fillers) equal to the folds of that prefix."""
    geom = {**KW, **(PLANES if planes else {})}
    batches = _mixed_batches(np.random.default_rng(7), planes=planes)
    port, ref = _port_sharded(chips, geom), _ref_sharded(chips, geom)
    mid = 5
    for i, b in enumerate(batches):
        port.add(b)
        ref.add(b)
        if i + 1 == mid:
            got_mid, ref_mid = port.harvest(), ref.harvest()
            _assert_leaves(got_mid, _port_fold(batches[:mid], geom), f"chips={chips} mid")
            _assert_leaves(got_mid, ref_mid, f"chips={chips} mid vs reference")
    got = port.harvest()
    _assert_leaves(got, _port_fold(batches, geom), f"chips={chips}")
    _assert_leaves(got, ref.harvest(), f"chips={chips} vs the reference's sharded harvest")
    _assert_leaves(got, _ref_fold(batches, geom), f"chips={chips} vs the reference's fold")


def test_harvest_changes_no_lane_and_ingest_goes_on():
    """The harvest reads the lanes and writes none of them: lanes
    harvested twice give the same bundle, and ingest continues after."""
    batches = _mixed_batches(np.random.default_rng(3), count=8)
    rr = _port_sharded(4, KW)
    for b in batches[:4]:
        rr.add(b)
    before = [S.bundle_to_numpy(lane) for lane in rr.state]
    _assert_leaves(rr.harvest(), rr.harvest(), "harvested twice")
    for lane, want in zip(rr.state, before):
        assert all(np.array_equal(a, b) for a, b in zip(S.bundle_to_numpy(lane), want))
    for b in batches[4:]:
        rr.add(b)
    _assert_leaves(rr.harvest(), _port_fold(batches, KW), "after more ingest")


def test_filler_round_leaves_every_leaf_unchanged():
    """A round of zero-weight fillers (what a flush gives the lanes with
    no batch) changes no leaf of any lane, top-k and HLL included."""
    geom = {**KW, **PLANES}
    rr = _port_sharded(2, geom)
    for b in _mixed_batches(np.random.default_rng(11), count=6, planes=True):
        rr.add(b)
    before = [S.bundle_to_numpy(lane) for lane in rr.state]
    rr.pending = {0: (np.zeros(BATCH, np.uint32),) * 3 + (0.0,)}
    rr.flush()
    for k, (lane, want) in enumerate(zip(rr.state, before)):
        got = S.bundle_to_numpy(lane)
        for i, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a, b), f"lane {k} leaf {i} moved under a filler round"


def test_each_lane_runs_its_own_fused_step(monkeypatch):
    """One fused pass (K2 on the card) a lane and round, each on its
    lane's tensors: rounds x lanes calls, fillers included."""
    calls = []
    real = S.fused_planes

    def counting(hh, *a, **kw):
        calls.append(hh.device)
        return real(hh, *a, **kw)

    monkeypatch.setattr(S, "fused_planes", counting)
    rr = _port_sharded(4, KW)
    for b in _mixed_batches(np.random.default_rng(5), count=10):
        rr.add(b)
    rr.harvest()
    assert rr.rounds == 3 and len(calls) == rr.rounds * 4
    assert set(calls) == {CPU}


def test_sharded_step_refuses_a_lane_on_another_device():
    """A lane's batch must lie on the lane's device: the step raises
    rather than run it elsewhere."""
    mesh = [torch.device("cpu"), torch.device("meta")]
    like = S.bundle_init(**KW, device="cpu")
    step = S.make_bundle_ingest_sharded(mesh, like)
    lanes = [S.bundle_init(**KW, device="cpu"), S.bundle_init(**KW, device="cpu")]
    x = [torch.zeros(BATCH, dtype=torch.int32)] * 2
    with pytest.raises(ValueError, match="not on the lane's device meta"):
        step(lanes, x, x, x, x, [0.0, 0.0])


@pytest.mark.parametrize("chips", [2, 4, 8])
def test_sharded_window_digest_identical_across_device_counts(chips):
    """A window sealed from the harvested state has the single-lane
    fold's `window_digest` at every lane count."""
    batches = _mixed_batches(np.random.default_rng(24), count=9)

    def seal(b: S.SketchBundle) -> str:
        leaves = S.bundle_to_numpy(b)
        return window_digest(SealedWindow(
            gadget="trace/parity", node="n0", run_id="r", window=1, start_ts=1.0, end_ts=2.0,
            events=int(leaves[7]), drops=0, cms=leaves[0], hll=leaves[2], ent=leaves[3],
            topk_keys=leaves[4], topk_counts=leaves[5].astype(np.int64), slices={}))

    rr = _port_sharded(chips, KW)
    for b in batches:
        rr.add(b)
    assert seal(rr.harvest()) == seal(_port_fold(batches, KW))


# -- the operator tier ------------------------------------------------------------------

SKETCH = {"log2-width": "8", "hll-p": "6", "entropy-log2-width": "6", "topk": "64",
          "harvest-interval": "1h"}


@pytest.fixture()
def lanes8(monkeypatch):
    """Eight CPU lanes for the port's operator, as the reference's tests
    see eight forced CPU devices."""
    monkeypatch.setattr(P, "_lane_devices",
                        lambda chips, device: [CPU] * (chips if chips is not None else 8))


def _port_instance(extra: dict, gadget_params: dict | None = None):
    ctx = GadgetContext(get("trace", "exec"), device="cpu")
    for k, v in (gadget_params or {}).items():
        ctx.gadget_params.set(k, v)
    op = get_op("tpusketch")
    p = op.instance_params().to_params()
    for k, v in {"enable": "true", **SKETCH, **extra}.items():
        p.set(k, v)
    return op.instantiate(ctx, None, p)


def _ref_instance(extra: dict):
    ctx = RefGadgetContext(ref_get("trace", "exec"))
    op = ref_get_op("tpusketch")
    p = op.instance_params().to_params()
    for k, v in {"enable": "true", **SKETCH, **extra}.items():
        p.set(k, v)
    return op.instantiate(ctx, None, p)


def _port_batch(rb) -> EventBatch:
    """The reference source's batch as the port's EventBatch."""
    b = EventBatch.alloc(rb.count, with_comm=rb.comm is not None)
    for k, v in rb.cols.items():
        b.cols[k][:] = v
    if rb.comm is not None:
        b.comm[:] = rb.comm
    b.count, b.drops = rb.count, rb.drops
    return b


@pytest.fixture()
def batches():
    src = RefSource(seed=5, vocab=40, batch_size=BATCH)
    return [src.generate(BATCH) for _ in range(10)]


def _summaries(inst, batches, port: bool, mid: int = 6) -> list:
    out = []
    for i, b in enumerate(batches):
        inst.enrich_batch(_port_batch(b) if port else b)
        if i + 1 == mid:
            out.append(inst.harvest())
    out.append(inst.harvest())
    inst.post_gadget_run()
    return out


def _same(got, want, ae: bool = False) -> None:
    assert (got.events, got.drops, got.distinct, got.entropy_bits, got.heavy_hitters) == \
        (want.events, want.drops, want.distinct, want.entropy_bits, want.heavy_hitters)
    if ae:
        assert list(got.anomaly) == list(want.anomaly)
        g, w = (np.array(list(s.anomaly.values())) for s in (got, want))
        assert (np.abs(g - w) <= 5e-2 * np.abs(w)).all(), (g, w)


@pytest.mark.parametrize("chips", ["2", "4"])
def test_operator_sharded_summary_matches_unsharded_and_reference(chips, lanes8, batches):
    """10 batches over 2 or 4 lanes (full rounds and a flushed partial),
    harvested mid-run and at the end, with the ae scorer on: the
    summaries equal the unsharded instance's and the reference's sharded
    instance's at the same chip count (estimates bit for bit, ae within
    5%)."""
    ae = {"anomaly": "true", "anomaly-model": "ae"}
    ref_inst = _ref_instance({**ae, "shard-ingest": "true", "chips": chips})
    unsharded = _port_instance(ae)
    inst = _port_instance({**ae, "shard-ingest": "true", "chips": chips})
    assert inst._shard_on and inst._chips == int(chips)
    weights = jax.tree.map(np.array, ref_inst.scorer.params)
    for port in (unsharded, inst):  # the reference's weights (Adam state is zero on both)
        params_from_numpy(port.scorer, weights)
    want = _summaries(unsharded, batches, True)
    ref = _summaries(ref_inst, batches, False)
    got = _summaries(inst, batches, True)
    for g, w, r in zip(got, want, ref):
        _same(g, w, ae=True)
        _same(g, r, ae=True)


def test_operator_chips_auto_takes_every_lane(lanes8, batches):
    inst = _port_instance({"shard-ingest": "true"})
    assert inst._chips == 8
    got = _summaries(inst, batches, True)
    for g, w in zip(got, _summaries(_port_instance({}), batches, True)):
        _same(g, w)


def test_operator_sharded_deterministic_across_runs(lanes8, batches):
    """Two fresh sharded instances over one stream give the same summary
    sequence: lane dealing and flushes are functions of the stream."""
    def run():
        inst = _port_instance({"shard-ingest": "true", "chips": "4"})
        out = []
        for i, b in enumerate(batches):
            inst.enrich_batch(_port_batch(b))
            if (i + 1) % 3 == 0:
                s = inst.harvest()
                out.append((s.events, s.distinct, s.entropy_bits, tuple(s.heavy_hitters)))
        inst.post_gadget_run()
        return out

    assert run() == run()


def test_sharded_windows_seal_the_unsharded_digests(lanes8, batches, tmp_path):
    """With the history plane (a window a harvest) and the invertible and
    quantile planes on, a run over 2 lanes seals windows whose digests
    are the unsharded run's: the window plane reads the merged lanes."""
    from inspektor_gadget_tpu_torch.history import HISTORY

    def run(extra: dict, store) -> list[str]:
        inst = _port_instance({"history": "true", "history-interval": "0",
                               "history-dir": str(store), "invertible": "true",
                               "quantiles": "true", **extra})
        for i, b in enumerate(batches):
            inst.enrich_batch(_port_batch(b))
            if i % 4 == 2:
                inst.harvest()
        inst.post_gadget_run()
        return [h["digest"] for h, _ in HISTORY.fetch_windows(base_dir=str(store))]

    want = run({}, tmp_path / "unsharded")
    assert len(want) == 3  # two harvests and the final one
    assert run({"shard-ingest": "true", "chips": "2"}, tmp_path / "sharded") == want


def test_chips_one_is_the_exact_unsharded_path(lanes8, batches):
    ref, one = _port_instance({}), _port_instance({"shard-ingest": "true", "chips": "1"})
    assert not one._shard_on and one._sharded is None and one._mesh is None
    for b in batches:
        ref.enrich_batch(_port_batch(b))
        one.enrich_batch(_port_batch(b))
    assert one._pool is not None and not one._lane_pools
    _same(one.harvest(), ref.harvest())
    ref.post_gadget_run()
    one.post_gadget_run()


def test_ingest_folded_rides_the_sharded_lanes(lanes8):
    """`folded_block()` hands out the next lane's pinned block; the
    absorbed total matches an odd count of batches (the last round
    flushed with a filler)."""
    inst = _port_instance({"shard-ingest": "true", "chips": "2"})
    total = 0
    for i in range(5):
        lane = inst._next_lane
        block = inst.folded_block()
        assert block.shape[1] == inst._lane_pools[lane].capacity
        n = 200 + i
        arr = block.numpy()
        arr[0, :n] = np.arange(1, n + 1, dtype=np.uint32)
        arr[1, :n] = 1
        inst.ingest_folded(FoldedBatch(lanes=arr, count=n, block=block))
        total += n
    assert inst.harvest().events == total
    inst.post_gadget_run()


def test_sharded_harvest_under_ingest_pressure(lanes8):
    """Harvests flush the open round with fillers from this thread while
    a pump thread keeps staging batches onto the lanes: no error, events
    never go back, and they grow."""
    inst = _port_instance({"shard-ingest": "true", "chips": "4"})
    src = PySyntheticSource(seed=11, vocab=40, batch_size=BATCH)
    stop = threading.Event()
    errors: list = []

    def pump():
        try:
            while not stop.is_set():
                inst.enrich_batch(src.generate(BATCH))
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)

    t = threading.Thread(target=pump)
    t.start()
    harvests, last = 0, -1
    try:
        deadline = time.monotonic() + 1.5
        while time.monotonic() < deadline:
            s = inst.harvest()
            assert s.events >= last
            last, harvests = s.events, harvests + 1
    finally:
        stop.set()
        t.join(timeout=30.0)
    assert not t.is_alive() and not errors, errors
    assert harvests > 0 and last > 0
    inst.post_gadget_run()


def test_sharded_checkpoint_holds_the_merged_bundle(lanes8, batches, tmp_path):
    """The checkpoint of a sharded run is the merged bundle: a fresh
    unsharded instance resumes from it to the sharded run's state."""
    P.set_checkpoint_dir(tmp_path)
    try:
        inst = _port_instance({"shard-ingest": "true", "chips": "4"})
        for b in batches[:7]:
            inst.enrich_batch(_port_batch(b))
        inst.checkpoint()
        with inst._bundle_mu:
            want = S.bundle_to_numpy(inst._merged_locked())
        inst.post_gadget_run()
        resumed = _port_instance({})
        got = S.bundle_to_numpy(resumed.bundle)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        resumed.post_gadget_run()
    finally:
        P.set_checkpoint_dir(None)


# -- validation: typed errors before the first batch -----------------------------------

def test_shard_ingest_on_one_device_host_is_a_param_error():
    """Unpatched, a CPU instance sees one device: the reference's 1-device
    message."""
    with pytest.raises(ParamError, match=">= 2 local devices") as e:
        _port_instance({"shard-ingest": "true"})
    assert "this host exposes 1 device" in str(e.value)


def test_chips_beyond_local_devices_is_a_param_error(lanes8):
    with pytest.raises(ParamError, match="exceeds the 8 local device"):
        _port_instance({"shard-ingest": "true", "chips": "99"})
    with pytest.raises(ParamError, match="exceeds"):
        _port_instance({"chips": "99"})


def test_non_divisible_batch_size_is_a_param_error(lanes8):
    with pytest.raises(ParamError, match="not divisible"):
        _port_instance({"shard-ingest": "true", "chips": "3"},
                       gadget_params={"batch-size": "1000"})


def test_chips_param_rejects_garbage_loudly():
    with pytest.raises(ParamError, match="integer or 'auto'"):
        _port_instance({"chips": "banana"})
    with pytest.raises(ParamError, match=">= 1"):
        _port_instance({"chips": "0"})


def test_ig_shard_disable_escape_hatch(monkeypatch, batches):
    monkeypatch.setenv("IG_SHARD_DISABLE", "1")
    inst = _port_instance({"shard-ingest": "true", "chips": "4"})
    assert not inst._shard_on
    inst.enrich_batch(_port_batch(batches[0]))
    assert inst._sharded is None and inst._pool is not None
    inst.post_gadget_run()
    inst2 = _port_instance({"shard-ingest": "true", "chips": "99"})
    assert not inst2._shard_on
    inst2.post_gadget_run()
