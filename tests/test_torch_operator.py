"""The port's tpusketch operator (`TpuSketchInstance`) against the
reference operator's instance, both on the CPU.

The reference is built as the JAX package's own operator tests build it
(`GadgetContext` + `instantiate`, harvest-interval 1h, small geometry:
depth 3, log2-width 10, hll-p 8, entropy 6, top-k 8). Both instances
take the same numpy-seeded batches through `ingest_folded` and
`enrich_batch` and harvest at the same points. Every summary field but
`pipeline` must be equal: integers, keys and decodes exactly; the HLL
and entropy estimates and the accuracy figures derived from them to
rtol 1e-4 (float32 sums taken in another order); the anomaly scores to
PERF.md §2's tolerance (ae and vae 5% of each score, seq 0.05 nats).
Every sealed window must have the reference's `window_digest` and its
`encode_window` header and payload bytes (the npz's zip entries carry
the wall clock, pinned here). Checkpoints resume across the packages in
both directions. Batches stay in the parity regime of PERF.md §1 (a
batch's weight sum below 2**24).
"""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
from inspektor_gadget_tpu.gadgets import GadgetContext, get
from inspektor_gadget_tpu.history import HISTORY
from inspektor_gadget_tpu.history import encode_window as ref_encode_window
from inspektor_gadget_tpu.operators import tpusketch as R
from inspektor_gadget_tpu.operators.operators import get as get_op
from inspektor_gadget_tpu.params import ParamError as RefParamError
from inspektor_gadget_tpu.sources.batch import EventBatch as RefEventBatch
from inspektor_gadget_tpu.sources.batch import FoldedBatch as RefFoldedBatch
from inspektor_gadget_tpu_torch.models import vae as PV
from inspektor_gadget_tpu_torch.models.params import (params_from_numpy, scorer_from_leaves,
                                                      scorer_leaves)
from inspektor_gadget_tpu_torch.operators import tpusketch as P
from inspektor_gadget_tpu_torch.ops.sketches import bundle_to_numpy
from inspektor_gadget_tpu_torch.sources.batch import EventBatch, FoldedBatch

torch.set_num_threads(2)

SMALL = {"depth": "3", "log2-width": "10", "hll-p": "8", "entropy-log2-width": "6",
         "topk": "8", "harvest-interval": "1h"}
TENANTS = (101, 102, 103, 104)
CLOCK = 1_700_000_000.0
PINNED_WALL = 1_700_000_123.0
RTOL = 1e-4


@pytest.fixture(autouse=True)
def _release_instances():
    """Drop the instances a test built from both packages' live tables,
    drain their stagers and close the history writers the reference
    instances opened, so no state (the active-store gauge included)
    leaks into other tests."""
    before_r, before_p = set(R._live), set(P._live)
    before_w = set(HISTORY._writers)
    yield
    with HISTORY._mu:
        opened = [HISTORY._writers.pop(k) for k in list(HISTORY._writers) if k not in before_w]
    for w in opened:
        w.close()
    for mod, before in ((R, before_r), (P, before_p)):
        with mod._live_mu:
            fresh = [mod._live.pop(rid) for rid in list(mod._live) if rid not in before]
        for inst in fresh:
            if getattr(inst, "_stager", None) is not None:
                inst._stager.drain()
            inst._pstats.unregister()
            if inst._astats is not None:
                inst._astats.unregister()
            if mod is R:
                inst._stats.unregister()
    R.set_checkpoint_dir(None)
    P.set_checkpoint_dir(None)


class _Clock:
    """The injected history clock: one second a read."""

    def __init__(self):
        self.t = CLOCK

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def _kebab(kw: dict) -> dict:
    """SketchConfig fields as the reference's param strings."""
    def param(k, v):
        if isinstance(v, bool):
            return str(v).lower()
        if k.endswith("interval"):
            return f"{int(v * 1000)}ms"
        return str(v)
    return {k.replace("_", "-"): param(k, v) for k, v in kw.items()}


def _config(kw: dict) -> P.SketchConfig:
    small = dict(depth=3, log2_width=10, hll_p=8, entropy_log2_width=6, topk=8,
                 harvest_interval=3600.0)
    return P.SketchConfig(**{**small, **kw})


def _pair(kw: dict, tmp_path, monkeypatch, run_id: str = "run-1"):
    """(reference instance, port instance, reference windows, port windows)
    for the same config, both on the CPU, windows captured where each
    package seals them."""
    ref_wins: list = []
    monkeypatch.setattr(HISTORY, "append_window",
                        lambda win, writer: ref_wins.append(win) or len(ref_wins))
    desc = get("trace", "exec")
    ctx = GadgetContext(desc, run_id=run_id,
                        extra={"node": "n0", "history_clock": _Clock()})
    op = get_op("tpusketch")
    p = op.instance_params().to_params()
    p.set("enable", "true")
    params = {**SMALL, **_kebab(kw)}
    if kw.get("history"):
        params["history-dir"] = str(tmp_path / "hist")
    for k, v in params.items():
        p.set(k, v)
    ref = op.instantiate(ctx, None, p)
    port_wins: list = []
    pctx = P.SketchContext(gadget="trace/exec", run_id=run_id, node="n0",
                           batch_size=ctx.gadget_params.get("batch-size").as_int(),
                           history_clock=_Clock(),
                           window_sink=lambda h, b: port_wins.append((h, b)))
    port = P.TpuSketchInstance(_config(kw), pctx, device="cpu")
    return ref, port, ref_wins, port_wins


def _carry_scorer(ref, port) -> None:
    """The reference scorer's weights into the port's (Adam state is
    zero on both before the first step)."""
    params_from_numpy(port.scorer, jax.tree.map(np.array, ref.scorer.params))


def _folded(rng, n: int, vocab: int, cap: int, weights: bool):
    """One folded batch's lanes (keys, weights, mntns, values) as uint32."""
    lanes = np.zeros((4, cap), np.uint32)
    ranks = np.minimum(rng.zipf(1.3, n), vocab).astype(np.uint64)
    lanes[0, :n] = ((ranks * np.uint64(0x9E3779B1)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    lanes[0, :n][lanes[0, :n] == 0] = 7
    lanes[1, :n] = rng.integers(1, 4, n) if weights else 1
    lanes[2, :n] = rng.choice(TENANTS, n)
    lanes[3, :n] = rng.integers(0, 5_000_000, n)
    lanes[3, :n:9] = 0
    return lanes


def _feed_folded(ref, port, lanes: np.ndarray, n: int) -> None:
    rb, pb = ref.folded_block(), port.folded_block()
    rb[:4] = lanes
    pb.numpy()[:4] = lanes
    ref.ingest_folded(RefFoldedBatch(lanes=rb, count=n, has_values=True))
    port.ingest_folded(FoldedBatch(lanes=pb.numpy(), count=n, has_values=True, block=pb))


def _event_cols(rng, n: int) -> dict:
    keys = np.minimum(rng.zipf(1.4, n), 300).astype(np.uint64)
    return {
        "key_hash": keys * np.uint64(0x9E3779B97F4A7C15) + np.uint64(1),
        "pid": (np.minimum(rng.zipf(1.2, n), 5000) + 1000).astype(np.uint32),
        "aux2": (rng.integers(0, 40, n) * 977 + 3).astype(np.uint64),
        "aux1": rng.integers(0, 2**33, n).astype(np.uint64),  # past 2**32: saturates
        "mntns": rng.choice(TENANTS, n).astype(np.uint64),
        "kind": rng.integers(0, 4, n).astype(np.uint32),
        "ts": np.full(n, 1_700_000_000_000_000_000, np.uint64),
    }


def _feed_events(ref, port, cols: dict, n: int, drops: int) -> None:
    for cls, inst in ((RefEventBatch, ref), (EventBatch, port)):
        b = cls.alloc(n, with_comm=False)
        for k, v in cols.items():
            b.cols[k][:] = v
        b.count, b.drops = n, drops
        inst.enrich_batch(b)


def _close(got, want, what: str) -> None:
    """Recursive equality: floats to RTOL, everything else exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert np.isclose(got, want, rtol=RTOL, atol=1e-7), f"{what}: {got} != {want}"
    else:
        assert got == want and type(got) is type(want) or \
            (isinstance(got, (int, np.integer)) and got == want), f"{what}: {got!r} != {want!r}"


def _assert_summaries_equal(got: P.SketchSummary, want: R.SketchSummary, model: str) -> None:
    assert got.events == want.events and got.drops == want.drops
    assert np.isclose(got.distinct, want.distinct, rtol=RTOL, atol=0)
    assert np.isclose(got.entropy_bits, want.entropy_bits, rtol=RTOL, atol=0)
    for field in ("heavy_hitters", "epoch", "names", "approx", "decoded", "decoded_only",
                  "inv", "classes", "quantiles"):
        assert getattr(got, field) == getattr(want, field), field
    _close(got.accuracy, want.accuracy, "accuracy")
    if want.anomaly is None:
        assert got.anomaly is None
        return
    assert list(got.anomaly) == list(want.anomaly)
    g = np.array(list(got.anomaly.values()))
    w = np.array(list(want.anomaly.values()))
    if model == "seq":
        assert np.abs(g - w).max() <= 0.05, (g, w)
    else:
        assert (np.abs(g - w) <= 5e-2 * np.abs(w)).all(), (g, w)


def _assert_windows_equal(port_wins, ref_wins) -> None:
    from inspektor_gadget_tpu_torch.history import decode_window, window_digest
    assert len(port_wins) == len(ref_wins) > 0
    for (header, payload), rw in zip(port_wins, ref_wins):
        rh, rp = ref_encode_window(rw)
        assert header["digest"] == rw.digest == window_digest(decode_window(header, payload))
        assert header == rh
        assert payload == rp


# -- the operator, fed both ways ---------------------------------------------------

CASES = {
    "planes off": {},
    "invertible": dict(invertible=True, inv_log2_buckets=8),
    "every plane, ae": dict(invertible=True, inv_log2_buckets=9,
                            priority_classes="hot=8:101|102,rest=7:*", quantiles=True,
                            audit_sample=64, history=True, history_interval=0.0,
                            anomaly=True, anomaly_model="ae"),
    "history by interval, vae": dict(quantiles=True, history=True, history_interval=2.5,
                                     history_slots=4, history_max_slices=5, anomaly=True,
                                     anomaly_model="vae"),
    "seq": dict(anomaly=True, anomaly_model="seq", seq_window=32, audit_sample=16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_operator_matches_the_reference(case, tmp_path, monkeypatch):
    kw = CASES[case]
    model = kw.get("anomaly_model", "")
    if kw.get("history"):
        monkeypatch.setattr(time, "time", lambda: PINNED_WALL)  # the npz entries' clock
    ref, port, ref_wins, port_wins = _pair(
        {**kw, "dist_column": "aux2", "distinct_column": "pid"}, tmp_path, monkeypatch)
    if ref.scorer is not None:
        _carry_scorer(ref, port)
    if model == "vae":
        # the reference's own noise draw each step, fed to the port's step
        def port_step(scorer, x):
            key, _ = jax.random.split(ref.scorer.rng)
            eps = jax.random.normal(key, (x.shape[0], scorer.config.latent_dim))
            return PV.vae_train_step(scorer, x, torch.from_numpy(np.array(eps)))
        monkeypatch.setattr(P, "vae_train_step", port_step)
    rng = np.random.default_rng(list(CASES).index(case))
    cap = port._pad
    for rnd in range(3):
        for i in range(2):
            n = cap - 313 * i
            _feed_folded(ref, port, _folded(rng, n, 400, cap, weights=i == 1), n)
        for i in range(2):
            n = 1500 + 700 * i
            _feed_events(ref, port, _event_cols(rng, n), n, drops=5 * rnd + i)
        _assert_summaries_equal(port.harvest(), ref.harvest(), model)
    if kw.get("history"):
        ref.seal_window()
        port.seal_window()
        _assert_windows_equal(port_wins, ref_wins)
    want = jax.tree.leaves(ref.bundle)
    got = bundle_to_numpy(port.bundle)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w))
    if kw.get("priority_classes"):
        for (_, s), (_, rs) in zip(port._inv_classes, ref._inv_classes):
            assert np.array_equal(s.count.numpy(), np.asarray(rs.count))
            assert np.array_equal(s.keysum.numpy(), np.asarray(rs.keysum).astype(np.int64))


def test_heavy_hitter_rows_match_the_reference(tmp_path, monkeypatch):
    ref, port, _, _ = _pair({}, tmp_path, monkeypatch)
    rng = np.random.default_rng(5)
    _feed_events(ref, port, _event_cols(rng, 3000), 3000, drops=0)
    assert port.heavy_hitter_rows(k=6) == [
        P.HeavyHitterRow(key=r.key, count=r.count, share=r.share)
        for r in ref.heavy_hitter_rows(k=6)]


def test_summary_and_window_hooks_fire(tmp_path, monkeypatch):
    ref, port, ref_wins, port_wins = _pair(dict(history=True, history_interval=0.0),
                                           tmp_path, monkeypatch)
    summaries, announced = [], []
    port.ctx.on_sketch_summary = summaries.append
    port.ctx.on_window_sealed = announced.append
    rng = np.random.default_rng(6)
    _feed_events(ref, port, _event_cols(rng, 2000), 2000, drops=0)
    s = port.harvest()
    assert summaries == [s] and len(announced) == len(port_wins) == 1
    assert announced[0]["digest"] == port_wins[0][0]["digest"]
    assert set(port.last_harvest_ms) == {"digest_decode", "finish", "anomaly", "seal", "total"}
    port.seal_window()  # an empty window is skipped
    assert len(port_wins) == 1


# -- checkpoints across the packages -------------------------------------------

CKPT = dict(invertible=True, inv_log2_buckets=9, priority_classes="hot=8:101,rest=8:*",
            quantiles=True, anomaly=True, anomaly_model="ae")


def _fed_pair(tmp_path, monkeypatch, run_id: str):
    ref, port, _, _ = _pair(CKPT, tmp_path, monkeypatch, run_id)
    _carry_scorer(ref, port)
    rng = np.random.default_rng(7)
    cap = port._pad
    _feed_folded(ref, port, _folded(rng, cap - 5, 300, cap, weights=True), cap - 5)
    _feed_events(ref, port, _event_cols(rng, 2500), 2500, drops=3)
    port.harvest()
    ref.harvest()
    return ref, port


def _class_leaves(inst) -> list[np.ndarray]:
    if isinstance(inst, P.TpuSketchInstance):
        return [x for _, s in inst._inv_classes for x in inst._inv_leaves(s)]
    return [np.asarray(x) for _, s in inst._inv_classes for x in jax.tree.leaves(s)]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_in_the_other_package(writer, tmp_path, monkeypatch):
    ref, port = _fed_pair(tmp_path, monkeypatch, "run-a")
    ckpt = tmp_path / "ckpt"
    R.set_checkpoint_dir(ckpt)
    P.set_checkpoint_dir(ckpt)
    (ref if writer == "reference" else port).checkpoint()
    names = sorted(p.name for p in ckpt.iterdir())
    assert names == ["trace-exec-invclasses.json", "trace-exec-invclasses.npz",
                     "trace-exec-scorer.json", "trace-exec-scorer.npz", "trace-exec.json",
                     "trace-exec.npz"]
    written = [np.asarray(x) for x in jax.tree.leaves(ref.bundle)]
    ref2, port2, _, _ = _pair(CKPT, tmp_path, monkeypatch, "run-b")
    # both resumed from the one file: each bundle is the checkpointed one
    for got, want in ((bundle_to_numpy(port2.bundle), written),
                      ([np.asarray(x) for x in jax.tree.leaves(ref2.bundle)], written)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    for g, w in zip(_class_leaves(port2), _class_leaves(ref2)):
        assert np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64))
    # the scorer's weights, Adam moments and steps came across too
    got = scorer_leaves(port2.scorer)
    want = [np.asarray(x) for x in jax.tree.leaves(ref2.scorer)]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert port2.scorer.steps == int(ref2.scorer.steps) == 1


@pytest.mark.parametrize("family", ["ae", "vae", "seq"])
def test_scorer_leaf_names_label_each_leaf(family):
    """`scorer_leaf_names` names `scorer_leaves`' leaves in their order:
    each parameter by its dotted name, Adam's count and moments, the
    VAE's key, the step count."""
    from inspektor_gadget_tpu_torch.models import (AEConfig, SeqConfig, VAEConfig, ae_init,
                                                   harvest_tick, params_to_numpy,
                                                   scorer_leaf_names, seq_init, vae_init)
    from inspektor_gadget_tpu_torch.models.params import _flatten
    rng = np.random.default_rng(9)
    dims = dict(input_dim=16, hidden_dim=8, latent_dim=4)
    if family == "seq":
        s = seq_init(SeqConfig(vocab=16, d_model=16, n_heads=2, n_layers=1, d_ff=32), seed=1,
                     device="cpu")
        harvest_tick(s, rng.integers(0, 16, (2, 8)).astype(np.int32), "full")
    else:
        init, cfg = (vae_init, VAEConfig) if family == "vae" else (ae_init, AEConfig)
        s = init(cfg(**dims), seed=1, device="cpu")
        harvest_tick(s, rng.integers(0, 9, (4, 16)).astype(np.float32), "full")
    names, leaves = scorer_leaf_names(s), scorer_leaves(s)
    assert len(names) == len(set(names)) == len(leaves)
    by_name = dict(zip(names, leaves))
    params = _flatten(params_to_numpy(s))
    assert set(names[:len(params)]) == set(params)
    for n, p in params.items():
        assert np.array_equal(by_name[n], p)
        assert by_name[f"mu.{n}"].shape == by_name[f"nu.{n}"].shape == p.shape
        assert (by_name[f"nu.{n}"] >= 0).all()
    assert int(by_name["count"]) == int(by_name["steps"]) == 1 and names[-1] == "steps"
    assert ("key" in by_name) == (family == "vae")


def test_scorer_leaves_round_trip():
    """`scorer_from_leaves(scorer_leaves(s))` is the identity, for each
    family, and the AE/VAE layout is the reference scorer's."""
    from inspektor_gadget_tpu.models import autoencoder as RA, vae as RV
    from inspektor_gadget_tpu_torch.models import (AEConfig, SeqConfig, VAEConfig, ae_init,
                                                   harvest_tick, seq_init, vae_init)
    dims = dict(input_dim=16, hidden_dim=8, latent_dim=4)
    rng = np.random.default_rng(8)
    counts = rng.integers(0, 9, (4, 16)).astype(np.float32)
    for init, cfg, ref in ((ae_init, AEConfig(**dims), RA.ae_init(RA.AEConfig(**dims))),
                           (vae_init, VAEConfig(**dims), RV.vae_init(RV.VAEConfig(**dims)))):
        a, b = init(cfg, seed=1, device="cpu"), init(cfg, seed=2, device="cpu")
        harvest_tick(a, counts, "full")
        leaves = scorer_leaves(a)
        want = jax.tree.leaves(ref)
        assert [(x.shape, x.dtype) for x in leaves] == [
            (np.asarray(w).shape, np.asarray(w).dtype) for w in want]
        scorer_from_leaves(b, leaves)
        assert all(np.array_equal(x, y) for x, y in zip(scorer_leaves(b), leaves))
    seq_cfg = SeqConfig(vocab=16, d_model=16, n_heads=2, n_layers=1, d_ff=32)
    a, b = seq_init(seq_cfg, seed=1, device="cpu"), seq_init(seq_cfg, seed=2, device="cpu")
    harvest_tick(a, rng.integers(0, 16, (2, 8)).astype(np.int32), "full")
    scorer_from_leaves(b, scorer_leaves(a))
    assert all(np.array_equal(x, y) for x, y in zip(scorer_leaves(b), scorer_leaves(a)))


def test_a_torn_checkpoint_means_fresh_state(tmp_path, caplog):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "trace-exec.npz").write_bytes(b"not a zip")
    P.set_checkpoint_dir(ckpt)
    inst = P.TpuSketchInstance(_config({}), P.SketchContext(), device="cpu")
    assert float(inst.bundle.events) == 0.0
    assert "resume of trace-exec skipped" in caplog.text


# -- configuration errors ------------------------------------------------------------


@pytest.mark.parametrize("kw, match", [
    (dict(priority_classes="hot=9:101,rest=8:*"), "needs 'invertible true'"),
    (dict(invertible=True, inv_log2_buckets=9, priority_classes="hot=9:101,rest=9:*"),
     "budgets"),
    (dict(quantile_alpha=0.05), "needs 'quantiles true'"),
    (dict(quantile_field="aux2"), "needs 'quantiles true'"),
    (dict(quantiles=True, quantile_field="nope"), "is not a wire column"),
])
def test_cross_param_errors_match_the_reference(kw, match, tmp_path, monkeypatch):
    with pytest.raises(RefParamError, match=match) as ref_err:
        _pair(kw, tmp_path, monkeypatch)
    with pytest.raises(P.ParamError, match=match) as port_err:
        P.TpuSketchInstance(_config(kw), P.SketchContext(), device="cpu")
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("kw, match", [
    (dict(priority_classes="gibberish"), "name=log2buckets"),
    (dict(priority_classes="a=12:*,b=10:*"), "second '\\*' catch-all"),
    (dict(inv_log2_buckets=25), "above maximum 20"),
    (dict(inv_rows=1), "below minimum 2"),
    (dict(audit_sample=-1), "below minimum 0"),
    (dict(quantile_alpha=0.5), "quantile-alpha must be in"),
    (dict(anomaly_model="lstm"), "not one of"),
    (dict(chips="x"), "not an integer or 'auto'"),
    (dict(shard_ingest=True), "ROADMAP item 11"),
    (dict(chips=4), "ROADMAP item 11"),
    (dict(standing_queries="[]"), "ROADMAP item 10c"),
    (dict(history_compact=True), "ROADMAP item 10c"),
    (dict(history=True), "needs a window_sink"),
])
def test_param_errors(kw, match):
    with pytest.raises(P.ParamError, match=match):
        P.TpuSketchInstance(_config(kw), P.SketchContext(), device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        P.TpuSketchInstance(_config({}), P.SketchContext())
