"""The port's accuracy plane (`ops/accuracy.py`) and priority classes
(`ops/invertible.py`) against the JAX package's, on numpy-seeded inputs.

Everything here is host numpy arithmetic in both packages, so the
results must be equal exactly: shadow-sample lanes with their dtypes,
estimator values, accuracy blocks, parsed classes and their messages,
and per-class weight vectors.
"""

from __future__ import annotations

import numpy as np
import pytest

from inspektor_gadget_tpu.ops import accuracy as RA
from inspektor_gadget_tpu.ops import invertible as RI
from inspektor_gadget_tpu_torch.ops import accuracy as PA
from inspektor_gadget_tpu_torch.ops import invertible as PI
from inspektor_gadget_tpu_torch.telemetry import REGISTRY


def _stream(seed: int, n: int, vocab: int):
    rng = np.random.default_rng(seed)
    keys = np.minimum(rng.zipf(1.3, n), vocab).astype(np.uint32) * np.uint32(2654435761)
    return keys, rng.integers(1, 5, n).astype(np.int64)


def _same_sample(p, r) -> None:
    assert p.capacity == r.capacity
    for a, b in ((p.keys, r.keys), (p.weights, r.weights)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("capacity, vocab", [(64, 40), (64, 5000), (256, 300)])
def test_shadow_sample_matches_the_reference(capacity, vocab):
    keys, w = _stream(capacity + vocab, 6000, vocab)
    p, r = PA.ShadowSample(capacity), RA.ShadowSample(capacity)
    for lo in range(0, 6000, 1000):  # batch by batch, weights on every other batch
        ww = w[lo:lo + 1000] if lo % 2000 else None
        p.update(keys[lo:lo + 1000], ww)
        r.update(keys[lo:lo + 1000], ww)
    _same_sample(p, r)
    assert np.array_equal(PA.shadow_priorities(keys), RA.shadow_priorities(keys))
    assert p.full == r.full and p.threshold() == r.threshold()
    assert p.distinct_estimate() == r.distinct_estimate()
    assert p.entropy_estimate(8000.0) == r.entropy_estimate(8000.0)
    hk, hc = keys[:20], np.arange(20) * 7
    assert p.observed_hh_err(hk, hc, 6000.0) == r.observed_hh_err(hk, hc, 6000.0)
    # merge of two halves equals the single pass, in both packages
    a, b = PA.ShadowSample(capacity), PA.ShadowSample(capacity)
    a.update(keys[:3000], w[:3000])
    b.update(keys[3000:], w[3000:])
    ra, rb = RA.ShadowSample(capacity), RA.ShadowSample(capacity)
    ra.update(keys[:3000], w[:3000])
    rb.update(keys[3000:], w[3000:])
    _same_sample(a.merge(b), ra.merge(rb))
    _same_sample(a.copy(), ra.copy())
    a.reset()
    assert len(a) == 0 and a.keys.dtype == np.uint32


@pytest.mark.parametrize("audited", [False, True])
def test_accuracy_block_matches_the_reference(audited):
    keys, w = _stream(3, 4000, 700)
    kw = dict(events=4000.0, depth=4, width=1 << 12, hll_p=10, ent_log2_width=8,
              distinct=612.5, entropy_bits=7.25, hh_keys=keys[:16],
              hh_counts=np.arange(16, dtype=np.int64) * 40, qt_alpha=0.01)
    shadows = [None, None]
    if audited:
        shadows = [PA.ShadowSample(128), RA.ShadowSample(128)]
        for s in shadows:
            s.update(keys, w)
    got = PA.accuracy_block(**kw, shadow=shadows[0])
    want = RA.accuracy_block(**kw, shadow=shadows[1])
    assert got == want and got["audited"] == audited
    assert PA.accuracy_ratio(got) == RA.accuracy_ratio(want)
    assert PA.accuracy_ratio(None) == 0.0


@pytest.mark.parametrize("args", [(4, 65536, 1e6), (1, 1, 0.0), (3, 1024, 12345.5)])
def test_bounds_match_the_reference(args):
    assert PA.cms_bound(*args) == RA.cms_bound(*args)
    for p, est in ((8, 100.0), (8, 10_000.0), (14, None), (8, 640.0)):
        assert PA.hll_bound(p, est) == RA.hll_bound(p, est)
    assert PA.dd_bound(0.02) == RA.dd_bound(0.02)
    for lw, d in ((6, 100.0), (12, 1.0), (12, 0.5)):
        assert PA.entropy_bias_bound(lw, d) == RA.entropy_bias_bound(lw, d)
    assert (PA.HLL_STDERR_CONST, PA.LINEAR_COUNTING_FACTOR) == (
        RA.HLL_STDERR_CONST, RA.LINEAR_COUNTING_FACTOR)


def test_accuracy_stats_feed_the_port_registry():
    stats = PA.AccuracyStats("run-acc", "trace/exec")
    stats.register()
    keys, w = _stream(4, 500, 50)
    s = PA.ShadowSample(32)
    s.update(keys, w)
    stats.note_fed(500)
    block = PA.accuracy_block(events=1500.0, depth=4, width=1024, hll_p=8, ent_log2_width=6,
                              distinct=48.0, entropy_bits=4.0, shadow=s)
    stats.observe_block(block)
    assert stats in PA.live_stats()
    snap = stats.snapshot()
    assert snap["samples_fed"] == 500 and snap["ratio"] == PA.accuracy_ratio(block)
    fam = {f.name: f for f in REGISTRY.families()}
    assert fam["ig_sketch_accuracy_ratio"].value == PA.accuracy_ratio(block)
    stats.unregister()
    assert stats not in PA.live_stats() and fam["ig_sketch_accuracy_ratio"].value == 0.0


# -- priority classes --------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "hot=12:101|102,rest=10:*", "a=9:7,b=8:8|9,c=6:*", "only=6:*",
    "gibberish", "a=12:1,a=10:*", "a=12:7,b=10:7|8,c=9:*", "a=12:7", "a=12:*,b=10:*",
    "a=99:*", "a=xx:*", "a=12:", "", "a=12:1,,b=8:*", "=8:*", "a=8", "a=8:x|*",
])
def test_parse_priority_classes_matches_the_reference(spec):
    try:
        want = RI.parse_priority_classes(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            PI.parse_priority_classes(spec)
        assert str(got.value) == str(e)
        return
    got = PI.parse_priority_classes(spec)
    assert [(c.name, c.log2_buckets, c.tenants, c.is_default) for c in got] == [
        (c.name, c.log2_buckets, c.tenants, c.is_default) for c in want]


@pytest.mark.parametrize("spec, rows, lb", [
    ("hot=9:101,rest=8:*", 3, 10), ("hot=9:101,rest=9:*", 3, 9), ("a=12:1,b=12:*", 2, 12),
    ("a=11:1,b=11:2,c=11:*", 4, 12)])
def test_class_budget_matches_the_reference(spec, rows, lb):
    try:
        RI.validate_class_budget(RI.parse_priority_classes(spec), rows=rows, log2_buckets=lb)
        want = None
    except ValueError as e:
        want = str(e)
    try:
        PI.validate_class_budget(PI.parse_priority_classes(spec), rows=rows, log2_buckets=lb)
        got = None
    except ValueError as e:
        got = str(e)
    assert got == want
    assert PI.inv_bytes(rows, lb) == RI.inv_bytes(rows, lb)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_class_weights_match_the_reference(dtype):
    rng = np.random.default_rng(9)
    mntns = rng.choice([101, 102, 103, 104], 2000).astype(dtype)
    w = rng.integers(0, 4, 2000).astype(np.uint32)
    spec = "hot=9:101|103,mid=8:104,rest=7:*"
    got = PI.class_weights(PI.parse_priority_classes(spec), mntns, w)
    want = RI.class_weights(RI.parse_priority_classes(spec), mntns, w)
    assert len(got) == len(want) == 3
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and np.array_equal(g, x)
    assert np.array_equal(sum(g.astype(np.int64) for g in got), w.astype(np.int64))
