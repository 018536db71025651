"""Each sketch op of the PyTorch port against the JAX package's.

Update, then merge, then estimate, on the same numpy-seeded inputs.
Integer and integer-valued leaves must match exactly, and so must the
HLL estimate below the large-range correction (XLA's exp2 values, sum
order and log). The other float32 estimates (entropy here, quantiles)
are held to rtol 1e-5: their sums over the buckets run in another order
in XLA and in torch.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inspektor_gadget_tpu.ops import countmin as r_cms
from inspektor_gadget_tpu.ops import entropy as r_ent
from inspektor_gadget_tpu.ops import hll as r_hll
from inspektor_gadget_tpu.ops import invertible as r_inv
from inspektor_gadget_tpu.ops import quantiles as r_dd
from inspektor_gadget_tpu.ops import topk as r_topk
from inspektor_gadget_tpu_torch.ops import countmin as p_cms
from inspektor_gadget_tpu_torch.ops import entropy as p_ent
from inspektor_gadget_tpu_torch.ops import hll as p_hll
from inspektor_gadget_tpu_torch.ops import invertible as p_inv
from inspektor_gadget_tpu_torch.ops import quantiles as p_dd
from inspektor_gadget_tpu_torch.ops import topk as p_topk

CPU = "cpu"
RTOL = 1e-5


def _eq(port_t, ref_a):
    a = np.asarray(ref_a)
    b = port_t.detach().numpy()
    if a.dtype == np.uint32:
        b = b.astype(np.uint32)
    return a.shape == b.shape and np.array_equal(b.astype(a.dtype), a) and \
        np.array_equal(b.astype(np.float64), a.astype(np.float64))


def _batch(rng, n, vocab=None, weights=(0, 1, 3)):
    if vocab is None:
        keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    else:
        keys = rng.integers(1, vocab, n).astype(np.uint32) * np.uint32(2654435761)
    w = rng.choice(np.array(weights, np.int32), n)
    return keys, w


@pytest.mark.parametrize("depth,log2_width,n", [(2, 6, 256), (4, 10, 1024), (5, 12, 2048)])
def test_countmin_update_merge_query(depth, log2_width, n):
    rng = np.random.default_rng(depth)
    ra, rb = r_cms.cms_init(depth, log2_width), r_cms.cms_init(depth, log2_width)
    pa, pb = p_cms.cms_init(depth, log2_width, device=CPU), p_cms.cms_init(depth, log2_width, device=CPU)
    for _ in range(2):
        k, w = _batch(rng, n, vocab=300)
        ra = r_cms.cms_update(ra, jnp.asarray(k), jnp.asarray(w))
        p_cms.cms_update(pa, torch.from_numpy(k), torch.from_numpy(w))
        k2, _ = _batch(rng, n)
        rb = r_cms.cms_update(rb, jnp.asarray(k2))
        p_cms.cms_update(pb, torch.from_numpy(k2))
    assert _eq(pa.table, ra.table) and _eq(pa.total, ra.total)
    rm, pm = r_cms.cms_merge(ra, rb), p_cms.cms_merge(pa, pb)
    assert _eq(pm.table, rm.table) and _eq(pm.total, rm.total)
    q, _ = _batch(rng, 512, vocab=300)
    assert _eq(p_cms.cms_query(pm, torch.from_numpy(q)), r_cms.cms_query(rm, jnp.asarray(q)))


@pytest.mark.parametrize("p,n", [(6, 256), (10, 1024), (12, 2048)])
def test_hll_update_merge_estimate(p, n):
    rng = np.random.default_rng(p)
    ra, rb = r_hll.hll_init(p), r_hll.hll_init(p)
    pa, pb = p_hll.hll_init(p, device=CPU), p_hll.hll_init(p, device=CPU)
    for _ in range(3):
        k, w = _batch(rng, n)
        ra = r_hll.hll_update(ra, jnp.asarray(k), jnp.asarray(w))
        p_hll.hll_update(pa, torch.from_numpy(k), torch.from_numpy(w))
        k2, _ = _batch(rng, n)
        rb = r_hll.hll_update(rb, jnp.asarray(k2))
        p_hll.hll_update(pb, torch.from_numpy(k2))
    assert _eq(pa.registers, ra.registers)
    rm, pm = r_hll.hll_merge(ra, rb), p_hll.hll_merge(pa, pb)
    assert _eq(pm.registers, rm.registers)
    for r, q in ((ra, pa), (rm, pm), (r_hll.hll_init(p), p_hll.hll_init(p, device=CPU))):
        assert float(p_hll.hll_estimate(q)) == float(r_hll.hll_estimate(r))


def test_xla_exp2_table_is_the_reference_s():
    """The estimate's exp2(-rank) values are XLA's CPU float32 output at
    every rank a register can hold (they miss the exact power of two by
    up to 34 ulps from rank 13 up)."""
    ranks = np.arange(65, dtype=np.float32)
    want = np.asarray(jax.jit(lambda r: jnp.exp2(-r))(jnp.asarray(ranks)))
    assert p_hll._XLA_EXP2_NEG.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    assert not np.array_equal(want, np.exp2(-ranks))


@pytest.mark.parametrize("p", [4, 8, 12, 14, 16])
@pytest.mark.parametrize("regime", ["linear counting", "raw"])
def test_hll_estimate_is_bit_identical_to_the_reference(p, regime):
    """Register states of both regimes below the large-range correction:
    linear counting (empty registers, XLA's log) and the raw estimate
    (XLA's exp2 values summed in XLA's order). A one-ulp difference at
    p 14 (2010.455810546875 against 2010.4556884765625, linear counting)
    made a journal recorded on the card fail the reference's replay
    --verify."""
    rng = np.random.default_rng(p)
    m = 1 << p
    for trial in range(25):
        regs = (rng.geometric(0.5, m) + rng.integers(0, 8)).clip(max=33 - p).astype(np.int32)
        if regime == "linear counting":
            regs[rng.random(m) < rng.uniform(0.3, 0.995)] = 0
            regs[0] = 0
        r = r_hll.HLL(registers=jnp.asarray(regs), p=p)
        q = p_hll.HLL(registers=torch.from_numpy(regs), p=p)
        want = float(r_hll.hll_estimate(r))
        assert want <= 2**32 / 30
        assert float(p_hll.hll_estimate(q)) == want, (trial, want)


def test_hll_estimate_is_bit_identical_across_the_large_range_correction():
    """Register states at p 14 whose estimates span 2**32 / 30 to past
    2**32: the correction's log1p is XLA's (`xla_log1pf`), both of its
    branches, and its NaN past 2**32 keeps the reference's bits."""
    p, m = 14, 1 << 14
    rng = np.random.default_rng(37)
    seen = {"below": 0, "small branch": 0, "log branch": 0, "past 2**32": 0}
    for trial in range(160):
        mean = 11.0 + 9.0 * trial / 160
        regs = np.clip(np.round(rng.normal(mean, 1.2, m)), 1, 33 - p).astype(np.int32)
        r = r_hll.HLL(registers=jnp.asarray(regs), p=p)
        q = p_hll.HLL(registers=torch.from_numpy(regs), p=p)
        want = np.float32(r_hll.hll_estimate(r))
        got = np.float32(p_hll.hll_estimate(q).item())
        assert got.view(np.uint32) == want.view(np.uint32), (trial, want, got)
        if np.isnan(want):
            seen["past 2**32"] += 1
        elif want <= 2**32 / 30:
            seen["below"] += 1
        elif want < 0.5 * 2**32:  # -log1p(-x) * 2**32 with |x| < sqrt(2) - 1
            seen["small branch"] += 1
        else:
            seen["log branch"] += 1
    assert min(seen.values()) >= 5, seen


def test_hll_rank_covers_every_leading_zero_count():
    """Keys whose hashes have 0..32-p leading zeros below the index."""
    p = 8
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 2**32, 1 << 16, dtype=np.uint32)
    r = r_hll.hll_update(r_hll.hll_init(p), jnp.asarray(keys))
    q = p_hll.hll_update(p_hll.hll_init(p, device=CPU), torch.from_numpy(keys))
    assert _eq(q.registers, r.registers)
    assert int(q.registers.max()) >= 12


@pytest.mark.parametrize("log2_width,n", [(6, 256), (10, 1024), (12, 2048)])
def test_entropy_update_merge_estimate(log2_width, n):
    rng = np.random.default_rng(log2_width)
    ra, rb = r_ent.entropy_init(log2_width), r_ent.entropy_init(log2_width)
    pa = p_ent.entropy_init(log2_width, device=CPU)
    pb = p_ent.entropy_init(log2_width, device=CPU)
    for _ in range(3):
        k, w = _batch(rng, n, vocab=200)
        ra = r_ent.entropy_update(ra, jnp.asarray(k), jnp.asarray(w, jnp.float32))
        p_ent.entropy_update(pa, torch.from_numpy(k), torch.from_numpy(w))
        k2, _ = _batch(rng, n)
        rb = r_ent.entropy_update(rb, jnp.asarray(k2))
        p_ent.entropy_update(pb, torch.from_numpy(k2))
    assert _eq(pa.counts, ra.counts)
    rm, pm = r_ent.entropy_merge(ra, rb), p_ent.entropy_merge(pa, pb)
    assert _eq(pm.counts, rm.counts)
    for r, q in ((ra, pa), (rm, pm)):
        assert np.isclose(float(p_ent.entropy_estimate(q)), float(r_ent.entropy_estimate(r)),
                          rtol=RTOL, atol=0)


def test_entropy_update_refuses_float_weights():
    st = p_ent.entropy_init(6, device=CPU)
    with pytest.raises(TypeError):
        p_ent.entropy_update(st, torch.zeros(4, dtype=torch.int32), torch.ones(4))


def _cms_pair(depth, log2_width, keys, w):
    r = r_cms.cms_update(r_cms.cms_init(depth, log2_width), jnp.asarray(keys), jnp.asarray(w))
    p = p_cms.cms_update(p_cms.cms_init(depth, log2_width, device=CPU),
                         torch.from_numpy(keys), torch.from_numpy(w))
    return r, p


def _topk_eq(p, r):
    return (_eq(p.keys, r.keys) and _eq(p.counts, r.counts)
            and _eq(p.overflow, r.overflow))


@pytest.mark.parametrize("k,vocab", [(8, 6), (16, 40), (32, 2000)])
def test_topk_update_and_merge(k, vocab):
    rng = np.random.default_rng(k)
    ra, rb = r_topk.topk_init(k), r_topk.topk_init(k)
    pa, pb = p_topk.topk_init(k, device=CPU), p_topk.topk_init(k, device=CPU)
    keys_all, w_all = [], []
    for _ in range(3):
        keys, w = _batch(rng, 512, vocab=vocab)
        keys_all.append(keys)
        w_all.append(w)
        rc, pc = _cms_pair(3, 10, np.concatenate(keys_all), np.concatenate(w_all))
        ra = r_topk.topk_update(ra, rc, jnp.asarray(keys), jnp.asarray(w))
        pa = p_topk.topk_update(pa, pc, torch.from_numpy(keys), torch.from_numpy(w))
        assert _topk_eq(pa, ra)
        k2, _ = _batch(rng, 256, vocab=vocab)
        rc2, pc2 = _cms_pair(3, 10, k2, np.ones(256, np.int32))
        rb = r_topk.topk_update(rb, rc2, jnp.asarray(k2))
        pb = p_topk.topk_update(pb, pc2, torch.from_numpy(k2))
        assert _topk_eq(pb, rb)
    assert _topk_eq(p_topk.topk_merge(pa, pb), r_topk.topk_merge(ra, rb))
    assert _topk_eq(p_topk.topk_merge(pa, pb, pc), r_topk.topk_merge(ra, rb, rc))


def test_topk_many_ties_and_duplicates():
    """More than k keys with equal counts, plus duplicate keys and empty
    slots: the kept keys, their order and counts must be the
    reference's."""
    k = 16
    rng = np.random.default_rng(11)
    keys = rng.permutation(np.arange(1, 61, dtype=np.uint32) * np.uint32(977))
    keys = np.concatenate([keys, keys[:25], np.zeros(7, np.uint32), keys[5:9]])
    counts = np.full(keys.shape, 7, np.int32)
    counts[-4:] = 9                       # duplicates carrying a larger count
    counts[60:70] = 3                     # duplicates carrying a smaller count
    counts[keys == 0] = -1
    ov = np.zeros((), np.int32)
    r = r_topk._dedupe_topk(jnp.asarray(keys), jnp.asarray(counts), k, jnp.asarray(ov))
    p = p_topk._dedupe_topk(torch.from_numpy(keys.astype(np.int64)),
                            torch.from_numpy(counts), k, torch.from_numpy(ov))
    assert _topk_eq(p, r)
    assert int(p.overflow) == 1
    # the same through topk_update with a CMS under which all keys tie
    cms_keys = np.repeat(np.arange(1, 41, dtype=np.uint32) * np.uint32(7919), 5)
    rc, pc = _cms_pair(2, 16, cms_keys, np.ones(cms_keys.shape, np.int32))
    batch = np.concatenate([cms_keys[::-1], np.zeros(9, np.uint32)])
    ru = r_topk.topk_update(r_topk.topk_init(k), rc, jnp.asarray(batch))
    pu = p_topk.topk_update(p_topk.topk_init(k, device=CPU), pc, torch.from_numpy(batch))
    assert _topk_eq(pu, ru)


@pytest.mark.parametrize("rows,log2b,n", [(2, 6, 256), (3, 9, 1024), (3, 12, 2048)])
def test_invertible_update_and_merge(rows, log2b, n):
    rng = np.random.default_rng(rows * 100 + log2b)
    ra, rb = r_inv.inv_init(rows, log2b), r_inv.inv_init(rows, log2b)
    pa, pb = p_inv.inv_init(rows, log2b, device=CPU), p_inv.inv_init(rows, log2b, device=CPU)
    for _ in range(3):
        k, w = _batch(rng, n)
        ra = r_inv.inv_update(ra, jnp.asarray(k), jnp.asarray(w))
        p_inv.inv_update(pa, torch.from_numpy(k), torch.from_numpy(w))
        k2, _ = _batch(rng, n, vocab=50)
        rb = r_inv.inv_update(rb, jnp.asarray(k2))
        p_inv.inv_update(pb, torch.from_numpy(k2))
    for lane in ("count", "keysum", "fpsum"):
        assert _eq(getattr(pa, lane), getattr(ra, lane)), lane
    rm, pm = r_inv.inv_merge(ra, rb), p_inv.inv_merge(pa, pb)
    for lane in ("count", "keysum", "fpsum"):
        assert _eq(getattr(pm, lane), getattr(rm, lane)), lane
    k = _batch(rng, 64)[0]
    assert _eq(p_inv.inv_fingerprint(torch.from_numpy(k)), r_inv.inv_fingerprint(jnp.asarray(k)))


def _boundary_values(alpha, min_value, n_max=1200):
    """Integer values on, and one or two away from, gamma**i boundaries,
    plus 0 and random values across the uint32 range."""
    g = (1 + alpha) / (1 - alpha)
    b = np.array([g ** i * max(min_value, 1.0) for i in range(n_max)])
    rng = np.random.default_rng(17)
    v = np.concatenate([np.floor(b) + d for d in (-2, -1, 0, 1, 2)]
                       + [rng.integers(0, 2**32, 4096).astype(np.float64),
                          np.arange(0, 4096, dtype=np.float64), [0.0, 2.0**32 - 1]])
    return np.unique(np.clip(v, 0, 2.0**32 - 1)).astype(np.uint32)


@pytest.mark.parametrize("min_value", [1.0, 1e-9])
def test_bucket_index_matches_on_gamma_boundaries(min_value):
    st = r_dd.dd_init(alpha=0.01, n_buckets=2048, min_value=min_value)
    vals = _boundary_values(0.01, min_value)
    want = np.asarray(jax.jit(lambda v: r_dd._bucket_index(st, v))(vals))
    got = p_dd.bucket_index(torch.from_numpy(vals), alpha=0.01, min_value=min_value,
                            n_buckets=2048).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    # float values (latencies in seconds) around boundaries below 1
    g = st.gamma
    fv = np.concatenate([np.float32(g) ** np.arange(-900, 0, dtype=np.float32),
                         np.random.default_rng(3).uniform(0, 2, 4096)]).astype(np.float32)
    fv = np.concatenate([fv, np.nextafter(fv, np.float32(0)), np.nextafter(fv, np.float32(9))])
    want = np.asarray(jax.jit(lambda v: r_dd._bucket_index(st, v))(fv))
    got = p_dd.bucket_index(torch.from_numpy(fv), alpha=0.01, min_value=min_value,
                            n_buckets=2048).numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("min_value,kind", [(1.0, "ns"), (1e-9, "seconds")])
def test_bucket_index_sweep_matches_jax(min_value, kind):
    """A dense sweep: every uint32 value below 2**20 and 2**20 random ones
    (the bundle's value lane), or 2**21 random positive float32 bit
    patterns (latencies in seconds)."""
    st = r_dd.dd_init(alpha=0.01, n_buckets=2048, min_value=min_value)
    rng = np.random.default_rng(41)
    if kind == "ns":
        vals = np.concatenate([np.arange(1 << 20, dtype=np.uint32),
                               rng.integers(0, 2**32, 1 << 20, dtype=np.uint32)])
    else:
        vals = rng.integers(0, 0x7F800000, 1 << 21, dtype=np.uint32).view(np.float32)
    want = np.asarray(jax.jit(lambda v: r_dd._bucket_index(st, v))(vals))
    got = p_dd.bucket_index(torch.from_numpy(vals.view(np.int32) if kind == "ns" else vals),
                            alpha=0.01, min_value=min_value, n_buckets=2048).numpy()
    assert np.array_equal(got, want.astype(np.int64))


def test_xla_logf_is_bit_identical_to_jax_log():
    rng = np.random.default_rng(23)
    x = np.concatenate([np.arange(1, 1 << 16, dtype=np.float32),
                        rng.integers(1, 2**32, 1 << 16).astype(np.float32),
                        rng.uniform(1e-30, 1.0, 1 << 14).astype(np.float32),
                        np.float32([1.1754944e-38, 3.4028235e38, 0.70710677, 0.7071068])])
    want = np.asarray(jax.jit(jnp.log)(x))
    got = p_dd.xla_logf(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_xla_log1pf_is_bit_identical_to_jax_log1p():
    """float32 in [-1, 0), dense around the branch threshold |x| =
    sqrt(2) - 1, with the special values: XLA's CPU log1p bit for bit."""
    rng = np.random.default_rng(41)
    thr = np.float32(float.fromhex("0x1.a8279ap-2")).view(np.int32)
    around = (thr + np.arange(-(1 << 14), 1 << 14, dtype=np.int32)).view(np.float32)
    x = np.concatenate([rng.uniform(-1, 0, 1 << 18).astype(np.float32),
                        -rng.uniform(0, 1e-3, 1 << 14).astype(np.float32),
                        -around, around,
                        np.float32([-1.0, -0.0, 0.0, -1e-30, -2.0, np.inf, -np.inf, np.nan])])
    want = np.asarray(jax.jit(jnp.log1p)(x))
    got = p_dd.xla_log1pf(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(29)
    a = rng.standard_normal(4096).astype(np.float32)
    b = rng.standard_normal(4096).astype(np.float32)
    c = rng.standard_normal(4096).astype(np.float32) * np.float32(1e-6)
    from fractions import Fraction
    got = p_dd.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(0, 4096, 64):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(-np.inf)), np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda f: abs(Fraction(float(f)) - exact))
        assert got[i] == best, i


@pytest.mark.parametrize("min_value,kind", [(1e-9, "seconds"), (1.0, "ns")])
def test_ddsketch_update_merge_quantile(min_value, kind):
    rng = np.random.default_rng(31)
    ra = r_dd.dd_init(alpha=0.01, n_buckets=2048, min_value=min_value)
    rb = r_dd.dd_init(alpha=0.01, n_buckets=2048, min_value=min_value)
    pa = p_dd.dd_init(alpha=0.01, n_buckets=2048, min_value=min_value, device=CPU)
    pb = p_dd.dd_init(alpha=0.01, n_buckets=2048, min_value=min_value, device=CPU)
    for _ in range(3):
        if kind == "seconds":
            v = rng.lognormal(-7, 2, 1024).astype(np.float32)
        else:
            v = rng.lognormal(11, 2, 1024).astype(np.uint32)
        v[::37] = 0
        _, w = _batch(rng, 1024)
        ra = r_dd.dd_update(ra, jnp.asarray(v), jnp.asarray(w))
        p_dd.dd_update(pa, torch.from_numpy(v), torch.from_numpy(w))
        rb = r_dd.dd_update(rb, jnp.asarray(v[::-1].copy()))
        p_dd.dd_update(pb, torch.from_numpy(v[::-1].copy()))
    for lane in ("counts", "zeros", "total"):
        assert _eq(getattr(pa, lane), getattr(ra, lane)), lane
    rm, pm = r_dd.dd_merge(ra, rb), p_dd.dd_merge(pa, pb)
    for lane in ("counts", "zeros", "total"):
        assert _eq(getattr(pm, lane), getattr(rm, lane)), lane
    qs = np.array([0.0, 0.01, 0.5, 0.9, 0.99, 1.0], np.float32)
    for r, p in ((ra, pa), (rm, pm)):
        want = np.asarray(r_dd.dd_quantile(r, qs))
        got = p_dd.dd_quantile(p, qs).numpy()
        assert np.allclose(got, want, rtol=RTOL, atol=0)
    assert math.isnan(float(p_dd.dd_quantile(
        p_dd.dd_init(device=CPU), 0.5)))
