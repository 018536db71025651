"""The slice as a whole: the PyTorch port's staged-ingest step against the
JAX package's, with every plane on.

Several batches (ragged masks, weights in {0, 1, 3}, values on gamma**i
boundaries and 0) go through the port's `bundle_ingest_step` on the CPU,
the reference's `bundle_ingest_step` and its `_bundle_update_pallas`
with the kernel in the Pallas interpreter. Every leaf must match
exactly; the digest's integer words must be byte-identical and its
estimate words agree to rtol 1e-5 (float32 sums in another order).
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inspektor_gadget_tpu.ops import sketches as R
from inspektor_gadget_tpu_torch.ops import sketches as P

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "inspektor_gadget_tpu_torch"
GEOM = dict(depth=3, log2_width=10, hll_p=9, entropy_log2_width=8, k=16,
            inv_rows=3, inv_log2_buckets=9, quantiles=True, quantile_buckets=2048)
RTOL = 1e-5


def _batches(seed, n=512, count=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        hh = (rng.zipf(1.3, n) % 97 + 1).astype(np.uint32) * np.uint32(2654435761)
        distinct = rng.integers(0, 2**32, n, dtype=np.uint32)
        dist = rng.integers(0, 40, n).astype(np.uint32) * np.uint32(40503)
        w = rng.choice(np.array([0, 1, 3], np.int32), n, p=[0.1, 0.7, 0.2])
        w[n - 13 * (i + 1):] = 0  # ragged tail
        g = 1.01 / 0.99
        v = np.floor(g ** rng.integers(0, 1000, n)) + rng.integers(-1, 2, n)
        v = np.clip(v, 0, 2**32 - 1).astype(np.uint32)
        v[::11] = 0
        out.append((hh, distinct, dist, w, v, np.float32(i)))
    return out


def _ref_leaves(b):
    return [np.asarray(x) for x in jax.tree.leaves(b)]


def _assert_leaves_equal(port_bundle, ref_bundle, ctx=""):
    got, want = P.bundle_to_numpy(port_bundle), _ref_leaves(ref_bundle)
    assert len(got) == len(want), ctx
    for i, (g, r) in enumerate(zip(got, want)):
        assert g.dtype == r.dtype and g.shape == r.shape, (ctx, i, g.dtype, r.dtype)
        assert np.array_equal(g, r), (ctx, i)


def _assert_digests_match(port_bundle, ref_bundle):
    got = P.bundle_digest(port_bundle).numpy().view(np.uint32)
    want = np.asarray(R.bundle_digest(ref_bundle))
    assert got.dtype == want.dtype == np.uint32 and got.shape == want.shape
    # integer words byte for byte: events, drops, overflow, top-k keys and counts
    ints = np.r_[[0, 1, 4], np.arange(5, want.size)]
    assert got[ints].tobytes() == want[ints].tobytes()
    g, r = got[2:4].view(np.float32), want[2:4].view(np.float32)
    assert np.allclose(g, r, rtol=RTOL, atol=0)
    dg, dr = P.decode_digest(P.bundle_digest(port_bundle)), R.decode_digest(want)
    assert dg[:2] == dr[:2] and dg[4] == dr[4]
    assert np.array_equal(dg[5], dr[5]) and np.array_equal(dg[6], dr[6])


def _step_ref(b, batch):
    hh, distinct, dist, w, v, drops = map(jnp.asarray, batch)
    return R.bundle_ingest_step(b, hh, distinct, dist, w, drops, v)[0]


def _step_pallas(b, batch):
    hh, distinct, dist, w, v, drops = map(jnp.asarray, batch)
    return R._bundle_update_pallas(b, hh, distinct, dist, w, drops, v, interpret=True)


def _step_port(b, batch):
    hh, distinct, dist, w, v, drops = batch
    t = torch.from_numpy
    out, fence = P.bundle_ingest_step(b, t(hh), t(distinct), t(dist), t(w),
                                      float(drops), t(v))
    assert out is b and isinstance(fence, torch.Tensor)
    return out


def test_ingest_step_matches_reference_and_pallas_every_leaf():
    ref = R.bundle_init(**GEOM)
    pal = R.bundle_init(**GEOM)
    port = P.bundle_init(**GEOM, device="cpu")
    for i, batch in enumerate(_batches(1)):
        ref = _step_ref(ref, batch)
        pal = _step_pallas(pal, batch)
        _step_port(port, batch)
        _assert_leaves_equal(port, ref, ctx=("reference", i))
        _assert_leaves_equal(port, pal, ctx=("pallas", i))
    _assert_digests_match(port, ref)
    assert P.decode_digest(P.bundle_digest(port))[0] > 0


@pytest.mark.parametrize("geom", [
    dict(depth=2, log2_width=12, hll_p=7, entropy_log2_width=10, k=8),
    dict(depth=4, log2_width=8, hll_p=10, entropy_log2_width=6, k=16, quantiles=True,
         quantile_buckets=1024, quantile_min_value=1.0),
    dict(depth=5, log2_width=11, hll_p=8, entropy_log2_width=6, k=32, inv_rows=2,
         inv_log2_buckets=12),
])
def test_plane_combinations_plain_and_fused_agree_with_reference(geom):
    """Plane on/off combinations: the port's plain composition and its
    fused update both equal the reference composition."""
    ref = R.bundle_init(**geom)
    plain = P.bundle_init(**geom, device="cpu")
    fused = P.bundle_init(**geom, device="cpu")
    t = torch.from_numpy
    for i, (hh, distinct, dist, w, v, drops) in enumerate(_batches(2, n=256, count=3)):
        ref = R.bundle_update(ref, *map(jnp.asarray, (hh, distinct, dist, w, drops, v)))
        P.bundle_update(plain, t(hh), t(distinct), t(dist), t(w), float(drops), t(v))
        P.bundle_update_fused(fused, t(hh), t(distinct), t(dist), t(w), float(drops), t(v))
        _assert_leaves_equal(plain, ref, ctx=("plain", i))
        _assert_leaves_equal(fused, ref, ctx=("fused", i))
    _assert_digests_match(fused, ref)


def test_merge_matches_reference():
    ba, bb = _batches(3, count=2), _batches(4, count=2)
    ra, rb = R.bundle_init(**GEOM), R.bundle_init(**GEOM)
    pa, pb = P.bundle_init(**GEOM, device="cpu"), P.bundle_init(**GEOM, device="cpu")
    for x, y in zip(ba, bb):
        ra, rb = _step_ref(ra, x), _step_ref(rb, y)
        _step_port(pa, x)
        _step_port(pb, y)
    _assert_leaves_equal(P.bundle_merge(pa, pb), R.bundle_merge(ra, rb))
    _assert_digests_match(P.bundle_merge(pa, pb), R.bundle_merge(ra, rb))


def test_state_carries_over_both_ways():
    """A reference bundle advanced by a few batches continues in the
    port from its leaves (and back) and both stay equal."""
    batches = _batches(5, count=5)
    ref = R.bundle_init(**GEOM)
    for batch in batches[:2]:
        ref = _step_ref(ref, batch)
    port = P.bundle_from_numpy(_ref_leaves(ref), device="cpu")
    _assert_leaves_equal(port, ref, ctx="loaded")
    for batch in batches[2:4]:
        ref = _step_ref(ref, batch)
        _step_port(port, batch)
    _assert_leaves_equal(port, ref, ctx="continued")
    treedef = jax.tree.structure(ref)
    back = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in P.bundle_to_numpy(port)])
    back = _step_ref(back, batches[4])
    _step_port(port, batches[4])
    _assert_leaves_equal(port, back, ctx="back in the reference")
    base = dict(GEOM, inv_rows=0, quantiles=False)
    plain = R.bundle_init(**base)
    assert len(P.bundle_to_numpy(P.bundle_from_numpy(_ref_leaves(plain), device="cpu"))) == 9


def test_port_imports_no_jax():
    """Every module of the port (the native binding, the window sketches,
    the telemetry, the operator, the history windows, store, queries,
    lifecycle and archive, the journal, the standing queries, the
    checkpoint files, the accuracy plane, the gadget framework (params,
    columns, gadgets, runtime, the span tree and the CLI), the alerting
    plane and the recording manager, capture operator and replay
    included) imports without
    JAX or the JAX package, and no source file of it names either.
    Importing `sources.bridge` builds nothing: with no compiler to be
    found, the import still succeeds and its library is neither built nor
    loaded. Importing `cli.main` arms no signal handler."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    assert {"inspektor_gadget_tpu_torch.sources.bridge", "inspektor_gadget_tpu_torch.ops.window",
            "inspektor_gadget_tpu_torch.telemetry.pipeline",
            "inspektor_gadget_tpu_torch.operators", "inspektor_gadget_tpu_torch.operators.tpusketch",
            "inspektor_gadget_tpu_torch.history", "inspektor_gadget_tpu_torch.history.window",
            "inspektor_gadget_tpu_torch.utils", "inspektor_gadget_tpu_torch.utils.checkpoint",
            "inspektor_gadget_tpu_torch.ops.accuracy",
            "inspektor_gadget_tpu_torch.params", "inspektor_gadget_tpu_torch.params.params",
            "inspektor_gadget_tpu_torch.columns", "inspektor_gadget_tpu_torch.columns.columns",
            "inspektor_gadget_tpu_torch.gadgets", "inspektor_gadget_tpu_torch.gadgets.source_gadget",
            "inspektor_gadget_tpu_torch.gadgets.trace.exec",
            "inspektor_gadget_tpu_torch.gadgets.top.sketch", "inspektor_gadget_tpu_torch.runtime",
            "inspektor_gadget_tpu_torch.runtime.local", "inspektor_gadget_tpu_torch.cli.main",
            "inspektor_gadget_tpu_torch.telemetry.tracing",
            "inspektor_gadget_tpu_torch.agent.wire", "inspektor_gadget_tpu_torch.utils.journal",
            "inspektor_gadget_tpu_torch.capture.journal",
            "inspektor_gadget_tpu_torch.perf.provenance",
            "inspektor_gadget_tpu_torch.history.store", "inspektor_gadget_tpu_torch.history.query",
            "inspektor_gadget_tpu_torch.history.lifecycle",
            "inspektor_gadget_tpu_torch.history.archive", "inspektor_gadget_tpu_torch.queries.spec",
            "inspektor_gadget_tpu_torch.queries.cache", "inspektor_gadget_tpu_torch.queries.engine",
            "inspektor_gadget_tpu_torch.cli.query", "inspektor_gadget_tpu_torch.cli.history",
            "inspektor_gadget_tpu_torch.cli.watch",
            "inspektor_gadget_tpu_torch.gadgets.top.windows",
            "inspektor_gadget_tpu_torch.alerts", "inspektor_gadget_tpu_torch.alerts.rules",
            "inspektor_gadget_tpu_torch.alerts.engine", "inspektor_gadget_tpu_torch.alerts.sinks",
            "inspektor_gadget_tpu_torch.alerts.store", "inspektor_gadget_tpu_torch.operators.alertsop",
            "inspektor_gadget_tpu_torch.capture.manager",
            "inspektor_gadget_tpu_torch.capture.operator",
            "inspektor_gadget_tpu_torch.capture.replay",
            "inspektor_gadget_tpu_torch.gadgets.top.recordings",
            "inspektor_gadget_tpu_torch.gadgets.top.alerts",
            "inspektor_gadget_tpu_torch.cli.record", "inspektor_gadget_tpu_torch.cli.alerts",
            "inspektor_gadget_tpu_torch.runtime.grpc_runtime",
            "inspektor_gadget_tpu_torch.runtime.supervisor",
            "inspektor_gadget_tpu_torch.fleet", "inspektor_gadget_tpu_torch.fleet.aggregator",
            "inspektor_gadget_tpu_torch.agent.dialer", "inspektor_gadget_tpu_torch.cli.deploy",
            "inspektor_gadget_tpu_torch.cli.apply",
            "inspektor_gadget_tpu_torch.testing.chaos",
            "inspektor_gadget_tpu_torch.ops.lanes", "inspektor_gadget_tpu_torch.parallel.mesh",
            "inspektor_gadget_tpu_torch.parallel.distributed",
            "inspektor_gadget_tpu_torch.parallel.cluster",
            "inspektor_gadget_tpu_torch.fleet.collective",
            "inspektor_gadget_tpu_torch.fleet.topology", "inspektor_gadget_tpu_torch.fleet.sim",
            "inspektor_gadget_tpu_torch.cli.fleet"} \
        <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bridge = sys.modules['inspektor_gadget_tpu_torch.sources.bridge']\n"
            "assert bridge.LIBRARY._lib is None and bridge.LIBRARY.path is None\n"
            "import signal\n"
            "assert signal.getsignal(signal.SIGINT) is signal.default_int_handler\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('inspektor_gadget_tpu.') or m == 'inspektor_gadget_tpu']\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, CXX=str(ROOT / "no-such-compiler"), PATH="/nonexistent")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for path in list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax", "inspektor_gadget_tpu"), \
                    (path, name)


# -- the three parity faults (regimes in PERF.md §1) ---------------------------

FAULT_GEOM = dict(depth=2, log2_width=10, hll_p=9, entropy_log2_width=8, k=16, inv_rows=1,
                  inv_log2_buckets=9, quantiles=True, quantile_buckets=1024)


def _four_ways(hh, w):
    """One batch (keys in every lane, values 0) through the port's
    `bundle_ingest_step` and `bundle_update` and the reference's
    `bundle_ingest_step` and `_bundle_update_pallas(..., interpret=True)`."""
    hh, w = np.asarray(hh, np.uint32), np.asarray(w, np.int32)
    v = np.zeros_like(hh)
    batch = (hh, hh, hh, w, v, np.float32(0))
    ingest = _step_port(P.bundle_init(**FAULT_GEOM, device="cpu"), batch)
    composed = P.bundle_init(**FAULT_GEOM, device="cpu")
    t = torch.from_numpy
    P.bundle_update(composed, t(hh), t(hh), t(hh), t(w), 0.0, t(v))
    return {"port ingest": ingest, "port composed": composed,
            "reference": _step_ref(R.bundle_init(**FAULT_GEOM), batch),
            "reference pallas": _step_pallas(R.bundle_init(**FAULT_GEOM), batch)}


def _leaf(b, name):
    if isinstance(b, P.SketchBundle):
        return {"total": b.cms.total, "events": b.events,
                "entropy": b.entropy.counts}[name].numpy()
    return np.asarray({"total": b.cms.total, "events": b.events,
                       "entropy": b.entropy.counts}[name])


def _xla_sum_f32(x: np.ndarray) -> np.float32:
    """XLA's CPU order for a 1-D float32 sum, as probed: windows of 32
    (the padding split low half first) summed in turn, level by level,
    then the last <= 32 partials in turn."""
    x = np.asarray(x, np.float32)
    while x.size > 32:
        m = -(-x.size // 32)
        pad = m * 32 - x.size
        x = np.concatenate([np.zeros(pad // 2, np.float32), x,
                            np.zeros(pad - pad // 2, np.float32)]).reshape(m, 32)
        acc = np.zeros(m, np.float32)
        for j in range(32):
            acc = (acc + x[:, j]).astype(np.float32)
        x = acc
    acc = np.float32(0)
    for v in x:
        acc = np.float32(acc + v)
    return acc


def test_cms_total_wraps_as_int32():
    """The reference sums the batch's int32 weights in int32, wrapping,
    then casts to float32 (inspektor_gadget_tpu/ops/countmin.py:59,
    ops/sketches.py:199). 1024 rows of weight 3*10**6 sum to 3.072e9."""
    keys = np.arange(1, 1025, dtype=np.uint32) * np.uint32(2654435761)
    out = _four_ways(keys, np.full(1024, 3_000_000, np.int32))
    for name, b in out.items():
        assert _leaf(b, "total") == np.float32(-1222967296.0), name
    assert np.array_equal(out["port ingest"].cms.table.numpy(),
                          np.asarray(out["reference"].cms.table))


def test_events_is_the_exact_sum_equal_to_the_reference_below_2_24():
    """The reference sums the weights in float32 in XLA's order
    (inspektor_gadget_tpu/ops/sketches.py:109, :226); the port adds the
    exact sum rounded once. Regime: a batch whose weight sum is below
    2**24 gives the same events on every path. Above it the two differ
    as shown: the reference's value is XLA's order, the port's the exact
    sum rounded once."""
    keys = np.arange(1, 1025, dtype=np.uint32) * np.uint32(2654435761)
    edge = np.full(1024, 16384, np.int32)
    edge[0] -= 1  # weight sum 2**24 - 1, the regime's edge
    for name, b in _four_ways(keys, edge).items():
        assert _leaf(b, "events") == np.float32(2**24 - 1), name
    rng = np.random.default_rng(1)  # a stream whose XLA-order sum is not the exact one
    above = {"2**17 rows of weight [1, 4000)": (rng.integers(1, 2**32, 1 << 17, dtype=np.uint32),
                                                rng.integers(1, 4000, 1 << 17).astype(np.int32)),
             "1024 x (2**21 + 1) on one key": (np.full(1024, 0xC0FFEE, np.uint32),
                                               np.full(1024, 2**21 + 1, np.int32))}
    for case, (hh, w) in above.items():
        out = _four_ways(hh, w)
        exact = np.float32(int(w.sum(dtype=np.int64)))
        ref = _leaf(out["reference"], "events")
        assert ref == _leaf(out["reference pallas"], "events") == _xla_sum_f32(w), case
        assert _leaf(out["port ingest"], "events") == _leaf(out["port composed"], "events") \
            == exact, case
        assert ref != exact and abs(float(ref) - float(exact)) <= 1e-6 * float(exact), case
    assert ref == np.float32(2147483904.0) and exact == np.float32(2147484672.0)


def test_entropy_delta_never_wraps():
    """The reference adds float32 weights: its CPU path scatters them one
    at a time (inspektor_gadget_tpu/ops/entropy.py:49), its Pallas path
    takes an float32 one-hot product (ops/pallas_kernels.py:62-80). The
    port's K1 and K2 count each bucket exactly in int64 and round once.
    Regime: equal to the reference's Pallas path while a bucket's batch
    total is below 2**24, and to its CPU path while a bucket's running
    count is; above, the count is positive and exact (the Pallas path's
    value), where it used to wrap to -2147482624.0."""
    keys = np.arange(1, 1025, dtype=np.uint32) * np.uint32(2654435761)
    hot = np.full(1024, 0xC0FFEE, np.uint32)
    edge = np.full(1024, 16383, np.int32)  # one hot bucket at 1024 * 16383 < 2**24
    for hh in (keys, hot):
        out = _four_ways(hh, edge)
        want = _leaf(out["reference"], "entropy")
        for name, b in out.items():
            assert np.array_equal(_leaf(b, "entropy"), want), name
    out = _four_ways(hot, np.full(1024, 2**21 + 1, np.int32))
    for name in ("port ingest", "port composed"):
        got = _leaf(out[name], "entropy")
        assert got.max() == np.float32(2147484672.0) and got.min() == 0, name
        assert np.array_equal(got, _leaf(out["reference pallas"], "entropy")), name
    assert _leaf(out["reference"], "entropy").max() == np.float32(2147483904.0)
