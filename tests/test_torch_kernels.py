"""The plain versions of the port's two kernels against the JAX package.

K1 (`histogram`) is held to ``xla_histogram``, the reference's own
reference for ``pallas_histogram`` (which has no interpret switch). K2
(`fused_planes`) is held to ``fused_sketch_planes(..., interpret=True)``,
the Pallas kernel run in the interpreter, plane by plane. The CUDA
kernels themselves need the card; ``chip_smoke.py`` holds them to these
plain versions there. What the kernels share with the plain versions on
the host side (the plane layout and the tile job table) is checked here.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from inspektor_gadget_tpu.ops.pallas_kernels import fused_sketch_planes as ref_fused
from inspektor_gadget_tpu.ops.pallas_kernels import xla_histogram
from inspektor_gadget_tpu_torch.ops import kernels as K
from inspektor_gadget_tpu_torch.ops.hashing import _row_multiplier


def _lanes(rng, n, weights=(0, 1, 3)):
    keys = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(3)]
    keys[0][::5] = keys[0][0]  # a heavy key in the hh lane
    w = rng.choice(np.array(weights, np.int32), n)
    return keys, w


@pytest.mark.parametrize("log2_width,n,row", [(6, 256, 0), (10, 1024, 3), (12, 2048, 11)])
def test_histogram_plain_matches_xla_histogram(log2_width, n, row):
    rng = np.random.default_rng(log2_width)
    (keys, _, _), w = _lanes(rng, n)
    mult, salt = int(_row_multiplier(row)), (row * 0x9E3779B9) & 0xFFFFFFFF
    want = np.asarray(xla_histogram(jnp.asarray(keys), jnp.asarray(w, jnp.float32),
                                    log2_width=log2_width, mult=mult, salt=salt))
    before = K.histogram.launches
    got = K.histogram(torch.from_numpy(keys), torch.from_numpy(w),
                      log2_width=log2_width, mult=mult, salt=salt)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.float32), want)
    assert K.histogram.launches == before  # the CPU takes the plain version


def _boundary_values(n, rng):
    g = 1.01 / 0.99
    b = np.floor(g ** rng.integers(0, 1100, n // 2))
    v = np.concatenate([b + rng.integers(-1, 2, n // 2), rng.integers(0, 2**32, n - n // 2)])
    v = np.clip(v, 0, 2**32 - 1).astype(np.uint32)
    v[::17] = 0
    return v


CASES = [  # depth, log2w, ent_log2w, hll_p, n, valid (tests/test_sketches.py cases)
    (4, 10, 8, 8, 256, 256),
    (2, 12, 10, 7, 512, 501),
    (5, 11, 6, 10, 512, 384),
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("inv_rows,qt_buckets", [(0, 0), (3, 0), (0, 2048), (2, 1024)])
def test_fused_planes_plain_matches_pallas_interpret(case, inv_rows, qt_buckets):
    depth, log2w, entw, p, n, valid = case
    inv_lb = 9 if inv_rows else 0
    rng = np.random.default_rng(depth * 1000 + inv_rows * 10 + qt_buckets)
    (hh, distinct, dist), w = _lanes(rng, n)
    w[valid:] = 0
    values = _boundary_values(n, rng) if qt_buckets else None
    want = ref_fused(jnp.asarray(hh), jnp.asarray(distinct), jnp.asarray(dist),
                     jnp.asarray(w), None if values is None else jnp.asarray(values),
                     depth=depth, log2_width=log2w, ent_log2_width=entw, hll_p=p,
                     inv_rows=inv_rows, inv_log2_buckets=inv_lb, qt_buckets=qt_buckets,
                     qt_alpha=0.01, qt_min_value=1.0, interpret=True)
    t = torch.from_numpy
    before = K.fused_planes.launches
    got = K.fused_sketch_planes(t(hh), t(distinct), t(dist), t(w),
                                None if values is None else t(values),
                                depth=depth, log2_width=log2w, ent_log2_width=entw, hll_p=p,
                                inv_rows=inv_rows, inv_log2_buckets=inv_lb,
                                qt_buckets=qt_buckets, qt_alpha=0.01, qt_min_value=1.0)
    assert K.fused_planes.launches == before
    names = ("cms", "entropy", "hll", "inv", "quantiles")
    for name, g, r in zip(names, got, want):
        if r is None:
            assert g is None, name
            continue
        r = np.asarray(r)
        g = g.numpy()
        assert g.shape == r.shape, name
        if r.dtype == np.uint32:
            assert np.array_equal(g.astype(np.uint32), r), name
        else:
            assert np.array_equal(g.astype(np.float64), r.astype(np.float64)), name


@pytest.mark.parametrize("geom", [
    K.FusedGeometry(4, 16, 12, 14, 3, 12, 2048),     # production, every plane on
    K.FusedGeometry(2, 15, 10, 9),                   # no optional planes
    K.FusedGeometry(3, 17, 12, 15, 1, 14, 2000),     # ragged tiles, wide rows
])
def test_job_table_tiles_every_plane_exactly(geom):
    """The kernel's (plane, bucket tile) jobs cover each plane's buckets
    once, no tile is wider than the shared-memory tile, and no plane is
    padded to the widest."""
    jobs, max_tile = K._job_table(geom.planes, torch.device("cpu"))
    jobs = jobs.numpy()
    assert max_tile <= K.TILE and jobs.shape[1] == 8
    covered = np.zeros(geom.total, np.int64)
    for kind, lane, mult, salt, shift, lo, width, off in jobs:
        assert 0 < width <= K.TILE
        covered[off + lo:off + lo + width] += 1
    assert (covered == 1).all()
    widths = [pl.width for pl in geom.planes]
    assert geom.total == sum(widths)
    assert len(geom.planes) == geom.depth + 2 + 3 * geom.inv_rows + (1 if geom.qt_buckets else 0)


@pytest.mark.parametrize("log2_width", [12, 16, 17])
def test_job_table_of_one_histogram_plane(log2_width):
    """K1's launch: one histogram plane split into shared-memory tiles,
    the row hash's multiplier and salt carried as int32 bit patterns."""
    mult, salt = int(_row_multiplier(3)), 0xDEADBEEF
    plane = K.Plane(K.HIST, K.LANE_HH, mult, salt, log2_width, 1 << log2_width, 0)
    jobs, max_tile = K._job_table((plane,), torch.device("cpu"))
    jobs = jobs.numpy()
    assert max_tile == min(K.TILE, 1 << log2_width)
    assert jobs.shape == (max(1, (1 << log2_width) // K.TILE), 8)
    assert (jobs[:, 0] == K.HIST).all() and (jobs[:, 4] == 32 - log2_width).all()
    assert (jobs[:, 2].view(np.uint32) == mult).all() and (jobs[:, 3].view(np.uint32) == salt).all()
    assert list(jobs[:, 5]) == list(range(0, 1 << log2_width, K.TILE))
    assert jobs[:, 6].sum() == 1 << log2_width


def test_wrappers_refuse_mixed_devices_and_missing_values():
    geom = K.FusedGeometry(2, 8, 6, 6, qt_buckets=64)
    x = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.fused_planes(x, x, x, x, None, geom)
    with pytest.raises(ValueError):
        K.fused_planes(x, x, x, x, torch.zeros(16), geom)
    meta = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.histogram(meta, x, log2_width=6)
