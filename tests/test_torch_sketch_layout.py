"""The sketch kernels' launch plan and a CPU emulation of the layout that
ig_fused_planes runs on the card.

The plan (`ops.kernels.launch_plan`) is what the kernel reads: each plane
cut into jobs of at most one shared-memory tile of buckets, each job's
rows cut into slices by its work, one thread block a (job, slice). Its
invariants are pinned over the production geometry, narrower and wider
ones, and K1's one-plane launches.

`emulate` repeats the kernel's partition in numpy: each block adds its
rows into its own tile of its job's buckets (adds mod 2**32, HLL ranks
by max, as the shared-memory atomics do) and flushes the tile into the
output; a HIST64 plane's wraps and negative weights go to each
bucket's high word. It must equal the plain versions bit for bit, and a faulty
partition (a bucket held by two jobs, a ragged tail slice dropped) must
not. `layout_counts` counts one call's work as the kernel does it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from inspektor_gadget_tpu_torch.ops import kernels as K
from inspektor_gadget_tpu_torch.ops.hashing import _row_multiplier, fmix32_np, row_salt
from inspektor_gadget_tpu_torch.ops.hll import hll_index_rank
from inspektor_gadget_tpu_torch.ops.invertible import FP_SALT
from inspektor_gadget_tpu_torch.ops.quantiles import bucket_index
from inspektor_gadget_tpu_torch.sources import ZipfFoldedSource
from inspektor_gadget_tpu_torch.sources.synthetic import DIST, DISTINCT, HH, VALUES, WEIGHTS

torch.set_num_threads(2)

MASK = np.uint64(0xFFFFFFFF)
PRODUCTION = K.FusedGeometry(4, 16, 12, 14, 3, 12, 2048)
GEOMETRIES = {
    "production": PRODUCTION,
    "no optional planes": K.FusedGeometry(2, 15, 10, 9),
    "ragged, wide rows": K.FusedGeometry(3, 17, 12, 15, 1, 14, 2000),
    "count-min 2**18": dataclasses.replace(PRODUCTION, log2_width=18),
    "count-min 2**20": dataclasses.replace(PRODUCTION, log2_width=20),
}
BATCH = 1 << 17
H100_SMS = 132  # the H100 SXM's streaming multiprocessors


def hist_plane(log2_width: int) -> K.Plane:
    """K1's plane: a carrying histogram."""
    return K.Plane(K.HIST64, K.LANE_HH, int(_row_multiplier(0)), row_salt(0), log2_width,
                   1 << log2_width, 0)


PLANE_SETS = {name: g.planes for name, g in GEOMETRIES.items()}
PLANE_SETS.update({f"K1 2**{lw}": (hist_plane(lw),) for lw in (12, 16, 17)})


# -- the plan's invariants -----------------------------------------------------

@pytest.mark.parametrize("name", sorted(PLANE_SETS))
def test_plan_owns_every_bucket_once(name):
    """Every bucket of every plane belongs to exactly one job, whose
    blocks each hold it in their tile and flush it; no job is wider than
    a tile."""
    planes = PLANE_SETS[name]
    plan = K.launch_plan(planes, BATCH, H100_SMS)
    owners = np.zeros(planes[-1].offset + planes[-1].span, np.int64)
    for j in plan.jobs:
        pl = planes[j.plane]
        assert 0 < j.width <= 1 << K.TILE_LOG2 and j.lo + j.width <= pl.width
        owners[pl.word(j.lo):pl.word(j.lo + j.width)] += 1
    assert (owners == 1).all()
    assert {ji for ji, _, _ in plan.slices} == set(range(len(plan.jobs)))


@pytest.mark.parametrize("name", sorted(PLANE_SETS))
@pytest.mark.parametrize("n", [1, 33, 100003, BATCH])
def test_plan_gives_every_row_to_one_block_per_group(name, n):
    """Each job's (the group of buckets a block holds) rows are cut into
    slices that start on 4-row units and cover every row once."""
    plan = K.launch_plan(PLANE_SETS[name], n, H100_SMS)
    for ji in range(len(plan.jobs)):
        seen = np.zeros(n, np.int64)
        for j, rb, re in plan.slices:
            if j == ji:
                assert rb % 4 == 0 and rb < re
                seen[rb:re] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("name", sorted(PLANE_SETS))
def test_plan_hashes_each_plane_once_per_row_and_tile(name):
    """A block hashes each of its rows once, for its job's one plane, so
    a plane's hash runs once per row for each tile-wide range of it: one
    for a plane no wider than a tile, four for a 65536-wide count-min row
    at 16384-bucket tiles."""
    planes = PLANE_SETS[name]
    plan = K.launch_plan(planes, BATCH, H100_SMS)
    tile = 1 << K.TILE_LOG2
    for i, pl in enumerate(planes):
        mine = [j for j in plan.jobs if j.plane == i]
        assert len(mine) == -(-pl.width // tile)
        assert [j.lo for j in mine] == list(range(0, pl.width, tile))


@pytest.mark.parametrize("name", sorted(PLANE_SETS))
def test_plan_fits_the_card(name):
    """Shared memory a block within sm_90's 227 KB and the table in the
    kernel's layout."""
    planes = PLANE_SETS[name]
    plan = K.launch_plan(planes, BATCH, H100_SMS)
    assert plan.smem_bytes <= K.SMEM_LIMIT
    assert plan.tile_words == max(j.width for j in plan.jobs)
    table = plan.table()
    assert table.shape == (plan.blocks, K.BLOCK_FIELDS) and table.dtype == np.int32
    rows = [(plan.jobs[ji], r0, r1) for ji, r0, r1 in plan.slices]
    assert (table[:, 2].view(np.uint32) == [planes[j.plane].mult for j, _, _ in rows]).all()
    assert (table[:, 7] == [planes[j.plane].word(j.lo) for j, _, _ in rows]).all()
    assert (table[:, 8:] == [(r0, r1) for _, r0, r1 in rows]).all()


@pytest.mark.parametrize("name", ["production", "K1 2**12", "K1 2**16", "K1 2**17"])
def test_plan_fills_the_card_at_production(name):
    plan = K.launch_plan(PLANE_SETS[name], BATCH, H100_SMS)
    assert H100_SMS <= plan.blocks <= K.BLOCKS_PER_SM * H100_SMS


def test_production_plan_layout():
    """K2 at production: 28 jobs (four a count-min row, one for each
    other plane), 396 blocks of 64 KB, slices in proportion to a job's
    work: a DDSketch row's slices are shorter than a count-min tile's."""
    plan = K.launch_plan(PRODUCTION.planes, BATCH, H100_SMS)
    assert [j.width for j in plan.jobs] == [16384] * 16 + [4096, 16384] + [4096] * 9 + [2048]
    assert plan.blocks == K.BLOCKS_PER_SM * H100_SMS and plan.smem_bytes == 65536
    parts = np.bincount([ji for ji, _, _ in plan.slices])
    assert parts.max() - parts[:16].min() <= 1 + parts.max() // 2
    assert parts[-1] > parts[0]  # the DDSketch job: three times a hash's work a row


# -- the kernel's partition, emulated --------------------------------------------

def _plane_values(pl: K.Plane, keys: np.ndarray, w: np.ndarray, geom) -> tuple:
    """(bucket in the plane, value) of each row, as the kernel computes
    them; value 0 adds nothing."""
    w = w.astype(np.int64) & 0xFFFFFFFF
    if pl.kind == K.HLL:
        idx, rank = hll_index_rank(torch.from_numpy(keys.astype(np.int64)), pl.log2_width)
        return idx.numpy(), np.where(w != 0, rank.numpy(), 0).astype(np.uint64)
    if pl.kind == K.QUANT:
        b = bucket_index(torch.from_numpy(keys.astype(np.int64)), alpha=geom.qt_alpha,
                         min_value=geom.qt_min_value, n_buckets=geom.qt_buckets).numpy()
        return b, np.where(keys != 0, w, 0).astype(np.uint64)
    b = (fmix32_np((keys.astype(np.uint64) * np.uint64(pl.mult) + np.uint64(pl.salt))
                   .astype(np.uint32)) >> np.uint32(32 - pl.log2_width)).astype(np.int64)
    k, wu = keys.astype(np.uint64), w.astype(np.uint64)
    val = {K.HIST: wu, K.HIST64: wu, K.INV_COUNT: wu, K.INV_KEYSUM: (k * wu) & MASK,
           K.INV_FPSUM: (fmix32_np(keys ^ np.uint32(FP_SALT)).astype(np.uint64) * wu) & MASK}
    return b, val[pl.kind]


def emulate(plan: K.LaunchPlan, lanes, w: np.ndarray, geom=None, fault: str | None = None):
    """The flat uint32 output of ig_fused_planes under `plan`, in numpy."""
    planes = plan.planes
    out = np.zeros(planes[-1].offset + planes[-1].span, np.uint64)
    slices = list(plan.slices)
    if fault == "tail dropped":  # each job's last slice, where shorter than its first
        last = {ji: k for k, (ji, _, _) in enumerate(slices)}
        first = {ji: slices[k] for k, (ji, _, _) in reversed(list(enumerate(slices)))}
        slices = [s for k, s in enumerate(slices)
                  if not (last[s[0]] == k and s[2] - s[1] < first[s[0]][2] - first[s[0]][1])]
    for ji, rb, re in slices:
        job = plan.jobs[ji]
        pl = planes[job.plane]
        width = job.width
        if fault == "owned twice":  # a tile reaching into the next job's buckets
            width = min(pl.width - job.lo, width + width // 4)
        tile = np.zeros(width, np.uint64)  # the block's shared memory
        b, val = _plane_values(pl, lanes[pl.lane][rb:re], w[rb:re], geom)
        b = b - job.lo
        keep = (b >= 0) & (b < width) & (val != 0)
        if pl.kind == K.HLL:
            np.maximum.at(tile, b[keep], val[keep])
        else:
            np.add.at(tile, b[keep], val[keep])
        first = pl.word(job.lo)
        if pl.kind == K.HIST64:
            # (low, high) words a bucket: the tile's wraps less its negative
            # weights, then the flush's wraps, go to the high word
            seg = out[first:first + 2 * width].reshape(width, 2)
            neg = np.zeros(width, np.uint64)
            np.add.at(neg, b[keep], (w[rb:re][keep] < 0).astype(np.uint64))
            carry = (tile >> np.uint64(32)) - neg
            tile &= MASK
            carry += (seg[:, 0] + tile) >> np.uint64(32)
            seg[:, 0] = (seg[:, 0] + tile) & MASK
            seg[:, 1] = (seg[:, 1] + carry) & MASK
            continue
        seg = out[first:first + width]  # one device atomic a bucket
        if pl.kind == K.HLL:
            np.maximum(seg, tile, out=seg)
        else:
            seg[:] = (seg + tile) & MASK
    return out.astype(np.uint32)


def _stream(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "zipf":
        ranks = np.minimum(rng.zipf(1.2, n), 5000).astype(np.uint32)
        hh = fmix32_np(ranks * np.uint32(2654435761))
    elif kind == "one key":
        hh = np.full(n, 0xDEADBEEF, np.uint32)
    else:
        hh = rng.integers(0, 2**32, n, dtype=np.uint32)
    distinct = rng.integers(0, 2**32, n, dtype=np.uint32)
    distinct[::3] = hh[::3]
    values = np.exp(rng.normal(np.log(5e4), 1.5, n)).clip(0, 2**32 - 1).astype(np.uint32)
    values[::11] = 0
    w = rng.choice(np.array([0, 1, 1, 1, 3], np.int32), n)
    if kind == "weights 0":
        w[:] = 0
    if kind == "weights near 2**31":
        w = rng.choice(np.array([2**31 - 1, -2**31, 2**31 - 3, 1], np.int64), n).astype(np.int32)
    return [hh, distinct, hh.copy(), values], w


STREAMS = ["zipf", "one key", "uniform", "weights 0", "weights near 2**31"]


def _plain(geom, lanes, w):
    t = torch.from_numpy
    return K.fused_planes_plain(t(lanes[0]), t(lanes[1]), t(lanes[2]), t(w), t(lanes[3]),
                                geom).numpy().view(np.uint32)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("n", [0, 1, 31, 33, 100003])
def test_emulated_layout_equals_fused_planes_plain(stream, n):
    lanes, w = _stream(stream, n, seed=n + len(stream))
    want = _plain(PRODUCTION, lanes, w)
    got = emulate(K.launch_plan(PRODUCTION.planes, n, H100_SMS), lanes, w, PRODUCTION) if n else \
        np.zeros_like(want)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("log2_width", [12, 16, 17])
@pytest.mark.parametrize("stream", ["zipf", "weights near 2**31"])
def test_emulated_layout_equals_histogram_plain(log2_width, stream):
    lanes, w = _stream(stream, 20011, seed=log2_width)
    plane = hist_plane(log2_width)
    want = K.histogram_plain(torch.from_numpy(lanes[0]), torch.from_numpy(w),
                             log2_width=log2_width, mult=plane.mult, salt=plane.salt)
    got = emulate(K.launch_plan((plane,), 20011, H100_SMS), lanes, w).view(np.int64)
    assert want.dtype == torch.int64 and np.array_equal(got, want.numpy())
    assert int(want.abs().max()) >= 1 << 31 or stream != "weights near 2**31"  # no wrap


@pytest.mark.parametrize("name", ["no optional planes", "ragged, wide rows"])
def test_emulated_layout_equals_plain_at_other_geometries(name):
    geom = GEOMETRIES[name]
    lanes, w = _stream("zipf", 50021, seed=7)
    assert np.array_equal(emulate(K.launch_plan(geom.planes, 50021, H100_SMS), lanes, w, geom),
                          _plain(geom, lanes, w))


@pytest.mark.parametrize("fault", ["owned twice", "tail dropped"])
def test_faulty_layouts_are_caught(fault):
    lanes, w = _stream("zipf", 100003, seed=3)
    plan = K.launch_plan(PRODUCTION.planes, 100003, H100_SMS)
    got = emulate(plan, lanes, w, PRODUCTION, fault=fault)
    assert not np.array_equal(got, _plain(PRODUCTION, lanes, w))


def layout_counts(plan: K.LaunchPlan, lanes, w: np.ndarray, geom=None) -> dict:
    """The work of one ig_fused_planes call under `plan` on one batch (the
    four key lanes in LANE_* order), counted as the kernel partitions it:
    bytes of lanes read (each job reads its key lane and the weights once
    a row), key hashes (one a row and job), shared-memory atomics (one a
    row and job that adds), and device atomics of the flush (one a
    nonzero bucket of a block's tile)."""
    n = plan.n
    out = {"bytes_read": 8 * n * len(plan.jobs), "hashes": n * len(plan.jobs),
           "shared_atomics": 0, "global_atomics": 0}
    for ji, job in enumerate(plan.jobs):
        pl = plan.planes[job.plane]
        b, val = _plane_values(pl, lanes[pl.lane], w, geom)
        b = b - job.lo
        keep = (b >= 0) & (b < job.width) & (val != 0)
        out["shared_atomics"] += int(keep.sum())
        for j, rb, re in plan.slices:
            if j == ji:
                out["global_atomics"] += len(np.unique(b[rb:re][keep[rb:re]]))
    return out


def test_layout_counts_follow_the_plan():
    """Each job reads its key lane and the weights once and hashes each
    row once; each row that adds makes one shared atomic a plane; a
    block's flush makes at most one device atomic a shared one, and at
    least one for each nonzero bucket of the output."""
    geom = GEOMETRIES["no optional planes"]
    n = 20011
    lanes, w = _stream("zipf", n, seed=5)
    plan = K.launch_plan(geom.planes, n, H100_SMS)
    counts = layout_counts(plan, lanes, w, geom)
    assert counts["bytes_read"] == 8 * n * len(plan.jobs) and len(plan.jobs) == 2 * 2 + 1 + 1
    assert counts["shared_atomics"] == int((w != 0).sum()) * len(geom.planes)
    nonzero = int((_plain(geom, lanes, w) != 0).sum())
    assert nonzero <= counts["global_atomics"] <= counts["shared_atomics"]
    assert counts["global_atomics"] > nonzero  # the blocks of a job share buckets


def test_layout_counts_at_production():
    """The per-call counts of K2 and K1 that the source note and PERF.md
    give, at the production geometry on the zipf stream chip_smoke.py
    times the kernels on (ragged tail, every 7th weight 3 and every 13th
    0; its DDSketch edge values left out)."""
    host = ZipfFoldedSource(43).generate(BATCH, valid=BATCH - 4321)
    host[WEIGHTS, ::7] *= 3
    host[WEIGHTS, ::13] = 0
    keys = [host[j] for j in (HH, DISTINCT, DIST, VALUES)]
    w = host[WEIGHTS].view(np.int32)
    k2 = layout_counts(K.launch_plan(PRODUCTION.planes, BATCH, H100_SMS), keys, w, PRODUCTION)
    k1 = layout_counts(K.launch_plan((hist_plane(12),), BATCH, H100_SMS), [host[DIST]] * 4, w)
    assert k2 == {"bytes_read": 29360128, "hashes": 3670016, "shared_atomics": 1870848,
                  "global_atomics": 313638}
    assert k1 == {"bytes_read": 1048576, "hashes": 131072, "shared_atomics": 117000,
                  "global_atomics": 40471}
