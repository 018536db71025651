"""The port's staging ring, synthetic source and device resolution, on
the CPU: blocks recycle through the pool, the fence releases them, the
source is seeded and hashes like the JAX package, and asking for CUDA
where there is none raises instead of falling back."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from inspektor_gadget_tpu.columns.columns import fnv1a64 as ref_fnv1a64
from inspektor_gadget_tpu.ops.hashing import fold64_to_32 as ref_fold
from inspektor_gadget_tpu_torch import device as D
from inspektor_gadget_tpu_torch.ops import bundle_ingest_step, bundle_init, bundle_to_numpy
from inspektor_gadget_tpu_torch.sources import H2DStager, PinnedBufferPool, ZipfFoldedSource
from inspektor_gadget_tpu_torch.sources import synthetic as S


def test_pool_hits_misses_and_bounds():
    pool = PinnedBufferPool(64, lanes=2, max_free=2, device="cpu")
    assert not pool.pin
    a, b, c = pool.get(), pool.get(), pool.get()
    assert (pool.hits, pool.misses) == (0, 3)
    assert a.dtype == torch.uint32 and tuple(a.shape) == (2, 64)
    for blk in (a, b, c):
        pool.put(blk)
    assert pool.free_blocks() == 2           # max_free bounds the free list
    pool.put(torch.empty((3, 64), dtype=torch.uint32))
    assert pool.free_blocks() == 2           # a foreign shape is dropped
    assert pool.get() is b                   # last returned, first reused
    assert pool.hits == 1


def test_stager_recycles_blocks_behind_their_fence():
    pool = PinnedBufferPool(32, lanes=2, max_free=8, device="cpu")
    st = H2DStager(pool, depth=2, device="cpu")
    blocks = []
    for i in range(2):
        blk = pool.get()
        blk.numpy()[:] = i
        blocks.append(blk)
        devs = st.stage(blk, (blk[0], blk[1]))
        assert devs[0].dtype == torch.int32 and int(devs[0][0]) == i
        st.fence(devs[0].sum())
    assert st.inflight == 2 and pool.free_blocks() == 0
    blk = pool.get()
    st.stage(blk, (blk[0],))                  # comes round to slot 0: retires it
    assert st.inflight == 2 and pool.free_blocks() == 1
    assert pool.get() is blocks[0]
    st.drain()
    assert st.inflight == 0 and pool.free_blocks() == 2


def test_staged_ingest_through_pool_and_stager_matches_direct_steps():
    """The main path at a tiny size: source -> pool -> stager -> step,
    against the same blocks stepped directly."""
    n = 512
    geom = dict(depth=2, log2_width=8, hll_p=6, entropy_log2_width=6, k=8,
                inv_rows=1, inv_log2_buckets=6, quantiles=True)
    src, src2 = ZipfFoldedSource(7), ZipfFoldedSource(7)
    pool = PinnedBufferPool(n, lanes=S.LANES, device="cpu")
    st = H2DStager(pool, depth=3, device="cpu")
    staged = bundle_init(**geom, device="cpu")
    direct = bundle_init(**geom, device="cpu")
    for step in range(5):
        blk = pool.get()
        src.fill(blk.numpy(), valid=n - step)
        hh, di, dd, w, v = st.stage(blk, tuple(blk[j] for j in range(S.LANES)))
        staged, fence = bundle_ingest_step(staged, hh, di, dd, w, values=v)
        st.fence(fence)
        ref = torch.from_numpy(src2.generate(n, valid=n - step).view(np.int32))
        bundle_ingest_step(direct, ref[0], ref[1], ref[2], ref[3], values=ref[4])
    st.drain()
    # depth + 1 blocks in all: the block for a step is taken before its
    # stage() retires the oldest slot
    assert (pool.misses, pool.hits) == (4, 1) and st.inflight == 0
    for a, b in zip(bundle_to_numpy(staged), bundle_to_numpy(direct)):
        assert np.array_equal(a, b)
    assert float(staged.events) == sum(n - s for s in range(5))


def test_zipf_source_is_seeded_and_hashes_like_the_reference():
    a, b = ZipfFoldedSource(3).generate(4096), ZipfFoldedSource(3).generate(4096)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, ZipfFoldedSource(4).generate(4096))
    for name in ("proc-0", "proc-4999", "ü"):
        assert S.fnv1a64(name) == ref_fnv1a64(name)
    keys = ref_fold(np.array([ref_fnv1a64(f"proc-{i}") for i in range(5000)], np.uint64))
    assert np.isin(a[S.HH], keys).all() and np.array_equal(a[S.DIST], a[S.HH])
    top = np.bincount(np.searchsorted(np.sort(keys), a[S.HH]), minlength=5000).max()
    assert top > 4096 * 0.15                  # zipf s=1.2: the top name is ~1/4 of events
    assert (a[S.WEIGHTS] == 1).all() and (a[S.VALUES] == 0).any()
    ragged = ZipfFoldedSource(3).generate(64, valid=50)
    assert (ragged[S.WEIGHTS, 50:] == 0).all() and (ragged[S.WEIGHTS, :50] == 1).all()


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        D.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        bundle_init(depth=1, log2_width=4, hll_p=4, entropy_log2_width=4, k=2)
    with pytest.raises(RuntimeError):
        PinnedBufferPool(16)
    with pytest.raises(ValueError):
        D.resolve_device("mps")
    assert D.resolve_device("cpu").type == "cpu"
    assert D.device_report("cpu")["platform"] == "cpu"
