"""The PyTorch port's hashing against the JAX package's, bit for bit.

The same numpy-seeded keys go through both; every hash and bucket index
must match exactly, since every merge between the two depends on it.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from inspektor_gadget_tpu.ops import hashing as ref
from inspektor_gadget_tpu_torch.ops import hashing as port

EDGE = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _keys(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE, rng.integers(0, 2**32, n, dtype=np.uint32)])


def _t(keys):
    return torch.from_numpy(keys)


def test_row_multiplier_matches_rows_0_to_20():
    for row in range(21):
        assert int(port._row_multiplier(row)) == int(ref._row_multiplier(row)), row


def test_fmix32_matches_on_edge_and_random_keys():
    keys = _keys()
    want = np.asarray(ref.fmix32(jnp.asarray(keys)))
    got = port.fmix32(_t(keys)).numpy()
    assert np.array_equal(got.astype(np.uint32), want)
    assert np.array_equal(port.fmix32_np(keys), ref.fmix32_np(keys))


@pytest.mark.parametrize("log2_width", [6, 9, 12, 16])
def test_row_hashes_match(log2_width):
    keys = _keys(seed=log2_width)
    want = np.asarray(ref.row_hashes(jnp.asarray(keys), 5, log2_width))
    got = port.row_hashes(_t(keys), 5, log2_width).numpy()
    assert np.array_equal(got, want.astype(np.int64))


def test_multiply_shift_beyond_the_seed_table():
    keys = _keys(seed=3)
    for row in (8, 13, 20):
        want = np.asarray(ref.multiply_shift(jnp.asarray(keys), row, 10))
        got = port.multiply_shift(_t(keys), row, 10).numpy()
        assert np.array_equal(got, want.astype(np.int64)), row


def test_lane_forms_agree():
    """uint32, its int32 bit view and the int64 lane hash alike."""
    keys = _keys(seed=4)
    t = _t(keys)
    a = port.fmix32(t)
    b = port.fmix32(t.view(torch.int32))
    c = port.fmix32(port.u32(t))
    assert torch.equal(a, b) and torch.equal(a, c)
    assert np.array_equal(port.bits32(port.u32(t)).numpy().view(np.uint32), keys)


def test_mul32_matches_uint32_wraparound():
    rng = np.random.default_rng(5)
    a = np.concatenate([EDGE, rng.integers(0, 2**32, 512, dtype=np.uint32)])
    b = np.concatenate([EDGE[::-1], rng.integers(0, 2**32, 512, dtype=np.uint32)])
    want = (a * b).astype(np.uint32)
    got = port.mul32(port.u32(_t(a)), port.u32(_t(b))).numpy()
    assert np.array_equal(got.astype(np.uint32), want)
    got_c = port.mul32(port.u32(_t(a)), 0xC2B2AE35).numpy()
    assert np.array_equal(got_c.astype(np.uint32), (a * np.uint32(0xC2B2AE35)).astype(np.uint32))


def test_fold64_to_32_matches():
    rng = np.random.default_rng(6)
    k = rng.integers(0, 2**63, 1000, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    assert np.array_equal(port.fold64_to_32(k), ref.fold64_to_32(k))
