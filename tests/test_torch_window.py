"""The port's windowed count-min and the tpusketch operator's two window
steps against the JAX package's, on the CPU.

The same seeded batches go through the reference's `wcms_update` and
`hll_update` (as ``operators/tpusketch.py:165-172`` call them) and the
port's `wcms_ingest_step` and `hll_ingest_step`, with `wcms_advance`
between epochs until the ring has wrapped round twice. After every step
the leaves (slots, epoch, HLL registers) must be identical, and
`wcms_query` must agree at every `last_k`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inspektor_gadget_tpu.ops import hll as RH
from inspektor_gadget_tpu.ops import window as R
from inspektor_gadget_tpu_torch.ops import hll as PH
from inspektor_gadget_tpu_torch.ops import window as P

torch.set_num_threads(2)


def _batch(rng, n):
    keys = (rng.zipf(1.3, n) % 300 + 1).astype(np.uint32) * np.uint32(2654435761)
    w = rng.choice(np.array([0, 1, 1, 3, 2**31 + 5], np.uint32), n)  # uint32 weights lane
    return keys, w


def _assert_same(pw, rw, ph=None, rh=None):
    assert np.array_equal(pw.slots.numpy(), np.asarray(rw.slots))
    assert pw.slots.dtype == torch.int32 and int(pw.epoch) == int(rw.epoch)
    if ph is not None:
        assert np.array_equal(ph.registers.numpy(), np.asarray(rh.registers))


@pytest.mark.parametrize("n_slots,depth,log2_width", [(4, 3, 8), (8, 4, 12), (3, 2, 6)])
def test_window_steps_match_reference_across_wrap_around(n_slots, depth, log2_width):
    rng = np.random.default_rng(n_slots * 100 + log2_width)
    rw = R.wcms_init(n_slots, depth, log2_width)
    pw = P.wcms_init(n_slots, depth, log2_width, device="cpu")
    rh, ph = RH.hll_init(10), PH.hll_init(10, device="cpu")
    probe = (np.arange(1, 301, dtype=np.uint32) * np.uint32(2654435761))
    for epoch in range(2 * n_slots + 1):
        for _ in range(2):
            keys, w = _batch(rng, 257)
            kj, wj = jnp.asarray(keys), jnp.asarray(w)
            rw = R.wcms_update(rw, kj, wj.astype(jnp.int32))  # tpusketch.py:166
            rh = RH.hll_update(rh, kj, wj > 0)                # tpusketch.py:171
            kt = torch.from_numpy(keys.view(np.int32))        # the staged int32 bit view
            wt = torch.from_numpy(w.view(np.int32))
            assert P.wcms_ingest_step(pw, kt, wt) is None
            assert P.hll_ingest_step(ph, kt, wt) is None
            _assert_same(pw, rw, ph, rh)
        for last_k in [None, *range(1, n_slots + 2)]:
            want = np.asarray(R.wcms_query(rw, jnp.asarray(probe), last_k))
            got = P.wcms_query(pw, torch.from_numpy(probe), last_k)
            assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), last_k
        rw, pw = R.wcms_advance(rw), P.wcms_advance(pw)
        _assert_same(pw, rw)
        if epoch % 3 == 2:  # a window boundary: a fresh window HLL
            rh, ph = RH.hll_init(10), PH.hll_init(10, device="cpu")


def test_windowed_cms_update_without_weights_and_merge():
    rng = np.random.default_rng(9)
    ra, rb = R.wcms_init(4, 2, 7), R.wcms_init(4, 2, 7)
    pa, pb = (P.wcms_init(4, 2, 7, device="cpu") for _ in range(2))
    for i in range(6):
        keys, _ = _batch(rng, 100)
        ra = R.wcms_update(ra, jnp.asarray(keys))
        rb = R.wcms_update(rb, jnp.asarray(keys[::-1].copy()))
        P.wcms_update(pa, torch.from_numpy(keys))
        P.wcms_update(pb, torch.from_numpy(keys[::-1].copy()))
        if i % 2:
            ra, rb = R.wcms_advance(ra), R.wcms_advance(rb)
            P.wcms_advance(pa)
            P.wcms_advance(pb)
    _assert_same(pa, ra)
    _assert_same(P.wcms_merge(pa, pb), R.wcms_merge(ra, rb))
