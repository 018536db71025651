"""The port's invertible decode against the JAX package's, on the CPU.

Each state is built by the reference's `inv_update` from a seeded
stream and handed to both packages leaf for leaf. The port's
`inv_decode_device` (a torch loop) must give the reference's residual
(count, keysum, fpsum), buffer (keys, counts) and fill n exactly, and
`inv_decode_finish` and `inv_decode` every `InvDecode` field: under the
peeling capacity (complete), over it (partial), with even counts up to
2**_MAX_EVEN_T (the host finisher's enumeration), with more pure buckets
than the buffer holds, and with key*weight sums that wrap mod 2**32.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inspektor_gadget_tpu.ops import invertible as R
from inspektor_gadget_tpu_torch.ops import invertible as P

torch.set_num_threads(2)

ROWS, LB = 3, 10  # capacity 768


def _stream(seed: int, n_keys: int, n: int, *, even: bool = False, wrap: bool = False,
            uniform: bool = False):
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2**32, n_keys, dtype=np.uint32)
    if wrap:  # keys near 2**32 and large weights: key*w wraps many times over
        keys = (np.uint32(2**32 - 1) - rng.integers(0, 2**20, n_keys).astype(np.uint32))
    if uniform:
        ks = keys[rng.integers(0, n_keys, n)]
    else:
        ks = keys[np.minimum(rng.zipf(1.3, n), n_keys) - 1]
    w = rng.integers(1, 4, n).astype(np.int32)
    if even:
        w = (w * (1 << rng.integers(0, P._MAX_EVEN_T + 1, n))).astype(np.int32)
    if wrap:
        w = rng.integers(1000, 5000, n).astype(np.int32)
    return ks, w


def _states(seed, n_keys, n=20000, **kw):
    ks, w = _stream(seed, n_keys, n, **kw)
    ref = R.inv_update(R.inv_init(ROWS, LB), jnp.asarray(ks), jnp.asarray(w))
    port = P.InvSketch(count=torch.from_numpy(np.array(ref.count)),
                       keysum=torch.from_numpy(np.array(ref.keysum).astype(np.int64)),
                       fpsum=torch.from_numpy(np.array(ref.fpsum).astype(np.int64)),
                       log2_buckets=LB)
    tally: dict[int, int] = {}
    for k, c in zip(ks.tolist(), w.tolist()):
        tally[k] = tally.get(k, 0) + c
    return ref, port, tally


def _assert_device_equal(rd, pd):
    r_res, r_keys, r_cnts, r_n = rd
    p_res, p_keys, p_cnts, p_n = pd
    assert np.array_equal(np.asarray(r_res.count), p_res.count.numpy())
    assert np.array_equal(np.asarray(r_res.keysum).astype(np.int64), p_res.keysum.numpy())
    assert np.array_equal(np.asarray(r_res.fpsum).astype(np.int64), p_res.fpsum.numpy())
    assert np.array_equal(np.asarray(r_keys).astype(np.int64), p_keys.numpy())
    assert np.array_equal(np.asarray(r_cnts), p_cnts.numpy()) and p_cnts.dtype == torch.int32
    assert int(r_n) == int(p_n)


CASES = {  # name: (seed, distinct keys, stream options, sweeps, cap)
    "under capacity": (1, 300, {}, 2, 768),
    "over capacity": (2, 5000, {"uniform": True}, 2, 768),
    "even counts": (3, 200, {"even": True}, 2, 768),
    "more pure buckets than cap": (4, 600, {}, 4, 16),
    "keysum wraps": (5, 250, {"wrap": True}, 2, 768),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_matches_reference(name):
    seed, n_keys, opts, sweeps, cap = CASES[name]
    ref, port, tally = _states(seed, n_keys, **opts)
    rd = R.inv_decode_device(ref, sweeps=sweeps, cap=cap)
    pd = P.inv_decode_device(port, sweeps=sweeps, cap=cap)
    _assert_device_equal(rd, pd)
    a, b = R.inv_decode_finish(*rd), P.inv_decode_finish(*pd)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    full = P.inv_decode(port, device_sweeps=sweeps, cap=cap)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        R.inv_decode(ref, device_sweeps=sweeps, cap=cap))
    for k, c in b.keys:  # every recovered count is exact
        assert tally[k] == c
    if name == "under capacity":
        assert b.complete and b.recovered == len(tally) and b.residual_events == 0
    if name == "over capacity":
        assert not b.complete and 0 < b.recovered < len(tally)
    if name == "even counts":  # the host finisher recovers even-count keys
        dev_keys = set(pd[1][:int(pd[3])].tolist())
        assert any(c % 2 == 0 and k not in dev_keys for k, c in b.keys)
    if name == "more pure buckets than cap":
        assert int(pd[3]) == cap and b.recovered > cap
    assert port.count.abs().sum() > 0  # the device loop left the state as it was


def test_decode_host_only_and_helpers_match_reference():
    ref, port, _ = _states(6, 500)
    lanes = (np.array(ref.count), np.array(ref.keysum), np.array(ref.fpsum))
    assert dataclasses.asdict(P.inv_decode(lanes)) == dataclasses.asdict(R.inv_decode(lanes))
    c = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint32) | np.uint32(1)
    got = P.modinv32_odd(torch.from_numpy(c.astype(np.int64))).numpy()
    assert np.array_equal(got, np.asarray(R.modinv32_odd(jnp.asarray(c))).astype(np.int64))
    assert (c.astype(np.uint64) * got.astype(np.uint64) & 0xFFFFFFFF == 1).all()
    for rows, lb in ((3, 12), (2, 9), (5, 14)):
        assert P.inv_capacity(rows, lb) == R.inv_capacity(rows, lb)
        assert P.inv_bytes(rows, lb) == R.inv_bytes(rows, lb)
    assert P.inv_capacity(3, 12) == 3072  # the harvest's cap at the production geometry


def test_decode_of_port_updated_state_matches_reference():
    """The harvest's call (sweeps 2, cap min(4096, capacity)) on a state
    the port's own `inv_update` built."""
    ks, w = _stream(7, 900, 30000)
    ref = R.inv_update(R.inv_init(ROWS, LB), jnp.asarray(ks), jnp.asarray(w))
    port = P.inv_update(P.inv_init(ROWS, LB, device="cpu"), torch.from_numpy(ks),
                        torch.from_numpy(w))
    cap = min(4096, P.inv_capacity(ROWS, LB))
    rd = R.inv_decode_device(ref, sweeps=2, cap=cap)
    pd = P.inv_decode_device(port, sweeps=2, cap=cap)
    _assert_device_equal(rd, pd)
    assert dataclasses.asdict(R.inv_decode_finish(*rd)) == \
        dataclasses.asdict(P.inv_decode_finish(*pd))
