"""Seeded synthetic sources (numpy, no device).

`PySyntheticSource` is the reference's pure-Python event source
(``inspektor_gadget_tpu/sources/synthetic.py``), the same stream per
seed: EventBatches of zipf-drawn names ``proc-<i>``, the gadgets'
``--source pysynthetic``.

`ZipfFoldedSource` makes folded key blocks. Its stream is the one the
headline benchmark of the JAX package uses: comm-like names
``proc-<i>`` over a vocabulary of 5000, drawn zipf with s = 1.2,
FNV-1a-64 hashed and xor-folded to uint32. `fill` writes one staging
block of five uint32 lanes:

  0 hh        folded key of the drawn name
  1 distinct  folded hash of (name, pid): the HLL stream
  2 dist      the same key as hh (the benchmark feeds one stream to all)
  3 weights   1 per event, 0 past `valid` (a ragged tail)
  4 values    a latency in nanoseconds, log-normal, ~1% exact zeros
"""

from __future__ import annotations

import time

import numpy as np

from ..columns.columns import fnv1a64
from ..ops.hashing import fold64_to_32
from .batch import EventBatch

LANES = 5
HH, DISTINCT, DIST, WEIGHTS, VALUES = range(LANES)


class ZipfFoldedSource:
    def __init__(self, seed: int, *, vocab: int = 5000, zipf_s: float = 1.2):
        self._rng = np.random.default_rng(seed)
        self._hashes = np.array([fnv1a64(f"proc-{i}") for i in range(vocab)],
                                dtype=np.uint64)
        self._keys = fold64_to_32(self._hashes)
        pmf = np.arange(1, vocab + 1, dtype=np.float64) ** (-zipf_s)
        self._cdf = np.cumsum(pmf / pmf.sum())

    def fill(self, block: np.ndarray, valid: int | None = None) -> None:
        """Write one (5, n) uint32 block in place; rows past `valid`
        weigh 0."""
        n = block.shape[1]
        rng = self._rng
        idx = np.minimum(np.searchsorted(self._cdf, rng.random(n)), len(self._cdf) - 1)
        block[HH] = self._keys[idx]
        pid = rng.integers(1000, 51000, n, dtype=np.uint64)
        block[DISTINCT] = fold64_to_32(self._hashes[idx] ^ (pid * np.uint64(0x9E3779B97F4A7C15)))
        block[DIST] = block[HH]
        block[WEIGHTS] = 1
        if valid is not None:
            block[WEIGHTS, valid:] = 0
        lat = rng.lognormal(np.log(50_000.0), 1.5, n)
        lat[rng.random(n) < 0.01] = 0.0
        block[VALUES] = np.minimum(lat, 2.0 ** 32 - 1).astype(np.uint32)

    def generate(self, n: int, valid: int | None = None) -> np.ndarray:
        block = np.empty((LANES, n), dtype=np.uint32)
        self.fill(block, valid)
        return block


class PySyntheticSource:
    """EventBatches of one kind, deterministic per seed: key hashes of
    zipf-drawn names, 64 mount namespaces, pids, uids 0-3 and random aux
    lanes. `ts`, `pop_ts` and `oldest_ts` are the wall clock."""

    def __init__(self, kind: int = 1, *, seed: int = 0, vocab: int = 1000,
                 zipf_s: float = 1.2, batch_size: int = 8192):
        self.kind = kind
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed or 42)
        self._names = [f"proc-{i}" for i in range(vocab)]
        self._hashes = np.array([fnv1a64(n) for n in self._names], dtype=np.uint64)
        pmf = np.arange(1, vocab + 1, dtype=np.float64) ** (-zipf_s)
        self._pmf = pmf / pmf.sum()
        self._vocab = {int(h): n for h, n in zip(self._hashes, self._names)}
        self._seq = 0

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def close(self) -> None:
        pass

    def generate(self, n: int | None = None) -> EventBatch:
        n = n or self.batch_size
        idx = self._rng.choice(len(self._pmf), size=n, p=self._pmf)
        b = EventBatch.alloc(n, with_comm=False)
        b.cols["ts"][:] = time.time_ns()
        b.cols["key_hash"][:] = self._hashes[idx]
        b.cols["mntns"][:] = np.uint64(4026531840) + (idx % 64).astype(np.uint64)
        b.cols["pid"][:] = self._rng.integers(1000, 51000, n, dtype=np.uint32)
        b.cols["uid"][:] = self._rng.integers(0, 4, n, dtype=np.uint32)
        b.cols["kind"][:] = self.kind
        b.cols["aux1"][:] = self._rng.integers(0, 2**63, n, dtype=np.uint64)
        b.cols["aux2"][:] = self._rng.integers(0, 2**16, n, dtype=np.uint64)
        b.count = n
        b.seq = self._seq
        self._seq += n
        # synthesis is the pop: both watermarks are one clock read
        b.pop_ts = b.oldest_ts = time.time()
        return b

    pop = generate

    def drops(self) -> int:
        return 0

    def vocab_lookup(self, key_hash: int) -> str:
        return self._vocab.get(int(key_hash), "")
