"""Seeded synthetic source of folded key blocks (numpy, no device).

The stream the headline benchmark of the JAX package uses: comm-like
names ``proc-<i>`` over a vocabulary of 5000, drawn zipf with s = 1.2,
FNV-1a-64 hashed and xor-folded to uint32. `fill` writes one staging
block of five uint32 lanes:

  0 hh        folded key of the drawn name
  1 distinct  folded hash of (name, pid): the HLL stream
  2 dist      the same key as hh (the benchmark feeds one stream to all)
  3 weights   1 per event, 0 past `valid` (a ragged tail)
  4 values    a latency in nanoseconds, log-normal, ~1% exact zeros
"""

from __future__ import annotations

import numpy as np

from ..ops.hashing import fold64_to_32

LANES = 5
HH, DISTINCT, DIST, WEIGHTS, VALUES = range(LANES)


def fnv1a64(s: str | bytes) -> int:
    """FNV-1a 64-bit hash: the string-to-uint64 key lowering."""
    if isinstance(s, str):
        s = s.encode("utf-8", "replace")
    h = 0xCBF29CE484222325
    for b in s:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


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
