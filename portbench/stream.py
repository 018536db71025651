"""The benchmark's event generator: seeded NumPy, no device.

The key arithmetic is the repository's zipf stream: a vocabulary of
names ``<prefix><i>`` drawn zipf with exponent s, each name FNV-1a-64
hashed into the wire's ``key_hash`` column. Each event also carries a
container (its mount namespace: the name's index modulo the
configuration's containers where ``container_of`` is ``name``, else
drawn zipf over them), a pid, a uid, a kind from the gadget's kinds and, where the
configuration asks for one, a log-normal latency in ``aux1``.

`EventPool` is the seeded set of events a run draws from; `BacklogFeed`
and `OpenLoopFeed` hand its events to the gadget's run loop as
`EventBatch` objects through ``pop()``, and log every batch they hand
over, so the reference folds exactly the same events.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

MNTNS_BASE = 4026531840  # the first mount namespace inode of a host
U64 = np.uint64


def fnv1a64_names(prefix: str, count: int) -> np.ndarray:
    """FNV-1a-64 of ``prefix + str(i)`` for i in [0, count), as uint64,
    one NumPy pass a byte position."""
    names = [f"{prefix}{i}".encode() for i in range(count)]
    width = max(len(n) for n in names)
    buf = np.zeros((count, width), np.uint8)
    lens = np.fromiter((len(n) for n in names), np.int64, count)
    flat = b"".join(n.ljust(width, b"\0") for n in names)
    buf[:] = np.frombuffer(flat, np.uint8).reshape(count, width)
    h = np.full(count, 0xCBF29CE484222325, U64)
    prime = U64(0x100000001B3)
    with np.errstate(over="ignore"):
        for j in range(width):
            live = lens > j
            nxt = (h ^ buf[:, j].astype(U64)) * prime
            h = np.where(live, nxt, h)
    return h


def zipf_cdf(count: int, s: float) -> np.ndarray:
    pmf = np.arange(1, count + 1, dtype=np.float64) ** (-s)
    return np.cumsum(pmf / pmf.sum())


def zipf_draw(rng: np.random.Generator, cdf: np.ndarray, n: int) -> np.ndarray:
    return np.minimum(np.searchsorted(cdf, rng.random(n)), len(cdf) - 1)


@dataclasses.dataclass
class EventPool:
    """`size` seeded events in wire columns (uint64 or uint32 arrays)."""

    cols: dict[str, np.ndarray]
    size: int
    key_index: np.ndarray      # each event's vocabulary index
    vocab_hashes: np.ndarray   # the vocabulary's uint64 key hashes

    @classmethod
    def make(cls, stream: dict, seed: int, size: int) -> "EventPool":
        """The pool of a configuration's ``stream`` block: the same seed
        gives the same events."""
        rng = np.random.default_rng([seed, 0x5EED])
        hashes = fnv1a64_names(stream["name_prefix"], int(stream["keys"]))
        key = zipf_draw(rng, zipf_cdf(int(stream["keys"]), float(stream["zipf_s"])), size)
        if stream.get("container_of") == "name":
            # each name runs in one container: name i in container i mod n
            cont = key % int(stream["containers"])
        else:
            cont = zipf_draw(rng, zipf_cdf(int(stream["containers"]),
                                           float(stream["container_zipf_s"])), size)
        kinds = np.asarray(stream["kinds"], np.uint32)
        cols = {
            "ts": np.zeros(size, U64),
            "key_hash": hashes[key],
            "aux1": np.zeros(size, U64),
            "aux2": np.zeros(size, U64),
            "mntns": U64(MNTNS_BASE) + cont.astype(U64),
            "pid": rng.integers(1000, 51000, size, dtype=np.uint32),
            "ppid": np.ones(size, np.uint32),
            "uid": rng.integers(0, 4, size, dtype=np.uint32),
            "kind": kinds[rng.integers(0, len(kinds), size)],
        }
        lat = stream.get("latency_ns")
        if lat:
            v = rng.lognormal(np.log(float(lat["median"])), float(lat["sigma"]), size)
            cols["aux1"] = np.minimum(v, 2.0 ** 32 - 1).astype(U64)
        return cls(cols=cols, size=size, key_index=key.astype(np.int64), vocab_hashes=hashes)

    def rows(self, start: int, n: int) -> dict[str, np.ndarray]:
        """Events [start, start + n) of the endless stream that cycles
        the pool, as fresh arrays."""
        idx = (np.arange(start, start + n, dtype=np.int64) % self.size)
        return {name: col[idx] for name, col in self.cols.items()}

    def key_rows(self, start: int, n: int) -> np.ndarray:
        """The vocabulary index of events [start, start + n)."""
        return self.key_index[np.arange(start, start + n, dtype=np.int64) % self.size]


def event_batch(batch_cls, cols: dict[str, np.ndarray], capacity: int):
    """An `EventBatch` of `capacity` rows holding `cols` (no comm lane)."""
    n = len(cols["ts"])
    b = batch_cls.alloc(capacity, with_comm=False)
    for name, col in cols.items():
        b.cols[name][:n] = col
    b.count = n
    return b


class StreamLog:
    """What a feed handed to the run loop: each batch's first stream
    event, its event count and the upstream drops it reported."""

    def __init__(self) -> None:
        self.starts: list[int] = []
        self.counts: list[int] = []
        self.drops: list[int] = []

    def add(self, start: int, n: int, drops: int) -> None:
        self.starts.append(start)
        self.counts.append(n)
        self.drops.append(drops)

    def __len__(self) -> int:
        return len(self.starts)


class BacklogFeed:
    """Closed loop: the next batch is always ready. The pool holds
    `pool_batches` batches of `batch` events made in set-up; batch i is
    the pool's batch i mod pool_batches, so stream event j is pool row
    j mod pool size."""

    def __init__(self, pool: EventPool, batch: int, batch_cls) -> None:
        self.pool = pool
        self.batch = batch
        self.log = StreamLog()
        nb = pool.size // batch
        self._batches = [event_batch(batch_cls, pool.rows(i * batch, batch), batch)
                         for i in range(nb)]
        self._next = 0

    def next_batch(self):
        i = self._next
        self._next += 1
        b = self._batches[i % len(self._batches)]
        b.seq = i * self.batch
        now = time.time()
        b.pop_ts = b.oldest_ts = now
        self.log.add(i * self.batch, self.batch, 0)
        return b


class OpenLoopFeed:
    """Open loop: chunks of `chunk` events fall due on a Poisson schedule
    at `rate` events/s from the seed, whether or not the system keeps up.
    A pop takes every due chunk, oldest first, up to `pop_max` events.
    The queue of due, unpopped chunks holds at most `queue_max` events;
    a chunk that falls due when it is full is dropped (counted in the
    batches' cumulative ``drops`` and in `dropped`)."""

    def __init__(self, pool: EventPool, *, chunk: int, rate: float, pop_max: int,
                 queue_max: int, horizon_s: float, seed: int, batch_cls) -> None:
        self.pool = pool
        self.chunk = chunk
        self.pop_max = pop_max
        self.queue_max_chunks = queue_max // chunk
        self.batch_cls = batch_cls
        rng = np.random.default_rng([seed, 0xA881])
        mean_gap = chunk / rate
        n = int(horizon_s / mean_gap * 1.2) + 64
        self.offsets = np.cumsum(rng.exponential(mean_gap, n))  # seconds after t0
        self.t0 = 0.0
        self.base = 0            # stream chunks the warm-up took before the schedule
        self.limit = n           # chunks past this index are never offered
        self.log = StreamLog()
        self.next_due = 0        # chunks [0, next_due) have fallen due
        self.queue: list[int] = []  # due, unpopped, not dropped
        self.dropped: list[int] = []
        self.pop_t = np.full(n, np.nan)   # host clock of each chunk's pop
        self.batch_of = np.full(n, -1, np.int64)
        self.depth_at_pop: list[tuple[float, int]] = []

    def start(self, t0: float) -> None:
        self.t0 = t0

    def ready_batch(self):
        """Set-up: a full pop of the stream's next chunks, handed over at
        once, before the schedule starts."""
        k = self.pop_max // self.chunk
        start = self.base * self.chunk
        self.base += k
        b = event_batch(self.batch_cls, self.pool.rows(start, k * self.chunk), self.pop_max)
        b.seq = start
        b.pop_ts = b.oldest_ts = time.time()
        self.log.add(start, k * self.chunk, 0)
        return b

    def due(self, j: int) -> float:
        return self.t0 + float(self.offsets[j])

    def _advance(self, now: float) -> None:
        rel = now - self.t0
        hi = min(int(np.searchsorted(self.offsets, rel, side="right")), self.limit)
        for j in range(self.next_due, hi):
            if len(self.queue) < self.queue_max_chunks:
                self.queue.append(j)
            else:
                self.dropped.append(j)
        self.next_due = max(self.next_due, hi)

    def next_batch(self):
        """The due chunks as one batch, or None when none is due."""
        now = time.perf_counter()
        self._advance(now)
        self.depth_at_pop.append((now, len(self.queue)))
        take = self.queue[:self.pop_max // self.chunk]
        if not take:
            return None
        del self.queue[:len(take)]
        # the chunks of one pop are consecutive stream chunks unless a
        # drop fell between them: split there, the rest waits a pop
        run = 1
        while run < len(take) and take[run] == take[0] + run:
            run += 1
        if run < len(take):
            self.queue[:0] = take[run:]
            take = take[:run]
        start = (self.base + take[0]) * self.chunk
        n = len(take) * self.chunk
        b = event_batch(self.batch_cls, self.pool.rows(start, n), self.pop_max)
        b.seq = start
        b.drops = len(self.dropped) * self.chunk
        b.pop_ts = time.time()
        b.oldest_ts = b.pop_ts - max(now - self.due(take[0]), 0.0)
        self.pop_t[take] = now
        self.batch_of[take] = len(self.log)
        self.log.add(start, n, b.drops)
        return b
