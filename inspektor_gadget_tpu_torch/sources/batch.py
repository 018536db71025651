"""EventBatch and FoldedBatch: the struct-of-arrays units of transport
(the port's copy of ``inspektor_gadget_tpu/sources/batch.py``).

Fixed-capacity columnar batches with an explicit valid count and the
cumulative upstream loss counter, numpy only. A FoldedBatch's lanes are
the rows of one uint32 block; in the port that block is a pinned pool
block (a torch tensor), seen through its ``.numpy()`` view, and
`FoldedBatch.block` keeps the tensor for the stager.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

# the wire columns (native/events.h Event layout)
BATCH_COLUMNS: dict[str, np.dtype] = {
    "ts": np.dtype(np.uint64),
    "key_hash": np.dtype(np.uint64),
    "aux1": np.dtype(np.uint64),
    "aux2": np.dtype(np.uint64),
    "mntns": np.dtype(np.uint64),
    "pid": np.dtype(np.uint32),
    "ppid": np.dtype(np.uint32),
    "uid": np.dtype(np.uint32),
    "kind": np.dtype(np.uint32),
}


@dataclasses.dataclass
class EventBatch:
    cols: dict[str, np.ndarray]
    count: int                 # valid rows (the rest is padding)
    seq: int = 0               # first event's sequence number
    drops: int = 0             # cumulative upstream drops at pop time
    comm: np.ndarray | None = None  # (capacity, 8) uint8 display prefixes
    pop_ts: float = 0.0        # wall clock when the host popped the batch
    oldest_ts: float = 0.0     # oldest event timestamp in the batch

    @property
    def capacity(self) -> int:
        return len(next(iter(self.cols.values())))

    @classmethod
    def alloc(cls, capacity: int, with_comm: bool = True) -> "EventBatch":
        cols = {n: np.zeros(capacity, dtype=dt) for n, dt in BATCH_COLUMNS.items()}
        comm = np.zeros((capacity, 8), dtype=np.uint8) if with_comm else None
        return cls(cols=cols, count=0, comm=comm)



@dataclasses.dataclass
class FoldedBatch:
    """A pre-folded struct-of-arrays batch, filled by one native call
    (``ig_source_pop_folded``/``ig_source_pop_folded2``) into the rows of
    one (lanes >= 3, capacity) uint32 block: keys (the xor-folded key
    hash), weights (1 an event), mntns (the xor-folded mount namespace)
    and, for blocks popped with values, each event's magnitude (latency
    ns or bytes) for the DDSketch plane."""

    lanes: np.ndarray          # (>=3, capacity) uint32 view of the block
    count: int                 # valid rows (the rest is padding)
    seq: int = 0               # first event's sequence number
    drops: int = 0             # cumulative upstream drops at pop time
    has_values: bool = False   # row 3 filled by pop_folded2
    pop_ts: float = 0.0
    oldest_ts: float = 0.0     # the previous pop's clock: an upper bound
    block: Any = None          # the pool block `lanes` views, when it is a tensor

    @property
    def capacity(self) -> int:
        return self.lanes.shape[1]

    @property
    def keys(self) -> np.ndarray:
        return self.lanes[0]

    @property
    def weights(self) -> np.ndarray:
        return self.lanes[1]

    @property
    def mntns(self) -> np.ndarray:
        return self.lanes[2]

    @property
    def values(self) -> np.ndarray | None:
        """The per-event magnitude lane, or None for a batch popped
        without it."""
        if self.has_values and self.lanes.shape[0] >= 4:
            return self.lanes[3]
        return None
