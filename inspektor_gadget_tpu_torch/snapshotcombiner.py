"""SnapshotCombiner: TTL-based per-node snapshot cache.

Reference contract: pkg/snapshotcombiner/snapshotcombiner.go — AddSnapshot
:56 stores the latest row-array per node with a TTL measured in ticks;
GetSnapshots :79 merges all live nodes' arrays and ages entries out after
`ttl_ticks` ticks without refresh (so a dead node's rows vanish from the
cluster view after N intervals). Used by the fan-out runtime for `top`
gadgets (grpc-runtime.go:196-202).

The sketch plane supersedes this for mergeable state (the cluster
merge); this class covers the exact-row path.

The port's copy of ``inspektor_gadget_tpu/snapshotcombiner.py``.
"""

from __future__ import annotations

import threading
from typing import Generic, TypeVar

T = TypeVar("T")


class SnapshotCombiner(Generic[T]):
    def __init__(self, ttl_ticks: int = 2):
        self.ttl_ticks = ttl_ticks
        self._mu = threading.Lock()
        self._snapshots: dict[str, tuple[int, list[T]]] = {}  # node → (age, rows)

    def add_snapshot(self, key: str, rows: list[T]) -> None:
        with self._mu:
            self._snapshots[key] = (0, list(rows))

    def get_snapshots(self) -> list[T]:
        """Merge all live snapshots and advance ages (one call = one tick)."""
        out: list[T] = []
        with self._mu:
            dead = []
            for key, (age, rows) in self._snapshots.items():
                out.extend(rows)
                if age + 1 >= self.ttl_ticks:
                    dead.append(key)
                else:
                    self._snapshots[key] = (age + 1, rows)
            for key in dead:
                del self._snapshots[key]
        return out

    def keys(self) -> list[str]:
        with self._mu:
            return list(self._snapshots)
