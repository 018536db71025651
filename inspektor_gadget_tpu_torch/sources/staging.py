"""Pinned host staging for the sketch-ingest hot path (PyTorch port of
``inspektor_gadget_tpu/sources/staging.py``).

- PinnedBufferPool: reusable page-locked ``(lanes, capacity)`` uint32
  host tensors, filled in place through their ``.numpy()`` view. Reuse
  (a *hit*) keeps the allocator off the hot path.
- H2DStager: a depth-N ring that copies batch k+1 to the card on a side
  stream while the card computes batch k. A staged block goes back to
  the pool only once its consumer fence (a CUDA event recorded after the
  step that read it) has completed.

Hit, miss and in-flight counts are plain integers on the objects.
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

import torch

from ..device import resolve_device


class PinnedBufferPool:
    """Free list of identically-shaped (lanes, capacity) uint32 blocks,
    page-locked when they feed a CUDA device."""

    def __init__(self, capacity: int, lanes: int = 3, max_free: int = 8,
                 device: str | torch.device = "cuda"):
        self.capacity = int(capacity)
        self.lanes = int(lanes)
        self.max_free = int(max_free)
        self.pin = resolve_device(device).type == "cuda"
        self.hits = 0
        self.misses = 0
        self._free: list[torch.Tensor] = []
        self._mu = threading.Lock()

    def get(self) -> torch.Tensor:
        with self._mu:
            if self._free:
                self.hits += 1
                return self._free.pop()
            self.misses += 1
        return torch.empty((self.lanes, self.capacity), dtype=torch.uint32,
                           pin_memory=self.pin)

    def put(self, block: torch.Tensor) -> None:
        if tuple(block.shape) != (self.lanes, self.capacity):
            return  # shape changed mid-run: drop, don't poison
        with self._mu:
            if len(self._free) < self.max_free:
                self._free.append(block)

    def free_blocks(self) -> int:
        with self._mu:
            return len(self._free)


class H2DStager:
    """Depth-N staged host-to-device ring.

    stage(block, lanes) issues the copy of each host lane on the side
    stream, makes the current stream wait for it, and parks the block in
    a ring slot; fence(token) ties the newest slot's release to the
    consumer's fence. A slot is retired (its fence waited on, its block
    returned to the pool) when the ring comes round to it again, so the
    host runs at most `depth` batches ahead of the card.
    """

    def __init__(self, pool: PinnedBufferPool, depth: int = 2,
                 device: str | torch.device = "cuda"):
        self.pool = pool
        self.depth = max(int(depth), 1)
        self.device = resolve_device(device)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._slots: list[tuple[torch.Tensor, Any] | None] = [None] * self.depth
        self._i = 0
        self.inflight = 0

    def stage(self, block: torch.Tensor, lanes: Sequence[torch.Tensor]) -> tuple:
        """Device copies (int32 bit views) of `lanes`, rows of `block`."""
        old = self._slots[self._i]
        if old is not None:
            self._retire(old)
        views = [lane.view(torch.int32) for lane in lanes]
        if self._copy_stream is None:
            # the CPU "device" aliases the host block, as the reference's
            # CPU backend may: the fence still guards its reuse
            devs = tuple(views)
        else:
            consumer = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                devs = tuple(v.to(self.device, non_blocking=True) for v in views)
            consumer.wait_stream(self._copy_stream)
            for d in devs:
                d.record_stream(consumer)
        self.inflight += 1
        self._slots[self._i] = (block, None)
        self._i = (self._i + 1) % self.depth
        return devs

    def fence(self, token: Any) -> None:
        """Tie the most recently staged slot's release to `token`."""
        j = (self._i - 1) % self.depth
        slot = self._slots[j]
        if slot is not None:
            self._slots[j] = (slot[0], token)

    def _retire(self, slot: tuple[torch.Tensor, Any]) -> None:
        block, fence = slot
        if isinstance(fence, torch.cuda.Event):
            fence.synchronize()
        elif fence is None and self._copy_stream is not None:
            # never fenced: wait for everything queued so far instead
            torch.cuda.current_stream(self.device).synchronize()
        self.inflight -= 1
        self.pool.put(block)

    def drain(self) -> None:
        """Wait on every outstanding fence and return all blocks."""
        for j, slot in enumerate(self._slots):
            if slot is not None:
                self._retire(slot)
                self._slots[j] = None
