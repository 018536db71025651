"""Pinned host staging for the sketch-ingest hot path (PyTorch port of
``inspektor_gadget_tpu/sources/staging.py``).

- PinnedBufferPool: reusable page-locked ``(lanes, capacity)`` uint32
  host tensors, filled in place through their ``.numpy()`` view. Reuse
  (a *hit*) keeps the allocator off the hot path.
- H2DStager: a depth-N ring that copies batch k+1 to the card on a side
  stream while the card computes batch k. A staged block goes back to
  the pool only once its consumer fence (a CUDA event recorded after the
  step that read it) has completed.

Both count into the telemetry registry, as the reference's do: pool hits
and misses (``ig_ingest_pool_{hits,misses}_total``) and the transfers
not yet fenced (``ig_ingest_h2d_inflight``), labelled by device lane;
the objects keep their own counts beside them. A stager given a
`PipelineStats` counts each stage() as a starved tick, when the slot it
lands on is free or its fence has completed (the card drained it, so the
host sets the pace), or as a saturated tick, when the fence is still
pending and the host waits on it (the wait is timed). The reference
counts every occupied slot as saturated whether or not its fence has
completed; its stall time is then what tells the two apart.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Sequence

import torch

from ..device import resolve_device
from ..telemetry import counter, gauge

_tm_pool_hits = counter("ig_ingest_pool_hits_total",
                        "staging blocks served from the pinned pool", ("lane",))
_tm_pool_misses = counter("ig_ingest_pool_misses_total",
                          "staging blocks freshly allocated (pool empty "
                          "or shape mismatch)", ("lane",))
_tm_inflight = gauge("ig_ingest_h2d_inflight",
                     "staged H2D transfers not yet fenced (double-buffer "
                     "occupancy)", ("lane",))


class PinnedBufferPool:
    """Free list of identically-shaped (lanes, capacity) uint32 blocks,
    page-locked when they feed a CUDA device."""

    def __init__(self, capacity: int, lanes: int = 3, max_free: int = 8,
                 device: str | torch.device = "cuda", lane: int | str = 0):
        self.capacity = int(capacity)
        self.lanes = int(lanes)
        self.max_free = int(max_free)
        self.pin = resolve_device(device).type == "cuda"
        self.lane = str(lane)
        self.hits = 0
        self.misses = 0
        self._tm_hits = _tm_pool_hits.labels(lane=self.lane)
        self._tm_misses = _tm_pool_misses.labels(lane=self.lane)
        self._free: list[torch.Tensor] = []
        self._mu = threading.Lock()

    def get(self) -> torch.Tensor:
        with self._mu:
            if self._free:
                self.hits += 1
                self._tm_hits.inc()
                return self._free.pop()
            self.misses += 1
        self._tm_misses.inc()
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
                 device: str | torch.device = "cuda", stats: Any | None = None):
        self.pool = pool
        self.depth = max(int(depth), 1)
        self.device = resolve_device(device)
        self.stats = stats  # a telemetry.PipelineStats, or None
        self._lane_i = int(pool.lane) if pool.lane.isdigit() else 0
        self._inflight = _tm_inflight.labels(lane=pool.lane)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._slots: list[tuple[torch.Tensor, Any] | None] = [None] * self.depth
        self._i = 0
        self.inflight = 0

    def _pending(self, slot: tuple[torch.Tensor, Any]) -> bool:
        """True while the slot's consumer has not finished with it: its
        fence (a CUDA event) has not completed, or it was never fenced on
        the card."""
        fence = slot[1]
        if fence is None:
            return self._copy_stream is not None
        return hasattr(fence, "query") and not fence.query()

    def stage(self, block: torch.Tensor, lanes: Sequence[torch.Tensor]) -> tuple:
        """Device copies (int32 bit views) of `lanes`, rows of `block`."""
        old = self._slots[self._i]
        if old is not None and self.stats is not None and self._pending(old):
            t0 = time.perf_counter()
            self._retire(old)
            self.stats.note_saturated(time.perf_counter() - t0, lane=self._lane_i)
        else:
            if old is not None:
                self._retire(old)
            if self.stats is not None:
                self.stats.note_starved(lane=self._lane_i)
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
        self._inflight.inc()
        self._slots[self._i] = (block, None)
        self._i = (self._i + 1) % self.depth
        if self.stats is not None:
            self.stats.note_occupancy("h2d", self.depth - self._slots.count(None),
                                      lane=self._lane_i)
        return devs

    def fence(self, token: Any) -> None:
        """Tie the most recently staged slot's release to `token`."""
        j = (self._i - 1) % self.depth
        slot = self._slots[j]
        if slot is not None:
            self._slots[j] = (slot[0], token)

    def _retire(self, slot: tuple[torch.Tensor, Any]) -> None:
        block, fence = slot
        if hasattr(fence, "synchronize"):  # a CUDA event
            fence.synchronize()
        elif fence is None and self._copy_stream is not None:
            # never fenced: wait for everything queued so far instead
            torch.cuda.current_stream(self.device).synchronize()
        self.inflight -= 1
        self._inflight.dec()
        self.pool.put(block)

    def drain(self) -> None:
        """Wait on every outstanding fence and return all blocks."""
        for j, slot in enumerate(self._slots):
            if slot is not None:
                self._retire(slot)
                self._slots[j] = None
        if self.stats is not None:
            self.stats.note_occupancy("h2d", 0, lane=self._lane_i)
