"""top/block-io — per-device block I/O per interval.

Reference: pkg/gadgets/top/block-io (biotop.bpf.c on block rq
issue/complete; per-(pid,disk) stats map drained per interval). Procfs
analogue: /proc/diskstats deltas per device — reads/writes completed,
sectors, io ticks; avg latency approximated from time_in_queue delta /
ios delta (the kernel's own accounting, fields 13-14).

The port's copy of ``inspektor_gadget_tpu/gadgets/top/block_io.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...columns import col
from ...params import ParamDescs
from ...types import Event
from ..interface import GadgetDesc, GadgetType
from ..interval_gadget import IntervalGadget, interval_params
from ..registry import register


@dataclasses.dataclass
class BlockIoStats(Event):
    device: str = col("", width=12)
    reads: int = col(0, width=8, group="sum", dtype=np.int64)
    writes: int = col(0, width=8, group="sum", dtype=np.int64)
    rbytes: int = col(0, width=12, group="sum", dtype=np.int64)
    wbytes: int = col(0, width=12, group="sum", dtype=np.int64)
    avg_ms: float = col(0.0, width=8, precision=2, dtype=np.float32)


def _read_diskstats() -> dict[str, tuple]:
    out: dict[str, tuple] = {}
    try:
        with open("/proc/diskstats") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 14:
                    continue
                name = parts[2]
                # skip partitions/loop/ram noise heuristically
                if name.startswith(("loop", "ram")):
                    continue
                reads, rsect = int(parts[3]), int(parts[5])
                writes, wsect = int(parts[7]), int(parts[9])
                ticks_ms = int(parts[12])
                queue_ms = int(parts[13])
                out[name] = (reads, rsect, writes, wsect, ticks_ms, queue_ms)
    except OSError:
        pass
    return out


class TopBlockIo(IntervalGadget):
    def setup(self, ctx) -> None:
        self._prev = _read_diskstats()

    def collect(self, ctx) -> list[BlockIoStats]:
        cur = _read_diskstats()
        rows = []
        for dev, now in cur.items():
            prev = self._prev.get(dev)
            if prev is None:
                continue
            dr, drs = now[0] - prev[0], now[1] - prev[1]
            dw, dws = now[2] - prev[2], now[3] - prev[3]
            dq = now[5] - prev[5]
            ios = dr + dw
            if ios == 0 and drs == 0 and dws == 0:
                continue
            rows.append(BlockIoStats(
                device=dev, reads=dr, writes=dw,
                rbytes=drs * 512, wbytes=dws * 512,
                avg_ms=(dq / ios) if ios else 0.0,
            ))
        self._prev = cur
        return rows


@register
class TopBlockIoDesc(GadgetDesc):
    name = "block-io"
    category = "top"
    gadget_type = GadgetType.TRACE_INTERVALS
    description = "Top block devices by I/O per interval"
    event_cls = BlockIoStats

    def params(self) -> ParamDescs:
        return interval_params("-rbytes,-wbytes")

    def new_instance(self, ctx) -> TopBlockIo:
        return TopBlockIo(ctx)
