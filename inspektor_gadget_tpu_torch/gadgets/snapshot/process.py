"""snapshot/process — one-shot process listing.

Reference: pkg/gadgets/snapshot/process (BPF task iterator
process-collector.bpf.c with procfs fallback, tracer.go `runeBPFCollector`
:68 / `runProcfsCollector` :223). Here the collector walks /proc directly
(the fallback path is the native path in this environment), honoring the
container mntns filter and the show-threads param. It emits no batches,
so the sketch plane does not run on it.

The port's copy of ``inspektor_gadget_tpu/gadgets/snapshot/process.py``.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

from ...columns import col
from ...params import ParamDesc, ParamDescs, TypeHint
from ...types import Event, WithMountNsID
from ..interface import GadgetDesc, GadgetType
from ..registry import register


@dataclasses.dataclass
class ProcessEvent(Event, WithMountNsID):
    pid: int = col(0, template="pid", dtype=np.int32)
    tid: int = col(0, template="pid", hide=True, dtype=np.int32)
    ppid: int = col(0, template="pid", dtype=np.int32)
    uid: int = col(0, template="uid", dtype=np.int32)
    comm: str = col("", template="comm")


def _stat_fields(pid: int) -> tuple[int, int] | None:
    """(ppid, uid) from /proc/<pid>/status."""
    try:
        ppid = uid = 0
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("PPid:"):
                    ppid = int(line.split()[1])
                elif line.startswith("Uid:"):
                    uid = int(line.split()[1])
        return ppid, uid
    except (OSError, ValueError, IndexError):
        return None


def _mntns(pid: int) -> int:
    try:
        m = re.search(r"\[(\d+)\]", os.readlink(f"/proc/{pid}/ns/mnt"))
        return int(m.group(1)) if m else 0
    except OSError:
        return 0


class SnapshotProcess:
    def __init__(self, ctx):
        self.ctx = ctx
        p = ctx.gadget_params
        self.show_threads = (p.get("threads").as_bool()
                             if "threads" in p else False)
        self._mntns_filter: set[int] | None = None
        self._array_handler = None

    def set_mntns_filter(self, mntns_ids: set[int] | None) -> None:
        self._mntns_filter = mntns_ids

    def set_event_handler_array(self, handler) -> None:
        # one-shot gadgets deliver events through the combiner path
        # (ref: parser.EnableCombiner, grpc-runtime.go:204-207)
        self._array_handler = handler

    def run_with_result(self, ctx) -> bytes:
        ctx.result = self.collect()
        if self._array_handler is not None:
            self._array_handler(ctx.result)
            return b""
        from ..render import render_result
        return render_result(ctx, ctx.result)

    def run(self, ctx) -> None:
        self.run_with_result(ctx)

    def collect(self) -> list[ProcessEvent]:
        rows: list[ProcessEvent] = []
        try:
            pids = sorted(int(d) for d in os.listdir("/proc") if d.isdigit())
        except OSError:
            return rows
        for pid in pids:
            mntns = _mntns(pid)
            if self._mntns_filter is not None and mntns not in self._mntns_filter:
                continue
            st = _stat_fields(pid)
            if st is None:
                continue
            try:
                with open(f"/proc/{pid}/comm") as f:
                    comm = f.read().strip()
            except OSError:
                continue
            rows.append(ProcessEvent(pid=pid, tid=pid, ppid=st[0], uid=st[1],
                                     comm=comm, mountnsid=mntns))
            if self.show_threads:
                try:
                    tids = [int(t) for t in os.listdir(f"/proc/{pid}/task")]
                except OSError:
                    tids = []
                for tid in tids:
                    if tid == pid:
                        continue
                    rows.append(ProcessEvent(pid=pid, tid=tid, ppid=st[0],
                                             uid=st[1], comm=comm,
                                             mountnsid=mntns))
        return rows


@register
class SnapshotProcessDesc(GadgetDesc):
    name = "process"
    category = "snapshot"
    gadget_type = GadgetType.ONE_SHOT
    description = "List running processes"
    event_cls = ProcessEvent

    def params(self) -> ParamDescs:
        return ParamDescs([
            ParamDesc(key="threads", default="false", type_hint=TypeHint.BOOL,
                      description="include threads"),
        ])

    def new_instance(self, ctx) -> SnapshotProcess:
        return SnapshotProcess(ctx)
