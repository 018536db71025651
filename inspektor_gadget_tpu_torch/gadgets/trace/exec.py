"""trace/exec — process execution events.

Reference: pkg/gadgets/trace/exec (execsnoop.bpf.c tracepoints on
sys_enter/exit_execve; tracer.go:52-222 perf loop + args parsing;
gadget.go registration). Here: native proc-connector/procfs capture or the
synthetic generator, with the same event schema and container filtering.

The port's copy of ``inspektor_gadget_tpu/gadgets/trace/exec.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...columns import col
from ...params import ParamDescs
from ...types import Event, WithMountNsID
from ..interface import GadgetDesc, GadgetType
from ..registry import register
from ..source_gadget import SourceTraceGadget, source_params
from ...sources.bridge import SRC_PROC_EXEC, SRC_SYNTH_EXEC


@dataclasses.dataclass
class ExecEvent(Event, WithMountNsID):
    pid: int = col(0, template="pid", dtype=np.int32)
    ppid: int = col(0, template="pid", dtype=np.int32)
    uid: int = col(0, template="uid", dtype=np.int32)
    comm: str = col("", template="comm")
    retval: int = col(0, width=4, dtype=np.int32)
    args: str = col("", width=40, ellipsis="end")  # execsnoop's ARGS column


class TraceExec(SourceTraceGadget):
    native_kind = SRC_PROC_EXEC
    synth_kind = SRC_SYNTH_EXEC
    kind_filter = (1, 2)  # EV_EXEC, EV_EXIT (the source also emits EV_SIGNAL)

    def decode_row(self, batch, i) -> ExecEvent:
        c = batch.cols
        # aux1 keys the full argv in the vocab (EV_EXEC only; EV_EXIT's
        # aux fields carry the exit code)
        args = ""
        if int(c["kind"][i]) == 1 and int(c["aux1"][i]):
            args = self.resolve_key(int(c["aux1"][i]))
        return ExecEvent(
            timestamp=int(c["ts"][i]),
            mountnsid=int(c["mntns"][i]),
            pid=int(c["pid"][i]),
            ppid=int(c["ppid"][i]),
            uid=int(c["uid"][i]),
            comm=batch.comm_str(i) or self.resolve_key(int(c["key_hash"][i])),
            retval=0,
            args=args,
        )

    def decode_rows(self, batch, idx) -> list:
        """Bulk decode: one fancy-index + .tolist() per column instead of
        per-row numpy scalar extraction (the display-path hot loop)."""
        c = batch.cols
        sel = np.asarray(idx, dtype=np.int64)
        if sel.size == 0:
            return []
        ts = c["ts"][sel].tolist()
        mnt = c["mntns"][sel].tolist()
        pid = c["pid"][sel].tolist()
        ppid = c["ppid"][sel].tolist()
        uid = c["uid"][sel].tolist()
        kh = c["key_hash"][sel].tolist()
        comm_rows = (batch.comm[sel].tobytes()
                     if batch.comm is not None else None)
        # argv strings are per-event-unique: resolve them in ONE native
        # crossing instead of a ctypes call per row
        aux1_arr = c["aux1"][sel]
        need = np.flatnonzero((c["kind"][sel] == 1) & (aux1_arr != 0))
        args_list = [""] * sel.size
        if need.size:
            for j, v in zip(need.tolist(),
                            self.resolve_keys_bulk(aux1_arr[need])):
                args_list[j] = v
        resolve = self.resolve_key_cached
        out = []
        for j in range(sel.size):
            comm = ""
            if comm_rows is not None:
                raw = comm_rows[j * 8:(j + 1) * 8]
                comm = raw.split(b"\0", 1)[0].decode("utf-8", "replace")
            out.append(ExecEvent(
                timestamp=ts[j], mountnsid=mnt[j], pid=pid[j], ppid=ppid[j],
                uid=uid[j],
                comm=comm or resolve(kh[j]),
                retval=0,
                args=args_list[j],
            ))
        return out


@register
class TraceExecDesc(GadgetDesc):
    name = "exec"
    category = "trace"
    gadget_type = GadgetType.TRACE
    description = "Trace new processes"
    event_cls = ExecEvent

    def params(self) -> ParamDescs:
        return source_params()

    def new_instance(self, ctx) -> TraceExec:
        return TraceExec(ctx)
