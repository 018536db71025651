"""top/file — busiest files per interval, per-(pid, file).

Reference: pkg/gadgets/top/file (filetop.bpf.c:1-108 kprobes vfs_read/
vfs_write into a per-(pid,file) stats hash map; tracer.go:222-272 interval
drain+reset; gadget.go:43-66 sort/max-rows params). The reference's unit of
account is the FILE — its rows carry the filename.

Two windows here:
- **fanotify** (primary): the FanotifyOpenSource mount-mark stream
  (FAN_OPEN|FAN_MODIFY with the opened path resolved via /proc/self/fd)
  aggregated per (pid, file) each interval — real filenames, real open and
  write-event counts. fanotify has no byte payloads, so RBYTES/WBYTES stay
  zero in this window (counts are the honest columns; the reference gets
  bytes from kprobe args, a window that needs BPF).
- **procio** (labeled degraded): /proc/<pid>/io read/write syscall and byte
  deltas per interval — real bytes, but per-process (no FILE column).

The port's copy of ``inspektor_gadget_tpu/gadgets/top/file.py``.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np

from ...columns import col
from ...params import ParamDesc, ParamDescs
from ...types import Event, WithMountNsID
from ..interface import GadgetDesc, GadgetType
from ..interval_gadget import IntervalGadget, interval_params
from ..registry import register


@dataclasses.dataclass
class FileStats(Event, WithMountNsID):
    pid: int = col(0, template="pid", dtype=np.int32)
    comm: str = col("", template="comm")
    file: str = col("", width=40)
    reads: int = col(0, width=7, group="sum", dtype=np.int64)
    writes: int = col(0, width=7, group="sum", dtype=np.int64)
    rbytes: int = col(0, width=12, group="sum", dtype=np.int64)
    wbytes: int = col(0, width=12, group="sum", dtype=np.int64)


def _read_proc_io(pid: int) -> tuple[int, int, int, int] | None:
    try:
        with open(f"/proc/{pid}/io") as f:
            vals = {}
            for line in f:
                k, _, v = line.partition(":")
                vals[k] = int(v)
        return (vals.get("syscr", 0), vals.get("syscw", 0),
                vals.get("read_bytes", 0), vals.get("write_bytes", 0))
    except (OSError, ValueError):
        return None


def _fanotify_window_available() -> bool:
    from ...sources.bridge import fanotify_supported, native_available
    return native_available() and fanotify_supported()


class TopFile(IntervalGadget):
    # light per-container mount marks (the host "/" mark can't see
    # container overlay mounts), no selector gate needed
    attach_requires_selector = False
    attach_pending = False

    def __init__(self, ctx):
        super().__init__(ctx)
        p = ctx.gadget_params
        self._window = (p.get("window").as_string()
                        if "window" in p else "auto")
        self._paths = (p.get("paths").as_string()
                       if "paths" in p else "/")
        self._mntns_filter: set[int] | None = None
        self._src = None
        # the capture window is decided HERE, not in setup(): the
        # localmanager attaches containers before run() reaches setup(),
        # and attach_container must know whether fanotify applies. (Named
        # _window_mode, not _mode — the localmanager's synthetic-run gate
        # reads gadget._mode with source-param semantics.)
        if (self._window in ("auto", "fanotify")
                and _fanotify_window_available()):
            self._window_mode = "fanotify"
        elif self._window == "fanotify":
            raise RuntimeError("top/file: fanotify window unavailable "
                               "(needs CAP_SYS_ADMIN and the native lib)")
        else:
            self._window_mode = "procio"
        import threading
        self._attach_lock = threading.Lock()
        self._attach_srcs: dict[str, object] = {}
        self._retired: list = []

    def set_mntns_filter(self, mntns_ids) -> None:
        self._mntns_filter = mntns_ids
        with self._attach_lock:
            extras = list(self._attach_srcs.values())
        for src in ([self._src] if self._src is not None else []) + extras:
            src.set_filter(mntns_ids)

    def setup(self, ctx) -> None:
        if self._window_mode == "fanotify":
            from ...sources.bridge import (NativeCapture, SRC_FANOTIFY_OPEN,
                                           make_cfg)
            self._src = NativeCapture(
                SRC_FANOTIFY_OPEN, ring_pow2=20, batch_size=8192,
                cfg=make_cfg(paths=self._paths, modify=1))
            if self._mntns_filter is not None:
                self._src.set_filter(self._mntns_filter)
            self._src.start()
            ctx.logger.info("top/file: fanotify window — per-(pid,file) "
                            "rows with real filenames")
            return
        ctx.logger.info("top/file: DEGRADED procio window — per-process "
                        "/proc/<pid>/io deltas, no FILE column")
        self._prev: dict[int, tuple] = {}
        self._comm: dict[int, str] = {}

    def teardown(self, ctx) -> None:
        with self._attach_lock:
            extras = list(self._attach_srcs.values()) + self._retired
            self._attach_srcs.clear()
            self._retired = []
        for src in ([self._src] if self._src is not None else []) + extras:
            try:
                src.stop()
                src.close()
            except Exception as e:  # noqa: BLE001 — teardown best-effort
                logging.getLogger("ig-tpu.top-file").debug(
                    "source teardown failed: %r", e)
        self._src = None

    # per-container mount marks (same role as trace/open's
    # _MountAttachMixin; TopFile owns its sources directly) -----------------

    def attach_container(self, container) -> None:
        import os

        from ..source_gadget import container_key
        from ...sources.bridge import (NativeCapture, SRC_FANOTIFY_OPEN,
                                       make_cfg)
        pid = int(getattr(container, "pid", 0))
        if pid <= 0:
            raise ValueError(f"attach needs a live pid, got {pid}")
        if self._window_mode != "fanotify":
            raise RuntimeError("per-container top/file needs the fanotify "
                               "window")
        if os.stat(f"/proc/{pid}/ns/mnt").st_ino == \
                os.stat("/proc/self/ns/mnt").st_ino:
            return  # the main "/" mark already covers our own mount ns
        key = container_key(container)
        from ..source_gadget import fanotify_mount_paths
        src = NativeCapture(SRC_FANOTIFY_OPEN, ring_pow2=18,
                            batch_size=8192,
                            cfg=make_cfg(paths=fanotify_mount_paths(pid),
                                         modify=1))
        if self._mntns_filter is not None:
            src.set_filter(self._mntns_filter)
        src.start()
        with self._attach_lock:
            old = self._attach_srcs.get(key)
            self._attach_srcs[key] = src
        if old is not None:
            old.stop()
            with self._attach_lock:
                self._retired.append(old)

    def detach_container(self, container) -> None:
        from ..source_gadget import container_key
        with self._attach_lock:
            src = self._attach_srcs.pop(container_key(container), None)
        if src is not None:
            # the collect loop may hold the handle mid-pop: stop now,
            # free at teardown
            src.stop()
            with self._attach_lock:
                self._retired.append(src)

    # fanotify flavour ------------------------------------------------------

    def _collect_fanotify(self) -> list[FileStats]:
        # key: (pid, path_hash) → [opens, writes, comm, mntns, source]
        stats: dict[tuple, list] = {}
        with self._attach_lock:
            extras = list(self._attach_srcs.values())
        sources = ([self._src] if self._src is not None else []) + extras
        for src in sources:
            while True:
                batch = src.pop()
                if batch.count == 0:
                    break
                c = batch.cols
                for i in range(batch.count):
                    key = (int(c["pid"][i]), int(c["aux1"][i]))
                    ent = stats.get(key)
                    if ent is None:
                        stats[key] = ent = [0, 0, batch.comm_str(i),
                                            int(c["mntns"][i]), src]
                    bits = int(c["aux2"][i])
                    if bits & 1:
                        ent[0] += 1
                    if bits & 2:
                        ent[1] += 1
        rows = []
        for (pid, ph), (opens, writes, comm, mntns, src) in stats.items():
            path = src.vocab_lookup(ph) or f"0x{ph:016x}"
            rows.append(FileStats(pid=pid, comm=comm, file=path,
                                  reads=opens, writes=writes,
                                  mountnsid=mntns))
        return rows

    # procio flavour --------------------------------------------------------

    @staticmethod
    def _read_mntns(pid: int) -> int:
        try:
            link = os.readlink(f"/proc/{pid}/ns/mnt")
            return int(link[link.index("[") + 1:-1])
        except (OSError, ValueError):
            return 0

    def _collect_procio(self) -> list[FileStats]:
        rows: list[FileStats] = []
        cur: dict[int, tuple] = {}
        try:
            pids = [int(d) for d in os.listdir("/proc") if d.isdigit()]
        except OSError:
            return rows
        for pid in pids:
            io = _read_proc_io(pid)
            if io is None:
                continue
            cur[pid] = io
            prev = self._prev.get(pid)
            if prev is None:
                continue
            dr, dw = io[0] - prev[0], io[1] - prev[1]
            drb, dwb = io[2] - prev[2], io[3] - prev[3]
            if dr or dw or drb or dwb:
                # container scoping must hold in the degraded flavour too:
                # a --containername run must never emit host-wide rows
                mntns = self._read_mntns(pid)
                if (self._mntns_filter is not None
                        and mntns not in self._mntns_filter):
                    continue
                comm = self._comm.get(pid)
                if comm is None:
                    try:
                        with open(f"/proc/{pid}/comm") as f:
                            comm = f.read().strip()
                    except OSError:
                        comm = f"pid-{pid}"
                    self._comm[pid] = comm
                rows.append(FileStats(pid=pid, comm=comm, reads=dr, writes=dw,
                                      rbytes=drb, wbytes=dwb,
                                      mountnsid=mntns))
        self._prev = cur
        return rows

    def collect(self, ctx) -> list[FileStats]:
        if self._window_mode == "fanotify":
            return self._collect_fanotify()
        return self._collect_procio()


@register
class TopFileDesc(GadgetDesc):
    name = "file"
    category = "top"
    gadget_type = GadgetType.TRACE_INTERVALS
    description = "Top files by I/O activity per interval"
    event_cls = FileStats

    def params(self) -> ParamDescs:
        descs = interval_params("-writes,-reads,-wbytes,-rbytes")
        descs.extend(ParamDescs([
            ParamDesc(key="window", default="auto",
                      description="capture window",
                      possible_values=("auto", "fanotify", "procio")),
            ParamDesc(key="paths", default="/",
                      description="colon-separated mounts to watch "
                                  "(fanotify window)"),
        ]))
        return descs

    def new_instance(self, ctx) -> TopFile:
        return TopFile(ctx)
