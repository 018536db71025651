"""snapshot/socket — one-shot socket listing, per netns.

Reference: pkg/gadgets/snapshot/socket (BPF socket iterators
tcp4-collector.c/udp4-collector.c, run once per container netns via
netnsenter). Procfs analogue: parse /proc/net/{tcp,tcp6,udp,udp6} for the
host view PLUS each tracked container's /proc/<pid>/net — the same files
through that process's netns, no setns needed — deduped by netns inode
(pod containers share one view). Same rows (proto, local, remote, state,
inode) with container/netns identity; protocol filter param mirrored.
It emits no batches, so the sketch plane does not run on it.

The port's copy of ``inspektor_gadget_tpu/gadgets/snapshot/socket.py``.
"""

from __future__ import annotations

import dataclasses
import logging
import socket
import struct

import numpy as np

from ...columns import col
from ...params import ParamDesc, ParamDescs
from ...types import Event, WithNetNsID
from ..interface import GadgetDesc, GadgetType
from ..registry import register

_TCP_STATES = {
    1: "ESTABLISHED", 2: "SYN_SENT", 3: "SYN_RECV", 4: "FIN_WAIT1",
    5: "FIN_WAIT2", 6: "TIME_WAIT", 7: "CLOSE", 8: "CLOSE_WAIT",
    9: "LAST_ACK", 10: "LISTEN", 11: "CLOSING",
}


@dataclasses.dataclass
class SocketEvent(Event, WithNetNsID):
    protocol: str = col("", width=5)
    localaddr: str = col("", template="ipaddr")
    localport: int = col(0, template="ipport", dtype=np.int32)
    remoteaddr: str = col("", template="ipaddr")
    remoteport: int = col(0, template="ipport", dtype=np.int32)
    status: str = col("", width=12)
    inode: int = col(0, width=10, dtype=np.int64)


def _decode_addr4(hexstr: str) -> tuple[str, int]:
    addr, _, port = hexstr.partition(":")
    ip = socket.inet_ntoa(struct.pack("<I", int(addr, 16)))
    return ip, int(port, 16)


def _decode_addr6(hexstr: str) -> tuple[str, int]:
    addr, _, port = hexstr.partition(":")
    raw = bytes.fromhex(addr)
    # /proc/net/tcp6 stores 4 LE u32 words
    words = [raw[i:i + 4][::-1] for i in range(0, 16, 4)]
    ip = socket.inet_ntop(socket.AF_INET6, b"".join(words))
    return ip, int(port, 16)


def _parse(path: str, proto: str, v6: bool,
           container: str = "", netnsid: int = 0) -> list[SocketEvent]:
    rows = []
    try:
        with open(path) as f:
            next(f)
            for line in f:
                p = line.split()
                if len(p) < 10:
                    continue
                try:
                    la, lp = (_decode_addr6 if v6 else _decode_addr4)(p[1])
                    ra, rp = (_decode_addr6 if v6 else _decode_addr4)(p[2])
                    state = int(p[3], 16)
                    inode = int(p[9])
                except (ValueError, OSError):
                    continue
                status = _TCP_STATES.get(state, str(state)) if proto == "tcp" else ""
                rows.append(SocketEvent(protocol=proto, localaddr=la,
                                        localport=lp, remoteaddr=ra,
                                        remoteport=rp, status=status,
                                        inode=inode, container=container,
                                        netnsid=netnsid))
    except OSError:
        pass
    return rows


def _netns_views(selector=None) -> list[tuple[str, str, int]]:
    """(proc net root, container label, netns id) per distinct netns: the
    host view plus each tracked container's /proc/<pid>/net (which
    reflects THAT process's netns — the BPF-iterator-per-netns role of
    the reference's collector, netnsenter-free). Containers sharing the
    host's or another container's netns are deduped by inode."""
    import os

    host_ino = 0
    try:
        host_ino = os.stat("/proc/self/ns/net").st_ino
    except OSError:
        pass
    views = [("/proc/net", "", host_ino)]
    seen = {host_ino}
    try:
        from ...operators.operators import get as get_op
        lm = get_op("localmanager")
        containers = (list(lm.cc.get_all(selector))
                      if lm.cc is not None else [])
    except Exception:  # collection not initialized — host-only snapshot
        containers = []
    for c in containers:
        pid = getattr(c, "pid", 0)
        if pid <= 0:
            continue
        # the collection's linux-ns enrichment already stamped the netns
        # inode at add time; stat only when that option wasn't active
        ino = getattr(c, "netns", 0)
        if not ino:
            try:
                ino = os.stat(f"/proc/{pid}/ns/net").st_ino
            except OSError:
                continue  # container gone mid-snapshot
        if ino in seen:
            continue
        seen.add(ino)
        views.append((f"/proc/{pid}/net",
                      getattr(c, "name", "") or getattr(c, "id", "")[:12],
                      ino))
    return views


class SnapshotSocket:
    def __init__(self, ctx):
        p = ctx.gadget_params
        self.proto = p.get("proto").as_string() if "proto" in p else "all"
        self._array_handler = None

    def set_event_handler_array(self, handler) -> None:
        self._array_handler = handler

    def run_with_result(self, ctx) -> bytes:
        # honor the run's container selector (operator.localmanager.
        # containername) — an unselected run lists every tracked netns
        selector = None
        try:
            lp = ctx.operator_params.get("operator.localmanager.")
            sel_name = (lp.get("containername").as_string()
                        if lp is not None and "containername" in lp else "")
            if sel_name:
                from ...containers import ContainerSelector
                selector = ContainerSelector(name=sel_name)
        except Exception as e:  # noqa: BLE001 — unselected scan still valid
            logging.getLogger("ig-tpu.snapshot").debug(
                "container selector parse failed: %r", e)
        rows: list[SocketEvent] = []
        for root, cname, netnsid in _netns_views(selector):
            if self.proto in ("all", "tcp"):
                rows += _parse(f"{root}/tcp", "tcp", False, cname, netnsid)
                rows += _parse(f"{root}/tcp6", "tcp", True, cname, netnsid)
            if self.proto in ("all", "udp"):
                rows += _parse(f"{root}/udp", "udp", False, cname, netnsid)
                rows += _parse(f"{root}/udp6", "udp", True, cname, netnsid)
        ctx.result = rows
        if self._array_handler is not None:
            self._array_handler(rows)
            return b""
        from ..render import render_result
        return render_result(ctx, rows)

    def run(self, ctx) -> None:
        self.run_with_result(ctx)


@register
class SnapshotSocketDesc(GadgetDesc):
    name = "socket"
    category = "snapshot"
    gadget_type = GadgetType.ONE_SHOT
    description = "List open sockets"
    event_cls = SocketEvent

    def params(self) -> ParamDescs:
        return ParamDescs([
            ParamDesc(key="proto", default="all",
                      possible_values=("all", "tcp", "udp")),
        ])

    def new_instance(self, ctx) -> SnapshotSocket:
        return SnapshotSocket(ctx)
