"""trace/tcp + trace/tcpconnect — TCP connection lifecycle events.

Reference: pkg/gadgets/trace/tcp (tcptracer.bpf.c kprobes on
tcp_v4/v6_connect, tcp_close, inet_csk_accept; tracer.go 293 LoC) and
trace/tcpconnect (tcpconnect.bpf.c). Two real windows feed both gadgets
(tcpconnect is the connect-only view):

- **inet_sock_set_state tracepoint** (preferred): every TCP state
  transition host-wide, event-driven — no scan window, so short-lived
  connections can't slip between polls. Connect identity comes from the
  true task context; accept is attributed to the listener via a port→pid
  map (the transition fires in softirq).
- **/proc/net/tcp diff scanner** (fallback): polling, with scan-window
  churn surfaced as drops via SNMP open counters.

The port's copy of ``inspektor_gadget_tpu/gadgets/trace/tcp.py``.
"""

from __future__ import annotations

import dataclasses
import socket
import struct

import numpy as np

from ...columns import col
from ...params import ParamDescs
from ...types import Event, WithMountNsID, WithNetNsID
from ..interface import GadgetDesc, GadgetType
from ..registry import register
from ..source_gadget import SourceTraceGadget, source_params
from ...sources.bridge import (SRC_PROC_TCP, SRC_SOCK_STATE, SRC_SYNTH_TCP,
                               sockstate_supported)

_OPS = {4: "connect", 5: "accept", 6: "close"}


@dataclasses.dataclass
class TcpEvent(Event, WithMountNsID, WithNetNsID):
    operation: str = col("", width=9)
    pid: int = col(0, template="pid", dtype=np.int32)
    comm: str = col("", template="comm")
    ipversion: int = col(4, template="ipversion", dtype=np.int8)
    saddr: str = col("", template="ipaddr")
    daddr: str = col("", template="ipaddr")
    sport: int = col(0, template="ipport", dtype=np.int32)
    dport: int = col(0, template="ipport", dtype=np.int32)


def _ip4(addr: int) -> str:
    try:
        return socket.inet_ntoa(struct.pack("<I", addr & 0xFFFFFFFF))
    except (struct.error, OverflowError):
        return str(addr)


class TraceTcp(SourceTraceGadget):
    native_kind = SRC_PROC_TCP
    synth_kind = SRC_SYNTH_TCP
    kind_filter = (4, 5, 6)  # EV_TCP_CONNECT/ACCEPT/CLOSE

    def __init__(self, ctx):
        super().__init__(ctx)
        # explicit synthetic runs must not probe (or build) the native lib
        if self.window_supported(sockstate_supported):
            self.native_kind = SRC_SOCK_STATE

    def decode_row(self, batch, i) -> TcpEvent:
        c = batch.cols
        aux1, aux2 = int(c["aux1"][i]), int(c["aux2"][i])
        # v6 flag rides bit 48 — bits 32-35 carry the /proc fallback's
        # TCP state and must not be mistaken for it
        if (aux2 >> 48) & 1:  # aux1 keys "saddr6\x1fdaddr6" in the vocab
            pair = self.resolve_key(aux1)
            saddr, _, daddr = pair.partition("\x1f")
            ipversion = 6
        else:
            saddr, daddr = _ip4(aux1 >> 32), _ip4(aux1 & 0xFFFFFFFF)
            ipversion = 4
        return TcpEvent(
            timestamp=int(c["ts"][i]),
            mountnsid=int(c["mntns"][i]),
            operation=_OPS.get(int(c["kind"][i]), "unknown"),
            pid=int(c["pid"][i]),
            comm=batch.comm_str(i) or self.resolve_key(int(c["key_hash"][i])),
            ipversion=ipversion,
            saddr=saddr,
            daddr=daddr,
            sport=(aux2 >> 16) & 0xFFFF,
            dport=aux2 & 0xFFFF,
        )


@register
class TraceTcpDesc(GadgetDesc):
    name = "tcp"
    category = "trace"
    gadget_type = GadgetType.TRACE
    description = "Trace TCP connect/accept/close"
    event_cls = TcpEvent

    def params(self) -> ParamDescs:
        return source_params()

    def new_instance(self, ctx) -> TraceTcp:
        return TraceTcp(ctx)


class TraceTcpConnect(TraceTcp):
    kind_filter = (4,)  # connect-only view (tcpconnect.bpf.c scope)


@register
class TraceTcpConnectDesc(GadgetDesc):
    name = "tcpconnect"
    category = "trace"
    gadget_type = GadgetType.TRACE
    description = "Trace TCP connect calls"
    event_cls = TcpEvent

    def params(self) -> ParamDescs:
        return source_params()

    def new_instance(self, ctx) -> TraceTcpConnect:
        return TraceTcpConnect(ctx)
