"""trace/{dns,sni,network} — the packet-capture gadget family.

Reference: these three attach BPF socket filters to per-netns raw sockets
via the shared networktracer engine (pkg/gadgets/internal/networktracer/
tracer.go:54-220 — one refcounted attachment per netns), parse protocol
payloads in-kernel (dns.c qname walker :1-242, snisnoop.c TLS ClientHello,
graph.c connection edges), and self-enrich via the socketenricher map.

Here the capture backend is the native AF_PACKET sniffer (sources.cc
PacketSniffSource) — same architecture minus in-kernel filtering: the
sniffer opens a raw socket (optionally inside a target netns via setns,
the rawsock/netnsenter analogue), parses DNS/TLS-SNI/flow tuples in C++,
and ships hashed keys + metadata through the standard ring. Synthetic
streams cover test/bench paths.

The port's copy of ``inspektor_gadget_tpu/gadgets/trace/network_family.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...columns import col
from ...params import ParamDescs
from ...types import Event, WithNetNsID
from ..interface import GadgetDesc, GadgetType
from ..registry import register
from ..source_gadget import (NsRefcountAttachMixin, SourceTraceGadget,
                             source_params)
from ...sources import bridge as B


class _NetnsAttachMixin(NsRefcountAttachMixin):
    """Per-container netns sniffers for the packet family: one refcounted
    AF_PACKET source per distinct netns, its thread setns()'d into the
    container (the native source takes ownership of the fd — the rawsock
    contract)."""

    attach_ns = "net"

    def _ns_source_args(self, pid: int):
        from ...utils.netns import netns_fd_for_pid
        return self.native_kind, "", netns_fd_for_pid(pid)

_QTYPES = {1: "A", 28: "AAAA", 5: "CNAME", 15: "MX", 16: "TXT", 12: "PTR",
           2: "NS", 6: "SOA", 33: "SRV"}
_RCODES = {0: "NoError", 2: "ServFail", 3: "NXDomain", 5: "Refused"}


@dataclasses.dataclass
class DnsEvent(Event, WithNetNsID):
    pid: int = col(0, template="pid", dtype=np.int32)
    comm: str = col("", template="comm")
    qr: str = col("", width=2)
    qtype: str = col("", width=6)
    name: str = col("", width=32, ellipsis="start")
    rcode: str = col("", width=9)


class TraceDns(_NetnsAttachMixin, SourceTraceGadget):
    native_kind = B.SRC_PKT_DNS
    synth_kind = B.SRC_SYNTH_DNS

    def decode_row(self, batch, i):
        c = batch.cols
        aux2 = int(c["aux2"][i])
        if self._is_native:
            # native packing (packet.cc parse_dns): aux2 = flags<<32,
            # flags = 16-bit qtype<<16 | QR bit (0x80) | rcode nibble
            f = (aux2 >> 32) & 0xFFFFFFFF
            is_response = bool(f & 0x80)
            qt = (f >> 16) & 0xFFFF
            return DnsEvent(
                timestamp=int(c["ts"][i]), netnsid=int(c["mntns"][i]),
                pid=int(c["pid"][i]), comm=batch.comm_str(i),
                qr="R" if is_response else "Q",
                qtype=_QTYPES.get(qt or 1, f"TYPE{qt}"),
                name=self.resolve_key(int(c["key_hash"][i])),
                rcode=_RCODES.get(f & 0xF, "") if is_response else "",
            )
        return DnsEvent(
            timestamp=int(c["ts"][i]), netnsid=int(c["mntns"][i]),
            pid=int(c["pid"][i]), comm=batch.comm_str(i),
            qr="Q" if aux2 & 0x8000 == 0 else "R",
            qtype=_QTYPES.get((aux2 >> 16) & 0xFF or 1, "A"),
            name=self.resolve_key(int(c["key_hash"][i])),
            rcode=_RCODES.get(aux2 & 0xF, ""),
        )


@register
class TraceDnsDesc(GadgetDesc):
    name = "dns"
    category = "trace"
    gadget_type = GadgetType.TRACE
    description = "Trace DNS queries and responses"
    event_cls = DnsEvent

    def params(self) -> ParamDescs:
        return source_params()

    def new_instance(self, ctx) -> TraceDns:
        return TraceDns(ctx)


@dataclasses.dataclass
class SniEvent(Event, WithNetNsID):
    pid: int = col(0, template="pid", dtype=np.int32)
    comm: str = col("", template="comm")
    name: str = col("", width=40, ellipsis="start")


class TraceSni(_NetnsAttachMixin, SourceTraceGadget):
    native_kind = B.SRC_PKT_SNI
    synth_kind = B.SRC_SYNTH_DNS

    def decode_row(self, batch, i):
        c = batch.cols
        return SniEvent(
            timestamp=int(c["ts"][i]), netnsid=int(c["mntns"][i]),
            pid=int(c["pid"][i]), comm=batch.comm_str(i),
            name=self.resolve_key(int(c["key_hash"][i])),
        )


@register
class TraceSniDesc(GadgetDesc):
    name = "sni"
    category = "trace"
    gadget_type = GadgetType.TRACE
    description = "Trace TLS SNI in ClientHello"
    event_cls = SniEvent

    def params(self) -> ParamDescs:
        return source_params()

    def new_instance(self, ctx) -> TraceSni:
        return TraceSni(ctx)


@dataclasses.dataclass
class NetworkEvent(Event, WithNetNsID):
    pid: int = col(0, template="pid", dtype=np.int32)
    comm: str = col("", template="comm")
    proto: str = col("", width=5)
    port: int = col(0, template="ipport", dtype=np.int32)
    remote: str = col("", width=30)


class TraceNetwork(_NetnsAttachMixin, SourceTraceGadget):
    """Connection-graph edges (ref: graph.c builds the edge set in a BPF
    map; enriched by KubeIPResolver client-side)."""

    native_kind = B.SRC_PKT_FLOW
    synth_kind = B.SRC_SYNTH_TCP

    _PROTOS = {6: "tcp", 17: "udp", 1: "icmp", 58: "icmp6", 132: "sctp"}

    def decode_row(self, batch, i):
        c = batch.cols
        aux1, aux2 = int(c["aux1"][i]), int(c["aux2"][i])
        if self._is_native:
            # native packing (packet.cc dispatch_l4 flow branch):
            # aux2 = ip_proto<<32 | sport<<16 | dport
            proto_nr = (aux2 >> 32) & 0xFF
            proto = self._PROTOS.get(proto_nr, str(proto_nr))
        else:
            proto = "tcp" if aux2 % 2 == 0 else "udp"  # synthetic stand-in
        return NetworkEvent(
            timestamp=int(c["ts"][i]), netnsid=int(c["mntns"][i]),
            pid=int(c["pid"][i]), comm=batch.comm_str(i),
            proto=proto,
            port=aux2 & 0xFFFF,
            remote=self.resolve_key(int(c["key_hash"][i])) or f"{aux1 & 0xFF}.x",
        )


@register
class TraceNetworkDesc(GadgetDesc):
    name = "network"
    category = "trace"
    gadget_type = GadgetType.TRACE
    description = "Trace network connection graph edges"
    event_cls = NetworkEvent

    def params(self) -> ParamDescs:
        return source_params()

    def new_instance(self, ctx) -> TraceNetwork:
        return TraceNetwork(ctx)
