"""top/tcp — busiest TCP connections per interval, with real byte counts.

Reference: pkg/gadgets/top/tcp (tcptop.bpf.c:1-133 kprobes tcp_sendmsg/
tcp_cleanup_rbuf summing bytes per connection; tracer.go:222-314 drains the
stats map each interval). Without kernel probes the same per-connection
totals come from sock_diag INET_DIAG_INFO: struct tcp_info carries
cumulative tcpi_bytes_acked (sent) / tcpi_bytes_received per socket, and
the native TcpBytesSource diffs them per interval — real SENT/RECV columns
against live traffic. One labeled fidelity gap vs kprobes: a connection
that opens AND closes entirely inside one poll interval is never observed
(the dump only sees live sockets); long-lived busy connections — the rows a
top gadget exists to surface — are measured exactly.

Degraded flavour (kernels without INET_DIAG_INFO byte counters): the
trace/tcp event stream, aggregated as events-per-connection churn; with the
synthetic source, aux1 carries a fabricated bytes field.

The port's copy of ``inspektor_gadget_tpu/gadgets/top/tcp.py``. The byte
window is probed once ``--source`` is known
(`SourceTraceGadget.window_supported`): an explicit synthetic run never
builds the native library.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from ...columns import col
from ...params import ParamDescs
from ...types import Event, WithMountNsID
from ..interface import GadgetDesc, GadgetType
from ..interval_gadget import IntervalGadget, interval_params
from ..registry import register
from ..source_gadget import SourceTraceGadget, source_params
from ..source_gadget import container_key
from ...sources.bridge import (SRC_PROC_TCP, SRC_SYNTH_TCP, SRC_TCP_BYTES,
                               make_cfg, tcpinfo_supported)

EV_TCP_BYTES = 21  # native/events.h EventKind


@dataclasses.dataclass
class TcpTopStats(Event, WithMountNsID):
    pid: int = col(0, template="pid", dtype=np.int32)
    comm: str = col("", template="comm")
    conn: str = col("", width=44)
    sent: int = col(0, width=12, group="sum", dtype=np.int64)
    recv: int = col(0, width=12, group="sum", dtype=np.int64)
    events: int = col(0, width=8, group="sum", dtype=np.int64)


class _TcpFeed(SourceTraceGadget):
    """Feed for TopTcp. Attacher role: the host-netns sock_diag dump can't
    see a container's private netns, so a container selector attaches one
    byte source per matching container whose capture thread setns()es into
    that container's netns (TcpBytesSource netns_pid cfg) — the per-netns
    flavour the docs promise."""

    synth_kind = SRC_SYNTH_TCP
    # netns-entering byte sources are cheap, but attaching to every
    # procfs-discovered process would still be noise: selector-gated
    attach_requires_selector = True

    def attach_container(self, container) -> None:
        pid = int(getattr(container, "pid", 0))
        if pid <= 0:
            raise ValueError(f"attach needs a live pid, got {pid}")
        if not self._bytes_mode:
            # degraded kernel (no INET_DIAG_INFO): the churn main source
            # keeps running mntns-filtered — don't replace it with nothing
            raise RuntimeError("per-netns top/tcp needs the INET_DIAG_INFO "
                               "window; falling back to churn rows")
        self._attach_native_source(
            container_key(container), SRC_TCP_BYTES,
            make_cfg(interval_ms=self._poll_ms, netns_pid=pid))

    def detach_container(self, container) -> None:
        self._detach_key(container_key(container))

    def __init__(self, ctx, interval_s: float = 1.0):
        super().__init__(ctx)
        # prefer the byte-accurate window; fall back to connection churn.
        # An explicit synthetic run never probes (or claims) the real
        # window — fabricated data stays labeled as such.
        self._bytes_mode = self.window_supported(tcpinfo_supported)
        self.native_kind = SRC_TCP_BYTES if self._bytes_mode else SRC_PROC_TCP
        # per-container netns sources replace the host view ONLY when the
        # byte window exists; in degraded mode attaches fail (warned) and
        # the churn main source must keep running
        self.attach_replaces_main = self._bytes_mode
        # poll at half the drain interval (bounded) so each drain sees at
        # least one fresh delta per active connection
        self._poll_ms = max(100, min(int(interval_s * 500), 1000))

    @property
    def bytes_mode(self) -> bool:
        return self._bytes_mode

    def native_cfg(self) -> str:
        return make_cfg(interval_ms=self._poll_ms) if self._bytes_mode else ""

    def decode_row(self, batch, i):
        return None  # unused; top consumes batches


class TopTcp(IntervalGadget):
    # Attacher protocol, delegated to the feed (the localmanager operates
    # on this gadget instance, the feed owns the sources)
    attach_requires_selector = True
    attach_pending = False

    def __init__(self, ctx):
        super().__init__(ctx)
        self._feed = _TcpFeed(ctx, interval_s=self.interval)
        self._lock = threading.Lock()
        self._stats: dict[tuple, list] = {}
        self._thread: threading.Thread | None = None

    @property
    def _mode(self):  # localmanager's synthetic-run attach gate
        return self._feed._mode

    def set_mntns_filter(self, mntns_ids) -> None:
        self._feed.set_mntns_filter(mntns_ids)

    def attach_container(self, container) -> None:
        self._feed.attach_pending = True
        self._feed.attach_container(container)

    def detach_container(self, container) -> None:
        self._feed.detach_container(container)

    def __setattr__(self, name, value):
        # forward the localmanager's attach_pending flag to the feed (it
        # decides whether a main source is created) — but never suppress
        # the degraded churn source on kernels without the byte window
        if (name == "attach_pending" and hasattr(self, "_feed")
                and self._feed.bytes_mode):
            self._feed.attach_pending = value
        super().__setattr__(name, value)

    def setup(self, ctx) -> None:
        if self._feed._mode in ("synthetic", "pysynthetic"):
            ctx.logger.info("top/tcp: SYNTHETIC source — fabricated rows")
        elif self._feed.bytes_mode:
            ctx.logger.info("top/tcp: sock_diag INET_DIAG_INFO window "
                            "(real per-connection byte counters)")
        else:
            ctx.logger.info("top/tcp: DEGRADED — no INET_DIAG_INFO byte "
                            "counters; reporting connection event churn")
        self._feed.set_batch_handler(self._on_batch)
        self._thread = threading.Thread(
            target=self._feed.run, args=(ctx,), daemon=True)
        self._thread.start()

    def teardown(self, ctx) -> None:
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _on_batch(self, batch) -> None:
        c = batch.cols
        n = batch.count
        with self._lock:
            for i in range(n):
                key = (int(c["pid"][i]), int(c["key_hash"][i]))
                ent = self._stats.get(key)
                if ent is None:
                    #            events sent recv comm  mntns  key_hash
                    self._stats[key] = ent = [0, 0, 0, batch.comm_str(i),
                                              int(c["mntns"][i]),
                                              int(c["key_hash"][i])]
                ent[0] += 1
                if int(c["kind"][i]) == EV_TCP_BYTES:
                    ent[1] += int(c["aux1"][i])
                    ent[2] += int(c["aux2"][i])
                elif not self._feed._is_native:
                    # synthetic flavour only: aux1 low bits fabricate bytes.
                    # The native churn fallback's aux1 is an address hash —
                    # never presented as bytes (SENT/RECV stay 0 there).
                    ent[1] += int(c["aux1"][i]) & 0xFFFF

    def collect(self, ctx) -> list[TcpTopStats]:
        with self._lock:
            stats, self._stats = self._stats, {}
        rows = []
        for (pid, _h), (events, sent, recv, comm, mntns, key_hash) in \
                stats.items():
            conn = self._feed.resolve_key(key_hash) or f"0x{key_hash:016x}"
            rows.append(TcpTopStats(pid=pid, comm=comm, conn=conn,
                                    sent=sent, recv=recv, events=events,
                                    mountnsid=mntns))
        return rows


@register
class TopTcpDesc(GadgetDesc):
    name = "tcp"
    category = "top"
    gadget_type = GadgetType.TRACE_INTERVALS
    description = "Top TCP connections by bytes sent/received per interval"
    event_cls = TcpTopStats

    def params(self) -> ParamDescs:
        descs = interval_params("-sent,-recv")
        descs.extend(source_params())
        return descs

    def new_instance(self, ctx) -> TopTcp:
        return TopTcp(ctx)
