"""audit/seccomp — seccomp violation events.

Reference: pkg/gadgets/audit/seccomp (audit-seccomp.bpf.c:1-65 kprobe on
audit_seccomp — system-wide; reports pid/comm/syscall/code e.g.
SECCOMP_RET_KILL). Two real windows here:

- **host-wide** (no target needed, the reference's scope): the kernel
  audit stream (native/audit_source.cc) — seccomp kills emit AUDIT_SECCOMP
  records with pid/comm/sig/syscall/code, read from the NETLINK_AUDIT
  readlog multicast. Covers kill/trap/log outcomes; SECCOMP_RET_ERRNO is
  not audited by default (kernel seccomp actions_logged), so errno-only
  filters need the per-target flavour.
- **per-target** (--command/--pid or container filter): the ptrace syscall
  stream. SECCOMP_RET_ERRNO shows as -EPERM at the exit stop → code ERRNO;
  RET_KILL/TRAP shows as a SIGSYS delivery stop → code KILL_THREAD.

The synthetic stream remains for demos; rows from it carry code SYNTH.

The port's copy of ``inspektor_gadget_tpu/gadgets/audit/seccomp.py``. The
audit window is probed once ``--source`` is known
(`SourceTraceGadget.window_supported`).
"""

from __future__ import annotations

import dataclasses
import shlex

import numpy as np

from ...columns import col
from ...params import ParamDesc, ParamDescs, TypeHint
from ...types import Event, WithMountNsID
from ..interface import GadgetDesc, GadgetType
from ..registry import register
from ..source_gadget import PtraceAttachMixin, SourceTraceGadget, source_params
from ...sources import bridge as B
from ...utils.syscalls import syscall_name

EV_SIGNAL, EV_SYSCALL, EV_AUDIT = 9, 18, 22
_EPERM, _EACCES = 1, 13
_SIGSYS = 31

# SECCOMP_RET action values as they appear in the audit record's code field
_SECCOMP_CODES = {
    0x00000000: "KILL_THREAD",
    0x80000000: "KILL_PROCESS",
    0x00030000: "TRAP",
    0x7ffc0000: "LOG",
    0x7fff0000: "ALLOW",
}


@dataclasses.dataclass
class SeccompEvent(Event, WithMountNsID):
    pid: int = col(0, template="pid", dtype=np.int32)
    comm: str = col("", template="comm")
    syscall: str = col("", template="syscall")
    code: str = col("", width=13)


class AuditSeccomp(PtraceAttachMixin, SourceTraceGadget):
    native_kind = B.SRC_PTRACE
    synth_kind = B.SRC_SYNTH_EXEC
    kind_filter = (EV_SYSCALL, EV_SIGNAL, EV_AUDIT)

    def __init__(self, ctx):
        super().__init__(ctx)
        p = ctx.gadget_params
        self._command = p.get("command").as_string() if "command" in p else ""
        self._target_pid = p.get("pid").as_int() if "pid" in p else 0
        # no target → the host-wide audit window (the reference's scope);
        # an explicit synthetic run must not probe (or build) the native lib
        self._host_wide = (not self._command and not self._target_pid
                           and self.window_supported(B.audit_supported))
        if self._host_wide:
            self.native_kind = B.SRC_AUDIT

    def native_ready(self) -> bool:
        return self._host_wide or bool(self._command or self._target_pid)

    def native_cfg(self) -> str:
        if self._host_wide:
            return ""
        if self._command:
            return B.make_cfg(cmd=shlex.split(self._command))
        return B.make_cfg(pid=self._target_pid)

    def _decode_real(self, batch, i):
        c = batch.cols
        kind = int(c["kind"][i])
        if kind == EV_AUDIT:  # host-wide kernel audit record
            aux2 = int(c["aux2"][i])
            # the audit code field is action|data; the low 16 data bits
            # (SECCOMP_RET_DATA) must not defeat the action-name lookup
            code = aux2 & 0xFFFF0000
            return SeccompEvent(
                timestamp=int(c["ts"][i]), mountnsid=int(c["mntns"][i]),
                pid=int(c["pid"][i]), comm=batch.comm_str(i),
                syscall=syscall_name(int(c["aux1"][i])),
                code=_SECCOMP_CODES.get(code, hex(code)))
        if kind == EV_SIGNAL:
            if int(c["aux2"][i]) != _SIGSYS:
                return None
            return SeccompEvent(
                timestamp=int(c["ts"][i]), mountnsid=int(c["mntns"][i]),
                pid=int(c["pid"][i]), comm=batch.comm_str(i),
                syscall="?", code="KILL_THREAD")
        aux2 = int(c["aux2"][i])
        ret = aux2 & 0xFFFFFFFF
        if ret >= 0x80000000:
            ret -= 1 << 32
        if ret not in (-_EPERM, -_EACCES):
            return None
        return SeccompEvent(
            timestamp=int(c["ts"][i]), mountnsid=int(c["mntns"][i]),
            pid=int(c["pid"][i]), comm=batch.comm_str(i),
            syscall=syscall_name(aux2 >> 32), code="ERRNO")

    def decode_row(self, batch, i):
        if self._is_native:
            return self._decode_real(batch, i)
        c = batch.cols
        return SeccompEvent(
            timestamp=int(c["ts"][i]), mountnsid=int(c["mntns"][i]),
            pid=int(c["pid"][i]), comm=batch.comm_str(i),
            syscall=syscall_name(int(c["aux2"][i]) % 335),
            code="SYNTH")

    def run(self, ctx):
        # denied-only stream: drop the None rows decode_row filters out
        orig = self._event_handler
        if orig is not None:
            self._event_handler = lambda ev: orig(ev) if ev is not None else None
        super().run(ctx)


@register
class AuditSeccompDesc(GadgetDesc):
    name = "seccomp"
    category = "audit"
    gadget_type = GadgetType.TRACE
    description = "Audit seccomp filter actions (denied syscalls/SIGSYS)"
    event_cls = SeccompEvent

    def params(self) -> ParamDescs:
        p = source_params()
        p.append(ParamDesc(key="command", default="",
                           description="command to spawn and trace"))
        p.append(ParamDesc(key="pid", default="0", type_hint=TypeHint.INT))
        return p

    def new_instance(self, ctx) -> AuditSeccomp:
        return AuditSeccomp(ctx)
