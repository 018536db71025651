"""profile/cpu — sampling CPU profiler.

Reference: pkg/gadgets/profile/cpu (profile.bpf.c perf-event sampling at
49 Hz into a stack map, stack depth 127; tracer.go:139 kallsyms
symbolization, :293-322 collectResult, :324-402 folded/flamegraph output;
RunWithResult). Primary path: the SAME perf_event_open window the
reference uses — native/perf_sampler.cc samples CPU-clock at 49 Hz per
CPU with PERF_SAMPLE_CALLCHAIN, symbolizes kernel frames from kallsyms and
attributes user frames to their mapping; each EV_PERF_SAMPLE's vocab
payload is the folded stack. Fallback (perf unavailable): 49 Hz procfs
scan — per-pid utime+stime jiffy deltas + /proc/<pid>/stack kernel frames
(the standardgadgets-style degraded flavour; sample counts are jiffy
deltas there, disclosed in the output header).

The port's copy of ``inspektor_gadget_tpu/gadgets/profile/cpu.py``: the
perf window is asked of `sources.bridge.perf_supported`.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import Counter

import numpy as np

from ...columns import col
from ...params import ParamDesc, ParamDescs, TypeHint
from ...types import Event, WithMountNsID
from ..interface import GadgetDesc, GadgetType
from ..registry import register
from ...sources import bridge as B
from ...sources.bridge import NativeCapture, native_available

SAMPLE_HZ = 49          # ref: tracer.go:57
MAX_STACK_DEPTH = 127   # ref: tracer.go:58
EV_PERF_SAMPLE = 19


@dataclasses.dataclass
class CpuSample(Event, WithMountNsID):
    pid: int = col(0, template="pid", dtype=np.int32)
    comm: str = col("", template="comm")
    samples: int = col(0, width=8, group="sum", dtype=np.int64)
    stack: str = col("", width=60, hide=True, ellipsis="start")


def _cpu_jiffies(pid: int) -> int | None:
    try:
        with open(f"/proc/{pid}/stat") as f:
            parts = f.read().rsplit(")", 1)[1].split()
        return int(parts[11]) + int(parts[12])  # utime + stime
    except (OSError, IndexError, ValueError):
        return None


def _kernel_stack(pid: int) -> list[str]:
    try:
        with open(f"/proc/{pid}/stack") as f:
            frames = []
            for line in f:
                # "[<0>] futex_wait+0x14b/0x250" → futex_wait
                sym = line.split("] ", 1)[-1].split("+", 1)[0].strip()
                if sym:
                    frames.append(sym)
                if len(frames) >= MAX_STACK_DEPTH:
                    break
        return frames
    except OSError:
        return []


class ProfileCpu:
    def __init__(self, ctx):
        p = ctx.gadget_params
        self.user_only = p.get("user").as_bool() if "user" in p else False
        self.kernel_only = p.get("kernel").as_bool() if "kernel" in p else False
        self.fmt = p.get("profile-output").as_string() if "profile-output" in p else "columns"
        self.target_pid = p.get("pid").as_int() if "pid" in p else 0
        self._mode = p.get("sampler").as_string() if "sampler" in p else "auto"
        self._mntns_filter: set[int] | None = None

    def set_mntns_filter(self, mntns_ids):
        self._mntns_filter = mntns_ids

    # -- perf_event_open path (the reference's own window) ------------------

    def _perf_available(self) -> bool:
        return native_available() and B.perf_supported()

    def _run_perf(self, ctx) -> bytes:
        cfg = B.make_cfg(freq=SAMPLE_HZ, pid=self.target_pid or None,
                         user=1 if self.user_only else None,
                         kernel=1 if self.kernel_only else None)
        src = NativeCapture(B.SRC_PERF_CPU, cfg=cfg, ring_pow2=16)
        src.start()
        folded: Counter[str] = Counter()
        samples_by_comm: Counter[str] = Counter()
        try:
            while not ctx.done:
                b = src.pop()
                if b.count == 0:
                    if ctx.sleep_or_done(0.02):
                        break
                    continue
                c = b.cols
                for i in range(b.count):
                    if int(c["kind"][i]) != EV_PERF_SAMPLE:
                        continue
                    if (self._mntns_filter is not None
                            and int(c["mntns"][i]) not in self._mntns_filter):
                        continue
                    stack = src.vocab_lookup(int(c["key_hash"][i]))
                    if not stack:
                        stack = f"pid-{int(c['pid'][i])}"
                    folded[stack] += 1
                    samples_by_comm[stack.split(";", 1)[0]] += 1
        finally:
            src.stop()
            src.close()
        if self.fmt == "folded":
            lines = [f"{path} {n}" for path, n in sorted(folded.items())]
            return ("\n".join(lines) + "\n").encode()
        from ...columns import Columns
        from ..render import render_result
        rows = [CpuSample(comm=comm, samples=n)
                for comm, n in samples_by_comm.most_common(50)]
        cols = Columns(CpuSample)
        cols.hide_tagged(["kubernetes"])
        return render_result(ctx, rows, cols)

    # -- procfs fallback ----------------------------------------------------

    def run_with_result(self, ctx) -> bytes:
        if self._mode in ("auto", "perf") and self._perf_available():
            return self._run_perf(ctx)
        if self._mode == "perf":
            raise RuntimeError("perf_event_open unavailable")
        stacks: Counter[tuple[str, tuple[str, ...]]] = Counter()
        comms: dict[int, str] = {}
        prev: dict[int, int] = {}
        period = 1.0 / SAMPLE_HZ
        while not ctx.done:
            t0 = time.monotonic()
            pids = ([self.target_pid] if self.target_pid
                    else [int(d) for d in os.listdir("/proc") if d.isdigit()])
            for pid in pids:
                j = _cpu_jiffies(pid)
                if j is None:
                    continue
                dj = j - prev.get(pid, j)
                prev[pid] = j
                if dj <= 0:
                    continue  # not on CPU since last sample
                comm = comms.get(pid)
                if comm is None:
                    try:
                        with open(f"/proc/{pid}/comm") as f:
                            comm = f.read().strip()
                    except OSError:
                        comm = f"pid-{pid}"
                    comms[pid] = comm
                frames: tuple[str, ...] = ()
                if not self.user_only:
                    frames = tuple(_kernel_stack(pid))
                stacks[(f"{comm}:{pid}", frames)] += dj
            dt = time.monotonic() - t0
            if ctx.sleep_or_done(max(period - dt, 0)):
                break
        return self._render(ctx, stacks)

    run = run_with_result

    def _render(self, ctx, stacks) -> bytes:
        if self.fmt == "folded":
            # flamegraph-compatible: root..leaf, semicolon-joined
            lines = []
            for (who, frames), n in sorted(stacks.items()):
                path = ";".join([who] + list(reversed(frames)))
                lines.append(f"{path} {n}")
            return ("\n".join(lines) + "\n").encode()
        agg: Counter[str] = Counter()
        for (who, _frames), n in stacks.items():
            agg[who.rsplit(":", 1)[0]] += n
        from ...columns import Columns
        from ..render import render_result
        rows = [CpuSample(comm=comm, samples=n)
                for comm, n in agg.most_common(50)]
        cols = Columns(CpuSample)
        cols.hide_tagged(["kubernetes"])
        return render_result(ctx, rows, cols)


@register
class ProfileCpuDesc(GadgetDesc):
    name = "cpu"
    category = "profile"
    gadget_type = GadgetType.PROFILE
    description = "Sample on-CPU processes and kernel stacks"
    event_cls = CpuSample

    def params(self) -> ParamDescs:
        return ParamDescs([
            ParamDesc(key="user", default="false", type_hint=TypeHint.BOOL,
                      description="sample only userspace attribution"),
            ParamDesc(key="kernel", default="false", type_hint=TypeHint.BOOL),
            ParamDesc(key="pid", default="0", type_hint=TypeHint.INT),
            ParamDesc(key="profile-output", default="columns",
                      possible_values=("columns", "folded")),
            ParamDesc(key="sampler", default="auto",
                      possible_values=("auto", "perf", "procfs"),
                      description="perf_event_open or procfs fallback"),
        ])

    def new_instance(self, ctx) -> ProfileCpu:
        return ProfileCpu(ctx)
