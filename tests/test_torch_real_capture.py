"""The port's trace gadgets on real kernel windows: each test triggers a
real system action while the gadget runs through `LocalRuntime` on the
CPU with ``--source native --tpusketch-enable true`` (a small sketch
geometry) and asserts the captured row, as
``tests/test_real_capture.py`` does for the reference's gadgets (open,
mount, bind, signal, ptrace capabilities and fsslower), with the same
marks and window probes; the mount happens in a child's private mount
namespace, attached as a container. Each run's final sketch summary
counts every row the run emitted, and K2's plain version (the CPU path
of the `fused_planes` wrapper) ran once for each non-empty batch, its
kernel never. The syscall gadgets of ROADMAP 17b (traceloop, advise
seccomp-profile, audit seccomp) run the same way on a ``--command``
under ptrace, their summaries counting every event handed on; profile
cpu samples a spinning child through perf where the host offers it.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
from inspektor_gadget_tpu_torch.operators import operators as ops
from inspektor_gadget_tpu_torch.ops import kernels as K
from inspektor_gadget_tpu_torch.params import Collection
from inspektor_gadget_tpu_torch.runtime import LocalRuntime
from inspektor_gadget_tpu_torch.sources import bridge

torch.set_num_threads(2)

needs_native = pytest.mark.skipif(not bridge.native_available(), reason="no native lib")
needs_root = pytest.mark.skipif(os.geteuid() != 0, reason="needs root")
SKETCH = {"enable": "true", "depth": "3", "log2-width": "10", "hll-p": "8",
          "entropy-log2-width": "6", "topk": "8", "harvest-interval": "1h"}


def _window(name: str) -> bool:
    return bool(getattr(bridge, name)())


def _run_gadget(monkeypatch, name, flags, trigger=None, timeout=4.0, op_params=None):
    """Run trace/<name> through the framework with the sketch plane on
    while `trigger` performs the real system action; returns the rows
    after checking the run's summary and K2's plain path against them."""
    return _run(monkeypatch, "trace", name, flags, trigger, timeout, op_params)[0]


def _run(monkeypatch, category, name, flags, trigger=None, timeout=4.0, op_params=None,
         output="columns"):
    """`_run_gadget` for any gadget with a capture source: returns the
    rows (a trace gadget's only) and the run's result. The last summary
    counts every event the gadget handed on; a trace gadget's rows are
    those events, where audit seccomp's are its denials among them."""
    plain = []
    monkeypatch.setattr(K, "fused_planes_plain",
                        lambda *a, _f=K.fused_planes_plain: plain.append(1) or _f(*a))
    launches = K.fused_planes.launches
    desc = get(category, name)
    params = desc.params().to_params()
    for k, v in {"source": "native", **flags}.items():
        params.set(k, str(v))
    col = Collection()
    for op, values in {"tpusketch": SKETCH, **(op_params or {})}.items():
        col[f"operator.{op}."] = ops.get(op).instance_params().to_params()
        for k, v in values.items():
            col[f"operator.{op}."].set(k, v)
    summaries, events, sizes = [], [], []
    ctx = GadgetContext(desc, gadget_params=params, timeout=timeout, device="cpu",
                        operator_params=col,
                        extra={"on_sketch_summary": summaries.append, "output": output})
    box = {}
    rows = category in ("trace", "audit")

    def run():
        box["result"] = LocalRuntime().run_gadget(
            ctx, on_event=events.append if rows else None,
            on_batch=lambda b: sizes.append(b.count))

    th = threading.Thread(target=run)
    th.start()
    try:
        time.sleep(0.6)
        if trigger:
            trigger()
    finally:
        th.join(timeout + 6)
        ctx.cancel()
        th.join(4)
    result = box.get("result")
    assert result is not None and not result.errors(), result and result.errors()
    assert summaries and summaries[-1].events == sum(sizes)
    if category == "trace":
        assert len(events) == sum(sizes)
    assert len(plain) == sum(1 for n in sizes if n) and K.fused_planes.launches == launches
    return events, result.first()


@needs_native
@needs_root
def test_trace_open_gadget_real_end_to_end(monkeypatch):
    # repeat the open until the run's thread has ended: fanotify only
    # reports opens made while the mark is live, and under load the mark
    # can go live late in the run
    done = threading.Event()

    def opener():
        while not done.is_set():
            subprocess.run(["sh", "-c", "date > /tmp/ig_t_open"], check=True)
            done.wait(0.3)

    th = threading.Thread(target=opener, daemon=True)
    try:
        events = _run_gadget(monkeypatch, "open", {"paths": "/tmp"}, th.start, timeout=3.0)
    finally:
        done.set()
        if th.is_alive():
            th.join(10)
    hits = [e for e in events if e.path == "/tmp/ig_t_open"]
    assert hits and hits[0].pid > 0 and hits[0].comm != ""


@needs_native
@needs_root
@pytest.mark.skipif(not shutil.which("unshare"), reason="no unshare")
def test_trace_mount_gadget_real_end_to_end(monkeypatch):
    """A tmpfs mounted and unmounted inside a child's private mount
    namespace (so no other test's mountinfo watch sees it), the child
    seeded as a container and selected by name: the gadget attaches a
    poller on its mountinfo."""
    from inspektor_gadget_tpu_torch.containers import Container
    target, fs = "/tmp/ig_t_mnt", "ig_t_fs"
    os.makedirs(target, exist_ok=True)
    child = subprocess.Popen(["unshare", "-m", "sh", "-c",
                              f"sleep 1.5; mount -t tmpfs {fs} {target}; sleep 0.5; "
                              f"umount {target}; sleep 5"])
    lm = ops.get("localmanager")
    with ops._init_lock:
        if "localmanager" not in ops._initialized:
            gp = lm.global_params().to_params()
            gp.set("containerd-like-discovery", "none")
            lm.init(gp)
            ops._initialized.add("localmanager")
    time.sleep(0.2)
    ctr = Container(id="ig-t-mnt", name="ig-t-mnt", pid=child.pid,
                    mntns=os.stat(f"/proc/{child.pid}/ns/mnt").st_ino, runtime="fake")
    lm.cc.add_container(ctr)
    try:
        events = _run_gadget(monkeypatch, "mount", {}, timeout=3.5,
                             op_params={"localmanager": {"containername": "ig-t-mnt"}})
    finally:
        lm.cc.remove_container(ctr.id)
        with lm.cc._mu:
            lm.cc._removed.pop(ctr.mntns, None)
        child.kill()
        child.wait()
    mine = [e for e in events if e.source == fs]
    assert {e.operation for e in mine} == {"mount", "umount"}, mine
    assert all(e.target == target and e.fstype == "tmpfs" for e in mine)


@needs_native
@needs_root
def test_trace_bind_gadget_real_end_to_end(monkeypatch):
    socks = []

    def trigger():
        tcp = socket.socket()
        tcp.bind(("127.0.0.1", 48724))
        tcp.listen(1)
        udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        udp.bind(("0.0.0.0", 48725))
        socks.extend((tcp, udp))
    try:
        events = _run_gadget(monkeypatch, "bind", {}, trigger, timeout=3.0)
    finally:
        for s in socks:
            s.close()
    by_port = {e.port: e for e in events if e.port in (48724, 48725)}
    assert by_port[48724].protocol == "tcp" and by_port[48725].protocol == "udp"
    assert by_port[48724].pid == os.getpid()


@needs_native
@needs_root
def test_trace_signal_gadget_real_end_to_end(monkeypatch):
    def trigger():
        for _ in range(3):
            subprocess.run(["sh", "-c", "kill -USR1 $$"], check=False)
            time.sleep(0.3)
    events = _run_gadget(monkeypatch, "signal", {}, trigger, timeout=3.0)
    assert any(e.signal == "SIGUSR1" and e.origin in ("sent", "fatal", "deliver")
               for e in events), events[:5]


@needs_native
@needs_root
def test_trace_capabilities_gadget_real_end_to_end(monkeypatch):
    with open("/tmp/ig_t_cap", "w") as f:
        f.write("x")
    events = _run_gadget(monkeypatch, "capabilities",
                         {"command": "chown 0:0 /tmp/ig_t_cap"}, timeout=5.0)
    assert any(e.cap == "CHOWN" and e.verdict == "allow" for e in events)


@needs_native
@needs_root
def test_trace_fsslower_gadget_real_end_to_end(monkeypatch):
    events = _run_gadget(monkeypatch, "fsslower",
                         {"command": "cat /etc/hostname", "min-latency": "0"}, timeout=5.0)
    assert any(e.file == "/etc/hostname" and e.op == "open" for e in events)


# -- ROADMAP 17b: the syscall gadgets on the ptrace window, profile cpu on perf --

@needs_native
@needs_root
def test_traceloop_real_syscall_history(monkeypatch):
    _, out = _run(monkeypatch, "traceloop", "traceloop", {"command": "cat /etc/hostname"},
                  timeout=6.0, output="json")
    records = json.loads(out)
    names = {r["syscall"] for r in records}
    assert "execve" in names and "openat" in names
    opens = [r for r in records if r["syscall"] == "openat" and "/etc/hostname" in r["args"]]
    assert opens and opens[0]["ret"] == 3
    assert all(r["pid"] > 0 for r in records)


@needs_native
@needs_root
def test_advise_seccomp_profile_exact_syscall_set(monkeypatch):
    _, out = _run(monkeypatch, "advise", "seccomp-profile", {"command": "cat /etc/hostname"},
                  timeout=6.0)
    profiles = json.loads(out.decode())
    assert profiles, "no profile generated"
    names = set(next(iter(profiles.values()))["syscalls"][0]["names"])
    # the syscalls cat made (beyond the baseline set), and none it never makes
    assert {"execve", "openat", "read", "close"} <= names
    assert "reboot" not in names and "swapon" not in names


@needs_native
@needs_root
def test_audit_seccomp_sees_real_denial(monkeypatch):
    """A child that drops to uid 1 and chowns a root-owned file: the
    kernel answers EPERM, the ERRNO row audit seccomp reports."""
    probe = "/tmp/ig_t_audit_probe"
    with open(probe, "w") as f:
        f.write("x")
    os.chown(probe, 0, 0)
    cmd = f"{sys.executable} -S -c \"import os; os.setuid(1); os.chown('{probe}', 1, 1)\""
    events, _ = _run(monkeypatch, "audit", "seccomp", {"command": cmd}, timeout=8.0)
    denied = [e for e in events if e.code == "ERRNO"]
    assert any(e.syscall in ("chown", "fchownat") for e in denied), \
        [f"{e.syscall}:{e.code}" for e in events]


@needs_native
@needs_root
def test_profile_cpu_perf_sampler_real_samples():
    if not bridge.perf_supported():
        pytest.skip("perf_event_open unavailable")
    spin = subprocess.Popen([sys.executable, "-S", "-c",
                             "import time\nt=time.time()\nwhile time.time()-t<6: pass"])
    try:
        desc = get("profile", "cpu")
        params = desc.params().to_params()
        for k, v in {"sampler": "perf", "profile-output": "folded",
                     "pid": str(spin.pid)}.items():
            params.set(k, v)
        ctx = GadgetContext(desc, gadget_params=params, timeout=2.5, device="cpu")
        timer = threading.Timer(2.5, ctx.cancel)
        timer.start()
        out = desc.new_instance(ctx).run_with_result(ctx).decode()
        timer.cancel()
    finally:
        spin.kill()
        spin.wait()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert lines, "no perf samples for a spinning child"
    total = sum(int(ln.rsplit(" ", 1)[1]) for ln in lines)
    assert total >= 20, f"only {total} samples"  # 49 Hz over ~2.5 s
    comm = os.path.basename(sys.executable)[:15]
    assert any(ln.startswith(comm + ";") for ln in lines), lines[:5]


@needs_native
def test_window_probes_answer_like_the_reference():
    from inspektor_gadget_tpu.sources import bridge as ref
    for name in ("fanotify_supported", "audit_supported", "captrace_supported",
                 "fstrace_supported", "sockstate_supported", "sigtrace_supported",
                 "tcpinfo_supported", "blktrace_supported"):
        assert _window(name) == bool(getattr(ref, name)()), name
    lib = ref._load()
    assert bridge.perf_supported() == bool(lib is not None and lib.ig_perf_supported())
