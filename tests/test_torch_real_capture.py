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
kernel never.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
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
    plain = []
    monkeypatch.setattr(K, "fused_planes_plain",
                        lambda *a, _f=K.fused_planes_plain: plain.append(1) or _f(*a))
    launches = K.fused_planes.launches
    desc = get("trace", name)
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
                        extra={"on_sketch_summary": summaries.append})
    box = {}

    def run():
        box["result"] = LocalRuntime().run_gadget(
            ctx, on_event=events.append, on_batch=lambda b: sizes.append(b.count))

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
    assert summaries and summaries[-1].events == len(events) == sum(sizes)
    assert len(plain) == sum(1 for n in sizes if n) and K.fused_planes.launches == launches
    return events


@needs_native
@needs_root
def test_trace_open_gadget_real_end_to_end(monkeypatch):
    def trigger():
        # repeat the open until the run window closes: fanotify only
        # reports opens made while the mark is live
        for _ in range(8):
            subprocess.run(["sh", "-c", "date > /tmp/ig_t_open"], check=True)
            time.sleep(0.3)
    events = _run_gadget(monkeypatch, "open", {"paths": "/tmp"}, trigger, timeout=3.0)
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


@needs_native
def test_window_probes_answer_like_the_reference():
    from inspektor_gadget_tpu.sources import bridge as ref
    for name in ("fanotify_supported", "audit_supported", "captrace_supported",
                 "fstrace_supported", "sockstate_supported", "sigtrace_supported"):
        assert _window(name) == bool(getattr(ref, name)()), name
