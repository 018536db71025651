"""The port's black-box step framework (`inspektor_gadget_tpu_torch.
testing`) driving the port's CLI, as ``tests/test_integration_steps.py``
drives the reference's: the step semantics (cleanup after a failure, a
started step killed when a later one fails, regexp and string
expectations), ``trace exec`` streams matched as JSON entries,
``snapshot process`` and ``snapshot socket`` as JSON arrays, and, as
root where the host offers the window, ``trace tcp`` and ``trace
capabilities`` host-wide against a live workload. Every command runs
``ig-tpu-torch … --device cpu`` with its own time limit, so no step can
hang the suite.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from inspektor_gadget_tpu_torch.testing import (
    Command,
    FuncStep,
    build_common_data,
    expect_all_entries_to_match,
    expect_entries_in_array_to_match,
    expect_entries_to_match,
    run_test_steps,
)
from inspektor_gadget_tpu_torch.testing.steps import StepError, ig_cli

# a streaming step waits this long for its first row, then this long for
# its exit after SIGINT; a one-shot step is killed at RUN_LIMIT
READY, GRACE, RUN_LIMIT = 60.0, 15.0, 120.0


def stream(name: str, args, **kw) -> Command:
    return Command(name=name, cmd=ig_cli(*args, "--device", "cpu"), start_and_stop=True,
                   ready_timeout=READY, stop_grace=GRACE, **kw)


def once(name: str, args, **kw) -> Command:
    return Command(name=name, cmd=ig_cli(*args), timeout=RUN_LIMIT, **kw)


def normalize_trace(e: dict) -> None:
    """Drop the fields a test cannot predict (ref: trace_exec_test.go)."""
    for k in ("timestamp", "pid", "ppid", "uid", "mountnsid", "tid"):
        e.pop(k, None)


def test_ig_cli_names_the_port():
    assert ig_cli("list") == [sys.executable, "-m", "inspektor_gadget_tpu_torch.cli.main", "list"]


@pytest.mark.parametrize("name", ["AgentProcess", "ChaosProxy", "SkewClock"])
def test_chaos_tools_are_exported(name):
    import inspektor_gadget_tpu_torch.testing as steps_pkg
    from inspektor_gadget_tpu_torch.testing import chaos
    assert getattr(steps_pkg, name) is getattr(chaos, name)
    assert name in steps_pkg.__all__


def test_trace_exec_steps():
    def check(output: str) -> None:
        expect_entries_to_match(output, normalize_trace,
                                {"comm": "proc-0", "type": "normal", **build_common_data()})

    run_test_steps([stream("trace-exec", ("trace", "exec", "--source", "pysynthetic",
                                          "--rate", "5000", "-o", "json"),
                           expected_output_fn=check)], step_wait=2.0)


def test_trace_exec_filter_all_match():
    cmd = stream("trace-exec-filtered", ("trace", "exec", "--source", "pysynthetic", "--rate",
                                         "5000", "-F", "comm:proc-1", "-o", "json"),
                 expected_output_fn=lambda out: expect_all_entries_to_match(
                     out, normalize_trace, {"comm": "proc-1"}))
    run_test_steps([cmd], step_wait=2.0)


@pytest.mark.parametrize("gadget", ["open", "tcp", "dns"])
def test_trace_family_streams_json_entries(gadget):
    """The synthetic stand-ins of three trace gadgets through the CLI."""
    def check(output: str) -> None:
        entries = [json.loads(ln) for ln in output.splitlines() if ln.strip()]
        assert len(entries) > 10 and all(e["type"] == "normal" for e in entries)
        assert all(e["comm"].startswith("proc-") or e.get("name", "").startswith("proc-")
                   for e in entries)

    run_test_steps([stream(f"trace-{gadget}", ("trace", gadget, "--source", "pysynthetic",
                                                "--rate", "5000", "-o", "json"),
                           expected_output_fn=check)], step_wait=2.0)


def test_snapshot_process_steps():
    def check(output: str) -> None:
        entries = [e for e in json.loads(output)
                   if e["pid"] == os.getpid() or "py" in e["comm"]]
        assert entries, "test process not in snapshot"

    run_test_steps([once("snapshot-process", ("snapshot", "process", "-o", "json"),
                         expected_output_fn=check)])


def test_snapshot_socket_array_match():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def normalize(e: dict) -> None:
        e.pop("netnsid", None)

    try:
        run_test_steps([once(
            "snapshot-socket", ("snapshot", "socket", "--proto", "tcp", "-o", "json"),
            expected_output_fn=lambda out: expect_entries_in_array_to_match(
                out, normalize, {"protocol": "tcp", "status": "LISTEN", "localport": port}))])
    finally:
        srv.close()


def test_cleanup_runs_after_failure():
    ran = {"cleanup": False}
    steps = [
        FuncStep(name="boom", fn=lambda: (_ for _ in ()).throw(StepError("induced failure"))),
        FuncStep(name="never-runs", fn=lambda: pytest.fail("step after failure must not run")),
        FuncStep(name="cleanup", fn=lambda: ran.__setitem__("cleanup", True), cleanup=True),
    ]
    with pytest.raises(StepError, match="induced"):
        run_test_steps(steps)
    assert ran["cleanup"], "cleanup step must run even after a failure"


def test_start_and_stop_kill_on_failure():
    # a started step is killed (not left running) when a later step fails
    cmd = stream("stream", ("trace", "exec", "--source", "pysynthetic", "--rate", "100",
                            "-o", "json"))
    with pytest.raises(StepError, match="later"):
        run_test_steps([cmd, FuncStep(name="fail", fn=lambda: (_ for _ in ()).throw(
            StepError("later step failed")))])
    assert not cmd.running
    assert cmd._proc.poll() is not None, "subprocess must be reaped"


def test_expected_regexp_and_string():
    run_test_steps([once("version", ("version",), expected_regexp=r"^ig-tpu-torch \d")])
    with pytest.raises(StepError, match="regexp"):
        run_test_steps([once("version-bad", ("version",), expected_regexp=r"^not-the-version")])
    run_test_steps([once("version-exact", ("version",), expected_string="ig-tpu-torch 0.1.0\n")])
    with pytest.raises(StepError, match="output mismatch"):
        run_test_steps([once("version-wrong", ("version",), expected_string="ig-tpu 0.1.0\n")])


def test_a_stream_that_exits_reports_its_stderr():
    cmd = stream("bad-stream", ("trace", "exec", "--source", "bogus"))
    with pytest.raises(StepError, match=r"exited 2 on stop:[\s\S]*not in \['auto'"):
        run_test_steps([cmd], step_wait=0.5)
    assert not cmd.running and cmd.returncode == 2


def test_a_failing_command_fails_its_step_and_cleanup_still_runs():
    ran = []
    with pytest.raises(StepError, match="exited 2"):
        run_test_steps([once("bad-flag", ("version", "--no-such-flag")),
                        FuncStep(name="cleanup", fn=lambda: ran.append(1), cleanup=True)])
    assert ran == [1]


needs_root = pytest.mark.skipif(os.geteuid() != 0, reason="needs root")


def _window(name: str) -> bool:
    from inspektor_gadget_tpu_torch.sources import bridge
    return bridge.native_available() and getattr(bridge, name)()


@needs_root
def test_trace_tcp_host_wide_steps():
    """The event-driven tcp window through the CLI against a loopback
    workload that keeps connecting across the CLI's startup."""
    if not _window("sockstate_supported"):
        pytest.skip("inet_sock_set_state window unavailable")
    box = {}

    def workload():
        ls = socket.socket()
        ls.bind(("127.0.0.1", 0))
        ls.listen(8)
        box["port"] = ls.getsockname()[1]
        stop = threading.Event()

        def srv():
            while not stop.is_set():
                try:
                    ls.settimeout(0.5)
                    conn, _ = ls.accept()
                    conn.close()
                except OSError:
                    pass
        t = threading.Thread(target=srv)
        t.start()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            try:
                socket.create_connection(("127.0.0.1", box["port"]), timeout=1.0).close()
            except OSError:
                pass
            time.sleep(0.4)
        stop.set()
        t.join()
        ls.close()
        time.sleep(0.5)

    def normalize(e: dict) -> None:
        for k in ("timestamp", "pid", "mountnsid", "netnsid", "comm", "saddr", "daddr",
                  "sport"):
            e.pop(k, None)
        if e.get("dport") != box.get("port"):  # other connections on the host
            e.clear()
            e["skip"] = True

    def check(output: str) -> None:
        expect_entries_to_match(output, normalize,
                                {"operation": "connect", "ipversion": 4, "dport": box["port"],
                                 "type": "normal", **build_common_data()})

    run_test_steps([stream("trace-tcp", ("trace", "tcp", "--source", "native", "-o", "json"),
                           expected_output_fn=check),
                    FuncStep(name="workload", fn=workload)], step_wait=1.0)


@needs_root
def test_trace_capabilities_host_wide_steps():
    """The host-wide capability window through the CLI against an
    unprivileged chown workload."""
    if not (_window("captrace_supported") or _window("audit_supported")):
        pytest.skip("no host-wide capability window")
    target = "/tmp/ig_t_step_cap"

    def workload():
        open(target, "w").close()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            subprocess.run(["setpriv", "--reuid", "65534", "--clear-groups", "chown", "0:0",
                            target], check=False, stderr=subprocess.DEVNULL, timeout=10)
            time.sleep(0.4)
        time.sleep(0.5)

    def normalize(e: dict) -> None:
        for k in ("timestamp", "pid", "uid", "mountnsid", "comm", "audit"):
            e.pop(k, None)
        if not (e.get("cap") == "CHOWN" and e.get("verdict") == "deny"):
            e.clear()
            e["skip"] = True

    def check(output: str) -> None:
        expect_entries_to_match(output, normalize,
                                {"cap": "CHOWN", "verdict": "deny", "type": "normal",
                                 **build_common_data()})

    try:
        run_test_steps([stream("trace-capabilities", ("trace", "capabilities", "-o", "json"),
                               expected_output_fn=check),
                        FuncStep(name="workload", fn=workload)], step_wait=1.0)
    finally:
        try:
            os.unlink(target)
        except OSError:
            pass
