"""The port's deploy plane on the CPU: manifests, apply with rollout wait,
undeploy, the exec-tunnel dialer, and the local fleet.

- the six cases of ``tests/test_deploy_apply.py``: the rendered
  manifests split into their five documents; `deploy` applies them and
  waits for the DaemonSet rollout (`FakeClusterApplier`), times out when
  it never completes, and closes the deploy → pod discovery → undeploy
  loop through the pod informer; gRPC over an `ExecTunnelDialer`'s
  subprocess stdio runs a gadget, and `GrpcRuntime` fans out through a
  dialer factory;
- ``tests/test_cli.py``'s `deploy --render` and `traces` lifecycle
  against an ``ig-tpu-torch agent`` subprocess, the CLI in subprocesses;
- the local fleet: ``deploy --local 2 --device cpu`` starts two agents on
  free loopback ports with the state file under a temp directory, the
  routes that default to the local fleet serve it, and `undeploy_local`
  stops both, SIGTERM exit 0; ``deploy --local`` without ``--device``
  starts agents that exit 1 without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu_torch.agent.main import main as agent_main
from inspektor_gadget_tpu_torch.cli import deploy as deploy_mod
from inspektor_gadget_tpu_torch.cli.apply import (FakeClusterApplier, deploy,
                                                  manifest_kind_name, split_manifests,
                                                  undeploy)
from inspektor_gadget_tpu_torch.cli.deploy import render_manifests

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = [sys.executable, "-m", "inspektor_gadget_tpu_torch.cli.main"]


def test_split_manifests_and_kind_name():
    docs = split_manifests(render_manifests())
    kinds = [manifest_kind_name(d) for d in docs]
    assert ("Namespace", "ig-tpu") in kinds
    assert ("DaemonSet", "ig-tpu-agent") in kinds
    assert ("ClusterRole", "ig-tpu-agent") in kinds
    assert len(docs) == 5


def test_deploy_applies_and_waits_for_rollout(tmp_path):
    pod_file = str(tmp_path / "pods.json")
    applier = FakeClusterApplier(pod_file, nodes=("node-a", "node-b"),
                                 ready_after=2)  # ready on the 3rd poll
    desired, ready = deploy(applier, render_manifests(), rollout_timeout=10.0, poll=0.05)
    assert (desired, ready) == (2, 2)
    assert ("DaemonSet", "ig-tpu-agent") in applier.applied
    assert applier._status_polls >= 3  # rollout actually waited


def test_deploy_rollout_timeout(tmp_path):
    applier = FakeClusterApplier(str(tmp_path / "pods.json"), ready_after=10**9)
    with pytest.raises(TimeoutError):
        deploy(applier, render_manifests(), rollout_timeout=0.3, poll=0.05)


def test_deploy_discovery_undeploy_roundtrip(tmp_path):
    """Applied DaemonSet → agent pods appear in the file-manifest pod
    source → informer feeds a collection; undeploy removes them."""
    from inspektor_gadget_tpu_torch.containers import (ContainerCollection, file_pod_source,
                                                       with_pod_informer)

    pod_file = str(tmp_path / "pods.json")
    applier = FakeClusterApplier(pod_file, nodes=("node-a", "node-b"))
    manifests = render_manifests()
    deploy(applier, manifests, rollout_timeout=5.0, poll=0.05)

    cc = ContainerCollection()
    cc.initialize(with_pod_informer(file_pod_source(pod_file), interval=0.1))
    try:
        deadline = time.time() + 3.0
        while time.time() < deadline and len(cc) < 2:
            time.sleep(0.05)
        assert {c.pod for c in cc.get_all()} == {"ig-tpu-agent-node-a", "ig-tpu-agent-node-b"}

        removed = undeploy(applier, manifests)
        assert ("DaemonSet", "ig-tpu-agent") in removed
        deadline = time.time() + 3.0
        while time.time() < deadline and len(cc) > 0:
            time.sleep(0.05)
        assert len(cc) == 0, "undeployed pods still in the collection"
    finally:
        cc._pod_informer.stop()


# a stdio↔unix-socket bridge standing in for kubectl exec + socat
_BRIDGE = textwrap.dedent("""
    import socket, sys, threading
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(sys.argv[1])
    def out():
        while True:
            d = s.recv(65536)
            if not d: break
            sys.stdout.buffer.write(d); sys.stdout.buffer.flush()
    t = threading.Thread(target=out, daemon=True); t.start()
    while True:
        d = sys.stdin.buffer.read1(65536)
        if not d: break
        s.sendall(d)
    s.shutdown(socket.SHUT_WR); t.join(2)
""")


def test_exec_tunnel_dialer_runs_gadget(tmp_path):
    """AgentClient over an ExecTunnelDialer whose subprocess bridges stdio
    to the agent's unix socket — the kubectl-exec dial path."""
    from inspektor_gadget_tpu_torch.agent.client import AgentClient
    from inspektor_gadget_tpu_torch.agent.dialer import ExecTunnelDialer
    from inspektor_gadget_tpu_torch.agent.service import serve

    sock = f"{tmp_path}/agent.sock"
    server, _ = serve(f"unix://{sock}", node_name="tunneled", device="cpu")
    dialer = ExecTunnelDialer([sys.executable, "-S", "-c", _BRIDGE, sock])
    client = AgentClient("tunneled-agent", "tunneled", dialer=dialer)
    try:
        cat = client.get_catalog()
        assert any(g["name"] == "exec" for g in cat["gadgets"])
        rows = []
        res = client.run_gadget(
            "trace", "exec",
            {"gadget.source": "pysynthetic", "gadget.rate": "20000",
             "gadget.batch-size": "256"},
            timeout=1.0, on_json=lambda node, row: rows.append(row))
        assert res["error"] is None
        assert len(rows) > 10
        assert rows[0]["node"] == "tunneled"
    finally:
        client.close()
        server.stop(grace=0.5).wait(10.0)


def test_grpc_runtime_dialer_factory(tmp_path):
    """GrpcRuntime fans out through per-node dialers when a factory is
    given (the runtime-level seam)."""
    from inspektor_gadget_tpu_torch.agent.dialer import ExecTunnelDialer
    from inspektor_gadget_tpu_torch.agent.service import serve
    from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
    from inspektor_gadget_tpu_torch.runtime import GrpcRuntime

    sock = f"{tmp_path}/agent.sock"
    server, _ = serve(f"unix://{sock}", node_name="node-t", device="cpu")
    made = []

    def factory(node, target):
        made.append(node)
        return ExecTunnelDialer([sys.executable, "-S", "-c", _BRIDGE, sock])

    runtime = GrpcRuntime({"node-t": "tunnel:opaque"}, dialer_factory=factory)
    desc = get("trace", "exec")
    params = desc.params().to_params()
    params.set("source", "pysynthetic")
    params.set("rate", "10000")
    ctx = GadgetContext(desc, gadget_params=params, timeout=1.0)
    events = []
    try:
        result = runtime.run_gadget(ctx, on_event=events.append)
    finally:
        runtime.close()
        server.stop(grace=0.5).wait(10.0)
    assert made == ["node-t"]
    assert not result.errors()
    assert events and events[0].node == "node-t"


# -- the CLI as a black box ---------------------------------------------------

def run_cli(*args, timeout=180, env=None):
    return subprocess.run(PORT + list(args), capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT, env=env)


def test_cli_deploy_render():
    r = run_cli("deploy", "--render")
    assert r.returncode == 0
    assert "kind: DaemonSet" in r.stdout
    assert "nvidia.com/gpu: 1" in r.stdout
    assert "inspektor_gadget_tpu_torch.agent.main, serve" in r.stdout


def _wait_live(target: str, proc: subprocess.Popen, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            pytest.fail(f"agent exited {proc.returncode} before it answered")
        if agent_main(["liveness", "--target", target]) == 0:
            return
        time.sleep(0.3)
    pytest.fail(f"agent at {target} never answered liveness")


def test_cli_traces_lifecycle_against_live_daemon(tmp_path):
    """The kubectl-gadget advise ergonomics as a black box: a real agent
    daemon subprocess + `ig-tpu-torch traces` verbs from separate CLI
    processes (ref: cmd/kubectl-gadget/utils/trace.go:340-848)."""
    addr = f"unix://{tmp_path}/agent.sock"
    remote = f"n0={addr}"
    daemon = subprocess.Popen(
        PORT + ["agent", "--listen", addr, "--node-name", "n0", "--no-doctor", "--device",
                "cpu", "--flight-record-path", "off"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=ROOT)
    try:
        _wait_live(addr, daemon)
        r = run_cli("traces", "list", "--remote", remote)
        assert r.returncode == 0, r.stderr
        r = run_cli("traces", "start", "--remote", remote, "--name", "bb1",
                    "--gadget", "advise/seccomp-profile",
                    "-p", "source=pysynthetic", "-p", "rate=20000")
        assert r.returncode == 0, r.stderr
        assert "bb1 Started" in r.stdout
        time.sleep(1.0)
        r = run_cli("traces", "generate", "--remote", remote, "--name", "bb1")
        assert r.returncode == 0, r.stderr
        assert "defaultAction" in r.stdout
        r = run_cli("traces", "delete", "--remote", remote, "--name", "bb1")
        assert r.returncode == 0 and "deleted=True" in r.stdout
    finally:
        daemon.terminate()
        try:
            daemon.wait(timeout=15)
        except subprocess.TimeoutExpired:
            daemon.kill()


# -- the local fleet ------------------------------------------------------------

def test_deploy_local_undeploy_local_round_trip(tmp_path, capsys, monkeypatch):
    """`deploy --local 2 --device cpu` (in this process, so its agents are
    this process's children), the routes that default to the local
    fleet, then `undeploy_local` reaping both with exit 0."""
    from inspektor_gadget_tpu_torch.cli import main as cli

    state = str(tmp_path / "agents.json")
    assert deploy_mod.state_file(state) == state
    assert deploy_mod.STATE_FILE != "/tmp/ig-tpu-agents.json"
    monkeypatch.setenv(deploy_mod.STATE_FILE_ENV, state)
    capsys.readouterr()
    assert cli.main(["deploy", "--local", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    spec = out.strip().split("use: --remote ", 1)[1]
    targets = dict(kv.split("=", 1) for kv in spec.split(","))
    try:
        assert sorted(targets) == ["node-0", "node-1"]
        ports = {int(t.rsplit(":", 1)[1]) for t in targets.values()}
        assert len(ports) == 2 and not ports & set(range(50151, 50151 + 64))
        assert deploy_mod.local_targets(state) == targets
        doc = json.loads(Path(state).read_text())
        assert doc["device"] == "cpu" and set(doc["pids"]) == set(targets)
        children = {n: deploy_mod._CHILDREN[pid] for n, pid in doc["pids"].items()}
        for node, target in targets.items():
            _wait_live(target, children[node])
        # a second deploy over a live fleet is refused, the fleet kept
        with pytest.raises(RuntimeError, match="already running"):
            deploy_mod.deploy_local(1, device="cpu", path=state)
        assert cli.main(["deploy", "--local", "1", "--device", "cpu"]) == 2
        assert "already running" in capsys.readouterr().err
        # the routes that default to the local fleet read the state file
        assert cli.main(["debug", "state"]) == 0
        out = capsys.readouterr().out
        assert all(f"=== {n} ({t}) ===" in out for n, t in targets.items())
        assert cli.main(["trace", "exec", "--remote", spec, "--source", "pysynthetic",
                         "--rate", "5000", "--batch-size", "256", "--timeout", "1",
                         "-o", "json"]) == 0
        rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("{")]
        assert {r["node"] for r in rows} == set(targets)
    finally:
        stopped = deploy_mod.undeploy_local(state, wait=30.0)
    assert sorted(stopped) == ["node-0", "node-1"]
    assert all(deploy_mod.EXIT_CODES[n] == 0 for n in stopped), deploy_mod.EXIT_CODES
    assert not Path(state).exists() and deploy_mod.local_targets(state) == {}
    assert deploy_mod.undeploy_local(state) == []


def test_cli_deploy_local_needs_a_card_unless_cpu(tmp_path):
    """`deploy --local` takes --device: the default, cuda, starts agents
    that exit 1 without a card; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    state = str(tmp_path / "agents.json")
    env = dict(os.environ, **{deploy_mod.STATE_FILE_ENV: state})
    r = run_cli("deploy", "--local", "1", env=env)
    assert r.returncode == 0, r.stderr
    assert "started 1 agents; use: --remote node-0=127.0.0.1:" in r.stdout
    pid = json.loads(Path(state).read_text())["pids"]["node-0"]
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline and deploy_mod._alive(pid):
        time.sleep(0.2)
    assert not deploy_mod._alive(pid), "a cuda agent without a card kept running"
    r = run_cli("undeploy", env=env)
    assert r.returncode == 0 and r.stdout.startswith("stopped 0 agents")
