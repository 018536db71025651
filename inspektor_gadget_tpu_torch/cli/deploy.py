"""deploy/undeploy: render + manage the per-node agent rollout.

Reference contract: cmd/kubectl-gadget/deploy.go (546 LoC) renders embedded
manifests (DaemonSet, ServiceAccount, RBAC, CRD — pkg/resources/manifests)
and applies them, waiting for rollout; undeploy.go removes them. Without a
live kube API here, `deploy --render` emits the equivalent manifests
(DaemonSet running the agent with a GPU + hostPID for capture, RBAC,
namespace) for kubectl, and `deploy --local n` starts n local agent
daemons for development — the minikube analogue.

The port's copy of ``inspektor_gadget_tpu/cli/deploy.py``. Its DaemonSet
runs the port's agent (``inspektor_gadget_tpu_torch.agent.main serve
--device cuda``) with one ``nvidia.com/gpu`` a node. `deploy_local`
starts the port's agents on ``device`` (``cuda`` by default; the port's
agents never fall back, so a fleet on a host without a card takes
``cpu``), on free loopback ports unless a base port is given, and keeps
its state in its own file: ``$IG_TPU_TORCH_AGENTS``, else
``ig-tpu-torch-agents.json`` in the temp directory — never the
reference's ``/tmp/ig-tpu-agents.json``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

AGENT_IMAGE = "ghcr.io/inspektor-gadget-tpu/agent-torch:latest"
NAMESPACE = "ig-tpu"
STATE_FILE_ENV = "IG_TPU_TORCH_AGENTS"
STATE_FILE = os.path.join(tempfile.gettempdir(), "ig-tpu-torch-agents.json")

# agents this process started: pid -> Popen (so undeploy can reap them)
_CHILDREN: dict[int, subprocess.Popen] = {}
# node -> exit code of the agents this process started and undeploy reaped
EXIT_CODES: dict[str, int] = {}


def render_manifests(image: str = AGENT_IMAGE, namespace: str = NAMESPACE,
                     gpu_resource: str = "nvidia.com/gpu",
                     gpus_per_node: int = 1) -> str:
    return f"""apiVersion: v1
kind: Namespace
metadata:
  name: {namespace}
---
apiVersion: v1
kind: ServiceAccount
metadata:
  name: ig-tpu-agent
  namespace: {namespace}
---
apiVersion: rbac.authorization.k8s.io/v1
kind: ClusterRole
metadata:
  name: ig-tpu-agent
rules:
- apiGroups: [""]
  resources: [pods, services, nodes]
  verbs: [get, list, watch]
---
apiVersion: rbac.authorization.k8s.io/v1
kind: ClusterRoleBinding
metadata:
  name: ig-tpu-agent
roleRef:
  apiGroup: rbac.authorization.k8s.io
  kind: ClusterRole
  name: ig-tpu-agent
subjects:
- kind: ServiceAccount
  name: ig-tpu-agent
  namespace: {namespace}
---
apiVersion: apps/v1
kind: DaemonSet
metadata:
  name: ig-tpu-agent
  namespace: {namespace}
spec:
  selector:
    matchLabels: {{k8s-app: ig-tpu-agent}}
  template:
    metadata:
      labels: {{k8s-app: ig-tpu-agent}}
    spec:
      serviceAccountName: ig-tpu-agent
      hostPID: true
      hostNetwork: true
      containers:
      - name: agent
        image: {image}
        command: [python, -m, inspektor_gadget_tpu_torch.agent.main, serve,
                  --listen, "tcp://0.0.0.0:50051",
                  --node-name, "$(NODE_NAME)", --device, cuda]
        env:
        - name: NODE_NAME
          valueFrom: {{fieldRef: {{fieldPath: spec.nodeName}}}}
        securityContext:
          capabilities: {{add: [NET_RAW, NET_ADMIN, SYS_PTRACE]}}
        resources:
          limits:
            {gpu_resource}: {gpus_per_node}
        volumeMounts:
        - {{name: proc, mountPath: /host/proc, readOnly: true}}
        - {{name: run, mountPath: /run}}
      volumes:
      - {{name: proc, hostPath: {{path: /proc}}}}
      - {{name: run, hostPath: {{path: /run}}}}
"""


def state_file(path: str | None = None) -> str:
    """The local fleet's state file: `path`, else $IG_TPU_TORCH_AGENTS,
    else STATE_FILE."""
    return path or os.environ.get(STATE_FILE_ENV) or STATE_FILE


def _alive(pid: int) -> bool:
    """Whether `pid` runs: a child of this process by its Popen, another
    by signal 0, a zombie (exited, not yet reaped by its parent) as not."""
    child = _CHILDREN.get(pid)
    if child is not None:
        return child.poll() is None
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return True


def _free_port(host: str = "127.0.0.1") -> int:
    """A port the kernel hands out for `host`:0, released for the caller
    to bind."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _agent_env() -> dict[str, str]:
    """This process's environment with the package's root on PYTHONPATH,
    so `-m inspektor_gadget_tpu_torch...` resolves from any cwd."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    existing = env.get("PYTHONPATH", "")
    if root not in existing.split(os.pathsep):
        env["PYTHONPATH"] = root + (os.pathsep + existing if existing else "")
    return env


def deploy_local(n: int, base_port: int = 0, *, device: str = "cuda",
                 path: str | None = None, log_dir: str | None = None) -> dict[str, str]:
    """Start n local agent daemons (subprocesses) on `device`; returns
    node→target. Ports are base_port+i, or free ones when base_port is 0.
    Each agent's flight record goes beside the state file; its output to
    `log_dir`/<node>.log when given, else nowhere."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r} not in ['cuda', 'cpu']")
    sf = state_file(path)
    # refuse to orphan a live fleet: a second deploy would fail port-bind
    # and overwrite the only record of the running agents
    try:
        with open(sf) as f:
            old = json.load(f)
        if any(_alive(p) for p in old.get("pids", {}).values()):
            raise RuntimeError(
                "a local agent fleet is already running — "
                "`ig-tpu-torch undeploy` it first")
    except (OSError, ValueError):
        pass

    stem = os.path.splitext(sf)[0]
    env = _agent_env()
    targets = {}
    pids = {}
    for i in range(n):
        node = f"node-{i}"
        port = base_port + i if base_port else _free_port()
        out = subprocess.DEVNULL
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            out = open(os.path.join(log_dir, f"{node}.log"), "w")
        try:
            p = subprocess.Popen(
                [sys.executable, "-m", "inspektor_gadget_tpu_torch.agent.main", "serve",
                 "--listen", f"127.0.0.1:{port}", "--node-name", node,
                 "--device", device, "--flight-record-path", f"{stem}-{node}-flight.json"],
                stdout=out, stderr=subprocess.STDOUT, env=env,
            )
        finally:
            if out is not subprocess.DEVNULL:
                out.close()
        _CHILDREN[p.pid] = p
        targets[node] = f"127.0.0.1:{port}"
        pids[node] = p.pid
    os.makedirs(os.path.dirname(os.path.abspath(sf)), exist_ok=True)
    with open(sf, "w") as f:
        json.dump({"targets": targets, "pids": pids, "device": device}, f)
    return targets


def local_targets(path: str | None = None) -> dict[str, str]:
    try:
        with open(state_file(path)) as f:
            return json.load(f)["targets"]
    except (OSError, ValueError, KeyError):
        return {}


def undeploy_local(path: str | None = None, *, wait: float = 0.0) -> list[str]:
    """Stop agents started by deploy_local (ref: undeploy.go removes the
    DaemonSet + RBAC; here we terminate the local fleet). With `wait`,
    wait up to that many seconds for each to exit (raising TimeoutError
    naming those still running); the exit codes of agents this process
    started land in EXIT_CODES."""
    sf = state_file(path)
    stopped = []
    try:
        with open(sf) as f:
            state = json.load(f)
    except (OSError, ValueError):
        return stopped
    pids = state.get("pids", {})
    for node, pid in pids.items():
        if not _alive(pid):
            continue
        try:
            os.kill(pid, signal.SIGTERM)
            stopped.append(node)
        except OSError:  # dead pid, or recycled pid owned by someone else
            pass
    try:
        os.unlink(sf)
    except OSError:
        pass
    if wait > 0:
        deadline = time.monotonic() + wait
        running = []
        for node in stopped:
            pid = pids[node]
            child = _CHILDREN.get(pid)
            if child is not None:
                try:
                    EXIT_CODES[node] = child.wait(timeout=max(0.0, deadline - time.monotonic()))
                    _CHILDREN.pop(pid, None)
                except subprocess.TimeoutExpired:
                    running.append(node)
                continue
            while _alive(pid) and time.monotonic() < deadline:
                time.sleep(0.05)
            if _alive(pid):
                running.append(node)
        if running:
            raise TimeoutError(f"agents still running {wait:g} s after SIGTERM: "
                               f"{', '.join(running)}")
    return stopped


def render_undeploy(namespace: str = NAMESPACE) -> str:
    """Deletion list for kubectl delete -f (undeploy.go:1-254 analogue)."""
    return (
        f"# kubectl delete -f - <<EOF\n"
        f"apiVersion: v1\nkind: Namespace\nmetadata:\n  name: {namespace}\n"
        f"---\napiVersion: rbac.authorization.k8s.io/v1\nkind: ClusterRole\n"
        f"metadata:\n  name: ig-tpu-agent\n"
        f"---\napiVersion: rbac.authorization.k8s.io/v1\n"
        f"kind: ClusterRoleBinding\nmetadata:\n  name: ig-tpu-agent\n"
        f"# EOF\n"
    )
