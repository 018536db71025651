"""Manifest apply / rollout wait / undeploy — the deploy.go contract.

Reference: cmd/kubectl-gadget/deploy.go:100-546 parses the rendered
manifests into unstructured objects, applies each through a dynamic
client, then polls the DaemonSet until desiredNumberScheduled ==
numberReady before returning; undeploy.go deletes the same set. The
cluster API is abstracted behind `Applier` so the same deploy/undeploy
logic drives a real cluster (KubectlApplier shells out to kubectl, the
sanctioned no-client-go path) or a test double (FakeClusterApplier keeps
cluster state in a pod-manifest file the pod informer can watch — the
round-trip used by tests/test_deploy_apply.py).

The port's copy of ``inspektor_gadget_tpu/cli/apply.py``.
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Protocol


def split_manifests(yaml_text: str) -> list[str]:
    """Split a multi-doc YAML stream on '---' lines (no YAML dep)."""
    docs, cur = [], []
    for line in yaml_text.splitlines():
        if line.strip() == "---":
            if any(l.strip() for l in cur):
                docs.append("\n".join(cur))
            cur = []
        else:
            cur.append(line)
    if any(l.strip() for l in cur):
        docs.append("\n".join(cur))
    return docs


def manifest_kind_name(doc: str) -> tuple[str, str]:
    """(kind, metadata.name) of a manifest doc — enough structure for
    apply bookkeeping without a YAML parser (the manifests are ours)."""
    kind = name = ""
    in_meta = False
    for line in doc.splitlines():
        s = line.strip()
        # only the first, top-level kind counts — nested ones (e.g. a
        # ClusterRoleBinding's roleRef.kind) must not overwrite it
        if s.startswith("kind:") and not kind and not line.startswith(" "):
            kind = s.split(":", 1)[1].strip()
        elif s.startswith("metadata:"):
            in_meta = True
        elif in_meta and s.startswith("name:") and not name:
            name = s.split(":", 1)[1].strip()
        elif in_meta and line and not line.startswith(" "):
            in_meta = False
    return kind, name


class Applier(Protocol):
    """Seam between deploy logic and the cluster (dynamic-client role)."""

    def apply(self, doc: str) -> None: ...

    def delete(self, doc: str) -> None: ...

    def rollout_status(self, namespace: str, name: str) -> tuple[int, int]:
        """(desired, ready) for the agent DaemonSet."""
        ...


class KubectlApplier:
    """Shells out to kubectl (the no-client-go apply path)."""

    def __init__(self, kubectl: str = "kubectl", context: str = ""):
        self.base = [kubectl] + (["--context", context] if context else [])

    def _run(self, args: list[str], stdin: str | None = None) -> str:
        res = subprocess.run(self.base + args, input=stdin, text=True,
                             capture_output=True)
        if res.returncode != 0:
            raise RuntimeError(f"kubectl {' '.join(args)}: {res.stderr.strip()}")
        return res.stdout

    def apply(self, doc: str) -> None:
        self._run(["apply", "-f", "-"], stdin=doc)

    def delete(self, doc: str) -> None:
        self._run(["delete", "--ignore-not-found", "-f", "-"], stdin=doc)

    def rollout_status(self, namespace: str, name: str) -> tuple[int, int]:
        out = self._run(["-n", namespace, "get", "daemonset", name,
                         "-o", "json"])
        status = json.loads(out).get("status", {})
        return (int(status.get("desiredNumberScheduled", 0)),
                int(status.get("numberReady", 0)))


class FakeClusterApplier:
    """Test double: applied manifests become cluster state on disk. A
    DaemonSet apply materializes one agent 'pod' per fake node into a
    pod-manifest JSON file, which `containers.file_pod_source` can watch —
    closing the deploy → discovery loop without a kube API."""

    def __init__(self, pod_file: str, nodes: tuple[str, ...] = ("node-0",),
                 ready_after: int = 0):
        self.pod_file = pod_file
        self.nodes = nodes
        self.applied: dict[tuple[str, str], str] = {}
        self.deleted: list[tuple[str, str]] = []
        self._status_polls = 0
        self.ready_after = ready_after  # polls before pods turn ready

    def apply(self, doc: str) -> None:
        kind, name = manifest_kind_name(doc)
        self.applied[(kind, name)] = doc
        if kind == "DaemonSet":
            self._write_pods()

    def delete(self, doc: str) -> None:
        kind, name = manifest_kind_name(doc)
        self.applied.pop((kind, name), None)
        self.deleted.append((kind, name))
        if kind == "DaemonSet":
            self._write_pods()

    def rollout_status(self, namespace: str, name: str) -> tuple[int, int]:
        if ("DaemonSet", name) not in self.applied:
            return (0, 0)
        self._status_polls += 1
        ready = len(self.nodes) if self._status_polls > self.ready_after else 0
        return (len(self.nodes), ready)

    def _write_pods(self) -> None:
        has_ds = any(k == "DaemonSet" for k, _ in self.applied)
        pods = [{
            "name": f"ig-tpu-agent-{n}",
            "namespace": "ig-tpu",
            "uid": f"uid-{n}",
            "node": n,
            "labels": {"k8s-app": "ig-tpu-agent"},
            "containers": [{"name": "agent", "id": f"agent-{n}", "pid": 0}],
        } for n in self.nodes] if has_ds else []
        with open(self.pod_file, "w") as f:
            json.dump({"pods": pods}, f)


def deploy(applier: Applier, manifests: str, namespace: str = "ig-tpu",
           daemonset: str = "ig-tpu-agent", rollout_timeout: float = 120.0,
           poll: float = 1.0) -> tuple[int, int]:
    """Apply every manifest doc then wait for the DaemonSet rollout
    (deploy.go's apply + waitForGadgetPods). Returns final (desired,
    ready); raises TimeoutError if the rollout never completes."""
    for doc in split_manifests(manifests):
        applier.apply(doc)
    deadline = time.monotonic() + rollout_timeout
    desired = ready = 0
    while time.monotonic() < deadline:
        desired, ready = applier.rollout_status(namespace, daemonset)
        if desired > 0 and ready >= desired:
            return desired, ready
        time.sleep(poll)
    raise TimeoutError(
        f"rollout of {daemonset}: {ready}/{desired} ready after "
        f"{rollout_timeout}s")


def undeploy(applier: Applier, manifests: str) -> list[tuple[str, str]]:
    """Delete every manifest doc in reverse apply order (undeploy.go)."""
    removed = []
    for doc in reversed(split_manifests(manifests)):
        applier.delete(doc)
        removed.append(manifest_kind_name(doc))
    return removed
