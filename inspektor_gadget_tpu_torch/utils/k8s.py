"""k8sutil — the kube-API client abstraction (ref: pkg/k8sutil, 74 LoC:
a clientset constructor resolving in-cluster vs kubeconfig credentials).

Stdlib-only (urllib + ssl): resolves credentials the way client-go's
rest.InClusterConfig does — the mounted service-account token, CA cert and
KUBERNETES_SERVICE_HOST/PORT env — with explicit server/token/CA as the
out-of-cluster path. One `KubeClient` serves every consumer (pod informer,
node listing, deploy status checks) so the API plumbing lives in one
place instead of per-feature urllib calls.

The port's copy of ``inspektor_gadget_tpu/utils/k8s.py``.
"""

from __future__ import annotations

import json
import os
import ssl
import urllib.request

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeClient:
    """Minimal typed facade over the apiserver REST API."""

    def __init__(self, server: str = "", token: str = "",
                 ca_cert: str = "", insecure: bool = False,
                 timeout: float = 5.0):
        self.server = server or self._in_cluster_server()
        self.token = token if token else self._read_sa("token")
        self.ca_cert = ca_cert or (
            f"{SA_DIR}/ca.crt" if os.path.exists(f"{SA_DIR}/ca.crt") else "")
        self.insecure = insecure
        self.timeout = timeout

    # -- credential resolution (rest.InClusterConfig contract) --------------

    @staticmethod
    def _in_cluster_server() -> str:
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        return f"https://{host}:{port}" if host else ""

    @staticmethod
    def _read_sa(name: str) -> str:
        try:
            with open(f"{SA_DIR}/{name}") as f:
                return f.read().strip()
        except OSError:
            return ""

    def available(self) -> bool:
        return bool(self.server)

    # -- transport ----------------------------------------------------------

    def _ssl_ctx(self):
        if not self.server.startswith("https"):
            return None
        if self.insecure:
            return ssl._create_unverified_context()  # noqa: S323
        if self.ca_cert:
            return ssl.create_default_context(cafile=self.ca_cert)
        return None

    def get(self, path: str) -> dict:
        req = urllib.request.Request(self.server + path)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        with urllib.request.urlopen(req, timeout=self.timeout,
                                    context=self._ssl_ctx()) as resp:
            return json.load(resp)

    def send(self, path: str, body: dict, method: str = "PUT") -> dict:
        """Write a resource (PUT/PATCH/POST); returns the response body.
        The write half the Trace controller needs to park status/output on
        the resource (trace_controller.go's Status().Update role)."""
        data = json.dumps(body).encode()
        req = urllib.request.Request(self.server + path, data=data,
                                     method=method)
        req.add_header("Content-Type",
                       "application/merge-patch+json" if method == "PATCH"
                       else "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        with urllib.request.urlopen(req, timeout=self.timeout,
                                    context=self._ssl_ctx()) as resp:
            raw = resp.read()
        return json.loads(raw) if raw else {}

    # -- typed helpers ------------------------------------------------------

    def list_pods(self, namespace: str = "", node_name: str = "",
                  label_selector: str = "") -> list[dict]:
        path = (f"/api/v1/namespaces/{namespace}/pods" if namespace
                else "/api/v1/pods")
        params = []
        if node_name:
            params.append(f"fieldSelector=spec.nodeName%3D{node_name}")
        if label_selector:
            params.append(f"labelSelector={label_selector}")
        if params:
            path += "?" + "&".join(params)
        return self.get(path).get("items", [])

    def list_services(self, namespace: str = "") -> list[dict]:
        path = (f"/api/v1/namespaces/{namespace}/services" if namespace
                else "/api/v1/services")
        return self.get(path).get("items", [])

    def list_nodes(self) -> list[dict]:
        return self.get("/api/v1/nodes").get("items", [])

    def daemonset_status(self, namespace: str, name: str) -> tuple[int, int]:
        """(desired, ready) — the rollout-wait check (deploy.go parity)."""
        obj = self.get(f"/apis/apps/v1/namespaces/{namespace}"
                       f"/daemonsets/{name}")
        status = obj.get("status", {})
        return (int(status.get("desiredNumberScheduled", 0)),
                int(status.get("numberReady", 0)))

    def node_names(self) -> list[str]:
        return [n.get("metadata", {}).get("name", "")
                for n in self.list_nodes()]


def pod_source_from_client(client: KubeClient, node_name: str = ""):
    """Adapt a KubeClient into the pod informer's PodSource shape (the
    client-go-free informer feed; see containers.podinformer)."""

    def list_pods() -> list[dict]:
        pods = []
        for item in client.list_pods(node_name=node_name):
            meta = item.get("metadata", {})
            spec = item.get("spec", {})
            status = item.get("status", {})
            ids = {
                cs.get("name"): cs.get("containerID", "").rpartition("//")[2]
                for cs in status.get("containerStatuses", ())
            }
            pods.append({
                "name": meta.get("name", ""),
                "namespace": meta.get("namespace", ""),
                "uid": meta.get("uid", ""),
                "node": spec.get("nodeName", ""),
                "labels": meta.get("labels", {}),
                "hostNetwork": spec.get("hostNetwork", False),
                "containers": [
                    {"name": c.get("name", ""),
                     "id": ids.get(c.get("name"), ""),
                     "image": c.get("image", "")}
                    for c in spec.get("containers", ())
                ],
            })
        return pods

    return list_pods
