"""Pod informer: watch this node's pods, diff container lists, emit events.

Reference contract: pkg/container-collection/podinformer.go:41-185 — a k8s
informer scoped to `spec.nodeName == <node>` whose update handler diffs each
pod's container-status list and calls createdContainerCallback /
deletedContainerCallback; wired in by WithPodInformer (options.go:199) and
WithFallbackPodInformer (options.go:207, only activates when runtime-socket
discovery found nothing).

Redesign: the informer core is backend-agnostic — it polls a `list_pods`
callable and diffs snapshots (client-go's SharedInformer is itself a
watch+resync loop; with no cluster guaranteed in this environment, a
poll-with-diff gives the same contract deterministically). Backends:

- any callable returning pod dicts (tests, custom integrations),
- `file_pod_source` — a JSON manifest on disk (static/edge deployments;
  also how the agent fleet in cli/deploy.py describes its pods),
- `kube_api_pod_source` — the real apiserver over its HTTP API
  (kubelet-style `fieldSelector=spec.nodeName=`), stdlib urllib only,
  degrading gracefully when unreachable.

Pod dict schema (subset of v1.Pod): {"name", "namespace", "uid", "node",
"labels": {...}, "hostNetwork": bool, "containers": [{"name", "id", "pid"?,
"mntns"?, "image"?}]}.

The port's copy of ``inspektor_gadget_tpu/containers/podinformer.py``.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Callable, Iterable

from .container import Container

log = logging.getLogger("ig-tpu.podinformer")

PodSource = Callable[[], Iterable[dict]]


def _pod_containers(pod: dict) -> dict[str, Container]:
    """Flatten one pod dict into {container_key: Container}."""
    out: dict[str, Container] = {}
    for c in pod.get("containers", ()):
        key = c.get("id") or f"{pod.get('namespace', '')}/{pod.get('name', '')}/{c['name']}"
        out[key] = Container(
            id=key,
            name=c["name"],
            pid=int(c.get("pid", 0)),
            mntns=int(c.get("mntns", 0)),
            namespace=pod.get("namespace", ""),
            pod=pod.get("name", ""),
            pod_uid=pod.get("uid", ""),
            labels=dict(pod.get("labels", {})),
            host_network=bool(pod.get("hostNetwork", False)),
            oci_image=c.get("image", ""),
            runtime="podinformer",
        )
    return out


class PodInformer:
    """Poll a pod source, diff container sets, invoke add/remove callbacks.

    ref: podinformer.go:41 (NewPodInformer), :120-185 (update diffing).
    """

    def __init__(self, source: PodSource, node_name: str = "",
                 interval: float = 2.0):
        self.source = source
        self.node_name = node_name
        self.interval = interval
        self.on_add: Callable[[Container], None] | None = None
        self.on_remove: Callable[[str], None] | None = None
        self._known: dict[str, Container] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    def refresh(self) -> tuple[int, int]:
        """One list+diff cycle; returns (n_added, n_removed). Errors in the
        source or in malformed pod dicts leave the known set untouched
        (stale-but-consistent, the same stance as the reference's informer
        resync on apiserver blips); a raising subscriber callback skips
        that one event but never kills the informer."""
        try:
            pods = list(self.source())
            current: dict[str, Container] = {}
            for pod in pods:
                if self.node_name and pod.get("node") not in ("", None,
                                                              self.node_name):
                    continue
                current.update(_pod_containers(pod))
        except Exception:
            return 0, 0
        with self._lock:
            added = [c for k, c in current.items() if k not in self._known]
            removed = [k for k in self._known if k not in current]
            self._known = current
        for c in added:
            if self.on_add:
                try:
                    self.on_add(c)
                except Exception as e:  # noqa: BLE001 — one bad callback must not stop the diff
                    log.warning("pod-informer add callback failed: %r", e)
        for k in removed:
            if self.on_remove:
                try:
                    self.on_remove(k)
                except Exception as e:  # noqa: BLE001
                    log.warning("pod-informer remove callback failed: %r", e)
        return len(added), len(removed)

    def start(self) -> None:
        if self._thread:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self.refresh()
                self._stop.wait(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="pod-informer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
            self._thread = None


def file_pod_source(path: str) -> PodSource:
    """Pods from a JSON file: either a list of pod dicts or {"pods": [...]}.
    A missing/invalid file raises; the informer's refresh() absorbs the
    error and keeps its last-known state."""

    def list_pods() -> list[dict]:
        with open(path) as f:
            data = json.load(f)
        return data["pods"] if isinstance(data, dict) else data

    return list_pods


def kube_api_pod_source(api_server: str, node_name: str = "",
                        token: str = "", timeout: float = 5.0) -> PodSource:
    """Pods from the apiserver REST API (stdlib urllib; the client-go-free
    path). Maps v1.PodList items onto the informer's pod dict schema."""

    def list_pods() -> list[dict]:
        import urllib.request

        url = f"{api_server}/api/v1/pods"
        if node_name:
            url += f"?fieldSelector=spec.nodeName%3D{node_name}"
        req = urllib.request.Request(url)
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = json.load(resp)
        pods = []
        for item in body.get("items", ()):
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
                    {"name": c.get("name", ""), "id": ids.get(c.get("name"), ""),
                     "image": c.get("image", "")}
                    for c in spec.get("containers", ())
                ],
            })
        return pods

    return list_pods
