"""Container-runtime clients (ref: pkg/container-utils — docker client 245
LoC, containerd 45, CRI 295; all behind one ContainerRuntimeClient
interface with GetContainers/GetContainerDetails).

One protocol, four dependency-free implementations:
  DockerClient      HTTP/1.1 over /var/run/docker.sock
  ContainerdClient  containerd's on-disk runtime-v2 task state
                    (/run/containerd/io.containerd.runtime.v2.task/<ns>/<id>
                    — init pid + OCI bundle), the SDK-free window onto the
                    same state containerd.go reads over ttrpc
  CriGrpcClient     the real CRI v1 gRPC surface (ListContainers + verbose
                    ContainerStatus with pid in the info JSON — exactly
                    cri.go:1-295's mechanism) over the runtime socket
  CriClient         crictl front door (CLI fallback)
All degrade to `available() == False` when the socket/dir/binary is absent,
so WithContainerRuntimeEnrichment-style options can probe and fall back to
procfs discovery (the path exercised in this environment).

The port's copy of ``inspektor_gadget_tpu/containers/runtime_client.py``.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
from typing import Protocol

from .container import Container

DOCKER_SOCKET = "/var/run/docker.sock"
CONTAINERD_TASK_ROOT = "/run/containerd/io.containerd.runtime.v2.task"
CRI_SOCKETS = ("/run/containerd/containerd.sock", "/var/run/crio/crio.sock",
               "/run/k3s/containerd/containerd.sock")


class RuntimeClient(Protocol):
    def available(self) -> bool: ...

    def get_containers(self) -> list[Container]: ...


class DockerClient:
    """Minimal Docker Engine API client over the unix socket."""

    def __init__(self, socket_path: str = DOCKER_SOCKET):
        self.socket_path = socket_path

    def available(self) -> bool:
        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(0.5)
            s.connect(self.socket_path)
            s.close()
            return True
        except OSError:
            return False

    def _get(self, path: str) -> bytes:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(5.0)
        s.connect(self.socket_path)
        req = (f"GET {path} HTTP/1.1\r\nHost: docker\r\n"
               f"Connection: close\r\n\r\n")
        s.sendall(req.encode())
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        s.close()
        header, _, body = data.partition(b"\r\n\r\n")
        if b"Transfer-Encoding: chunked" in header:
            out, rest = b"", body
            while rest:
                size_line, _, rest = rest.partition(b"\r\n")
                try:
                    n = int(size_line, 16)
                except ValueError:
                    break
                if n == 0:
                    break
                out += rest[:n]
                rest = rest[n + 2:]
            return out
        return body

    def get_containers(self) -> list[Container]:
        rows = json.loads(self._get("/containers/json"))
        out = []
        for r in rows:
            detail = json.loads(self._get(f"/containers/{r['Id']}/json"))
            pid = detail.get("State", {}).get("Pid", 0)
            labels = r.get("Labels") or {}
            out.append(Container(
                id=r["Id"][:12],
                name=(r.get("Names") or ["/unknown"])[0].lstrip("/"),
                pid=pid,
                labels=labels,
                namespace=labels.get("io.kubernetes.pod.namespace", ""),
                pod=labels.get("io.kubernetes.pod.name", ""),
                runtime="docker",
                oci_image=r.get("Image", ""),
            ))
        return out

    def get_container(self, container_id: str) -> Container | None:
        """Single inspect (one RPC) — the auto-chain completion path."""
        try:
            detail = json.loads(self._get(f"/containers/{container_id}/json"))
        except (OSError, ValueError):
            return None
        if not detail.get("Id"):
            return None
        cfg = detail.get("Config", {})
        labels = cfg.get("Labels") or {}
        return Container(
            id=detail["Id"][:12],
            name=detail.get("Name", "/unknown").lstrip("/"),
            pid=detail.get("State", {}).get("Pid", 0),
            labels=labels,
            namespace=labels.get("io.kubernetes.pod.namespace", ""),
            pod=labels.get("io.kubernetes.pod.name", ""),
            runtime="docker",
            oci_image=cfg.get("Image", ""),
        )


class ContainerdClient:
    """containerd via its runtime-v2 task state on disk.

    The shim keeps one directory per task at
    <root>/<namespace>/<container-id>/ holding `init.pid` and the OCI
    bundle (config.json with annotations incl. k8s identity). Reading it
    needs no SDK and observes exactly what the reference's containerd.go
    asks the daemon for (id, pid, bundle) — ref
    pkg/container-utils/containerd/containerd.go:1-45.
    """

    def __init__(self, task_root: str = CONTAINERD_TASK_ROOT):
        self.task_root = task_root

    def available(self) -> bool:
        try:
            return bool(os.listdir(self.task_root))
        except OSError:
            return False

    def get_containers(self) -> list[Container]:
        out = []
        try:
            namespaces = os.listdir(self.task_root)
        except OSError:
            return out
        for ns in namespaces:
            ns_dir = os.path.join(self.task_root, ns)
            try:
                ids = os.listdir(ns_dir)
            except OSError:
                continue
            for cid in ids:
                c = self._read_task(ns, os.path.join(ns_dir, cid), cid)
                if c is not None:
                    out.append(c)
        return out

    def get_container(self, container_id: str) -> Container | None:
        for c in self.get_containers():
            if c.id == container_id[:12] or container_id.startswith(c.id):
                return c
        return None

    def _read_task(self, ns: str, task_dir: str, cid: str) -> Container | None:
        try:
            pid = int(open(os.path.join(task_dir, "init.pid")).read().strip())
        except (OSError, ValueError):
            return None
        bundle = task_dir  # shim dirs double as the bundle dir; config.json
        config = {}
        for probe in (os.path.join(task_dir, "config.json"),):
            try:
                with open(probe) as f:
                    config = json.load(f)
                break
            except (OSError, ValueError):
                continue
        annotations = config.get("annotations", {}) if config else {}
        # the dialect key tables live in one place: oci_annotations
        from .oci_annotations import resolve_identity
        ident = resolve_identity(annotations)
        return Container(
            id=cid[:12],
            name=(ident.name if ident and ident.name else cid[:12]),
            pid=pid,
            namespace=ident.namespace if ident else "",
            pod=ident.pod if ident else "",
            labels=dict(annotations),
            runtime="containerd",
            bundle=bundle,
        )


class CriGrpcClient:
    """CRI v1 over gRPC — the reference's cri.go mechanism verbatim:
    ListContainers for the running set, then a verbose ContainerStatus per
    container whose info["info"] JSON carries the pid
    (pkg/container-utils/cri/cri.go:1-295, parseExtraInfo). Like the
    reference's single long-lived conn, one channel persists for the
    client's lifetime — a 10-container listing is 11 RPCs on 1 channel,
    not 11 dials."""

    def __init__(self, socket_path: str = ""):
        self.socket_path = socket_path or next(
            (s for s in CRI_SOCKETS if os.path.exists(s)), CRI_SOCKETS[0])
        self._channel = None
        self._methods: dict[str, object] = {}

    def available(self) -> bool:
        if not os.path.exists(self.socket_path):
            return False
        try:
            return self.version() != ""
        except Exception:  # noqa: BLE001 — any RPC failure means "not CRI"
            return False

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None
            self._methods = {}

    def __enter__(self) -> "CriGrpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _call(self, method: str, request, response_cls, timeout: float = 5.0):
        import grpc

        fn = self._methods.get(method)
        if fn is None:
            if self._channel is None:
                self._channel = grpc.insecure_channel(
                    f"unix://{self.socket_path}")
            fn = self._channel.unary_unary(
                f"/runtime.v1.RuntimeService/{method}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=response_cls.FromString,
            )
            self._methods[method] = fn
        try:
            return fn(request, timeout=timeout)
        except grpc.RpcError as e:
            # drop the channel only on transport-level failure; an
            # application-level status (NOT_FOUND for a container that
            # exited between list and status) must not tear down the
            # shared conn mid-listing
            code = e.code() if hasattr(e, "code") else None
            if code in (grpc.StatusCode.UNAVAILABLE,
                        grpc.StatusCode.INTERNAL):
                self.close()
            raise

    def version(self) -> str:
        from . import cri_pb2
        resp = self._call("Version", cri_pb2.VersionRequest(),
                          cri_pb2.VersionResponse, timeout=2.0)
        return resp.runtime_name

    def get_containers(self) -> list[Container]:
        from . import cri_pb2
        req = cri_pb2.ListContainersRequest()
        req.filter.state.state = cri_pb2.CONTAINER_RUNNING
        resp = self._call("ListContainers", req,
                          cri_pb2.ListContainersResponse)
        out = []
        for c in resp.containers:
            labels = dict(c.labels)
            out.append(Container(
                id=c.id[:12],
                name=c.metadata.name,
                pid=self._pid_of(c.id),
                labels=labels,
                namespace=labels.get("io.kubernetes.pod.namespace", ""),
                pod=labels.get("io.kubernetes.pod.name", ""),
                runtime="cri",
                oci_image=c.image_ref or c.image.image,
            ))
        return out

    def get_container(self, container_id: str) -> Container | None:
        """Single verbose ContainerStatus — id, name, labels, image and pid
        in one RPC (no O(N) relist per lookup)."""
        from . import cri_pb2
        try:
            resp = self._call(
                "ContainerStatus",
                cri_pb2.ContainerStatusRequest(container_id=container_id,
                                               verbose=True),
                cri_pb2.ContainerStatusResponse)
        except Exception:  # noqa: BLE001
            return None
        st = resp.status
        if not st.id:
            return None
        pid = 0
        try:
            pid = int(json.loads(resp.info.get("info", "")).get("pid", 0))
        except (ValueError, AttributeError):
            pass
        labels = dict(st.labels)
        return Container(
            id=st.id[:12],
            name=st.metadata.name,
            pid=pid,
            labels=labels,
            namespace=labels.get("io.kubernetes.pod.namespace", ""),
            pod=labels.get("io.kubernetes.pod.name", ""),
            runtime="cri",
            oci_image=st.image_ref or st.image.image,
        )

    def _pid_of(self, container_id: str) -> int:
        """Verbose status → info JSON → pid (cri.go parseExtraInfo)."""
        from . import cri_pb2
        try:
            resp = self._call(
                "ContainerStatus",
                cri_pb2.ContainerStatusRequest(container_id=container_id,
                                               verbose=True),
                cri_pb2.ContainerStatusResponse)
        except Exception:  # noqa: BLE001
            return 0
        raw = resp.info.get("info", "")
        try:
            return int(json.loads(raw).get("pid", 0))
        except (ValueError, AttributeError):
            return 0


class CriClient:
    """CRI-compatible runtimes via crictl (containerd/CRI-O front door)."""

    def available(self) -> bool:
        return shutil.which("crictl") is not None

    def get_containers(self) -> list[Container]:
        try:
            raw = subprocess.run(
                ["crictl", "ps", "-o", "json"], capture_output=True,
                text=True, timeout=10, check=True,
            ).stdout
        except (subprocess.SubprocessError, OSError):
            return []
        out = []
        for c in json.loads(raw).get("containers", []):
            labels = c.get("labels", {})
            out.append(Container(
                id=c.get("id", "")[:12],
                name=c.get("metadata", {}).get("name", ""),
                labels=labels,
                namespace=labels.get("io.kubernetes.pod.namespace", ""),
                pod=labels.get("io.kubernetes.pod.name", ""),
                runtime="cri",
            ))
        return out

    def get_container(self, container_id: str) -> Container | None:
        """crictl inspect (one subprocess) — auto-chain completion path."""
        try:
            raw = subprocess.run(
                ["crictl", "inspect", container_id], capture_output=True,
                text=True, timeout=10, check=True,
            ).stdout
            d = json.loads(raw)
        except (subprocess.SubprocessError, OSError, ValueError):
            return None
        st = d.get("status", {})
        labels = st.get("labels", {})
        return Container(
            id=st.get("id", container_id)[:12],
            name=st.get("metadata", {}).get("name", ""),
            pid=int(d.get("info", {}).get("pid", 0)),
            labels=labels,
            namespace=labels.get("io.kubernetes.pod.namespace", ""),
            pod=labels.get("io.kubernetes.pod.name", ""),
            runtime="cri",
        )


def detect_runtime_client() -> RuntimeClient | None:
    """Probe order mirrors the reference (docker, containerd, CRI gRPC,
    crictl)."""
    for client in (DockerClient(), ContainerdClient(), CriGrpcClient(),
                   CriClient()):
        if client.available():
            return client
        # rejected probes must not pin resources (CriGrpcClient caches a
        # channel from its availability RPC)
        closer = getattr(client, "close", None)
        if closer is not None:
            closer()
    return None


def with_runtime_enrichment(client: RuntimeClient | None = None):
    """ContainerCollection option (ref: options.go:132-197
    WithContainerRuntimeEnrichment): seeds the collection with the
    runtime's current containers AND installs an enricher on the add path,
    so a container arriving with only an id (an OCI hook, runc fanotify)
    is auto-completed from the runtime — name, pid, pod identity, labels.
    Silent no-op when no runtime socket exists."""

    def opt(cc):
        rc = client if client is not None else detect_runtime_client()
        if rc is None:
            return

        def enrich(c: Container) -> bool:
            # already complete: nothing to ask the runtime for
            if c.pid and c.name:
                return True
            full = None
            if c.id and hasattr(rc, "get_container"):
                full = rc.get_container(c.id)
            if full is None:
                return True  # keep the container; runtime doesn't know it
            c.pid = c.pid or full.pid
            c.name = c.name or full.name
            c.namespace = c.namespace or full.namespace
            c.pod = c.pod or full.pod
            c.runtime = c.runtime or full.runtime
            c.oci_image = c.oci_image or full.oci_image
            c.bundle = c.bundle or full.bundle
            for k, v in full.labels.items():
                c.labels.setdefault(k, v)
            return True

        # runtime completion must run BEFORE namespace enrichment in the
        # chain: a hook-shaped add (id only) gets its pid here, which the
        # ns enricher then resolves to mntns/netns
        cc.add_enricher(enrich)
        from .options import with_linux_namespace_enrichment
        with_linux_namespace_enrichment()(cc)

        def seed():
            # deferred until ALL options are installed (initialize post
            # phase) so later-registered enrichers — e.g. OCI-config,
            # which needs the bundle these containers carry — apply to the
            # seeded set too
            for c in rc.get_containers():
                cc.add_container(c)

        return seed

    return opt
