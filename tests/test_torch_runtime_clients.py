"""The port's container-runtime clients, OCI annotation resolvers and
enrichment options on the CPU, against the JAX package's.

Each case points the reference's client (or option) and the port's at
the same fake: containerd's runtime-v2 task directory, a CRI v1 gRPC
server on a unix socket, a duck-typed runtime, OCI bundles on disk,
and asserts they return the same containers (every field). Every
backend degrades when its socket, directory or binary is absent, in both
packages. Importing the port's ``containers`` imports neither ``grpc``
nor ``cri_pb2``: an ordinary run needs no grpcio.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from concurrent import futures

import grpc
import pytest

from inspektor_gadget_tpu import containers as RC
from inspektor_gadget_tpu.containers import cri_pb2
from inspektor_gadget_tpu.containers import oci_annotations as ROci
from inspektor_gadget_tpu.containers import runtime_client as RRt
from inspektor_gadget_tpu_torch import containers as PC
from inspektor_gadget_tpu_torch.containers import oci_annotations as POci
from inspektor_gadget_tpu_torch.containers import runtime_client as PRt

BOTH = (("reference", RC), ("port", PC))


def _dicts(containers) -> list[dict]:
    return sorted((dataclasses.asdict(c) for c in containers), key=lambda d: d["id"])


def test_importing_containers_needs_no_grpc():
    code = ("import sys; import inspektor_gadget_tpu_torch.containers as C; "
            "C.detect_runtime_client; "
            "print(sorted(m for m in sys.modules if m.startswith('grpc') or "
            "m.endswith('cri_pb2') or m.startswith('google.protobuf')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


# -- containerd: on-disk runtime-v2 task state --------------------------------------

def _fake_task(root, ns, cid, pid, annotations, config=True):
    d = os.path.join(root, ns, cid)
    os.makedirs(d)
    with open(os.path.join(d, "init.pid"), "w") as f:
        f.write(str(pid))
    if config:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"annotations": annotations, "process": {"env": ["A=1"]},
                       "mounts": [{"destination": "/etc/hosts"}]}, f)


def test_containerd_client_reads_task_state(tmp_path):
    root = str(tmp_path)
    _fake_task(root, "k8s.io", "abcdef123456789", 4242, {
        "io.kubernetes.cri.container-name": "web",
        "io.kubernetes.cri.sandbox-name": "pod-1",
        "io.kubernetes.cri.sandbox-namespace": "prod",
    })
    _fake_task(root, "moby", "fedcba987654321", 4343, {})
    _fake_task(root, "moby", "noconfig00000000", 4444, {}, config=False)
    os.makedirs(os.path.join(root, "moby", "nopid0000000000"))
    got = {}
    for name, C in BOTH:
        client = C.ContainerdClient(task_root=root)
        got[name] = (client.available(), _dicts(client.get_containers()),
                     dataclasses.asdict(client.get_container("abcdef123456789")),
                     client.get_container("000000000000"))
    assert got["port"] == got["reference"]
    assert len(got["port"][1]) == 3 and got["port"][2]["name"] == "web"


def test_containerd_client_degrades_without_root(tmp_path):
    for name, C in BOTH:
        client = C.ContainerdClient(task_root=str(tmp_path / "nope"))
        assert not client.available() and client.get_containers() == []


# -- CRI over gRPC against a fake CRI server (the real wire path) --------------------

class _FakeCri:
    def __init__(self):
        self.calls: dict[str, int] = {}
        self.containers = [
            ("c1" * 16, "web", {"io.kubernetes.pod.name": "pod-a",
                                "io.kubernetes.pod.namespace": "ns-a"}, 111),
            ("d2" * 16, "db", {}, 222),
        ]

    def _count(self, method: str) -> None:
        self.calls[method] = self.calls.get(method, 0) + 1

    def version(self, request: bytes, ctx) -> bytes:
        self._count("Version")
        return cri_pb2.VersionResponse(version="0.1.0", runtime_name="fake-cri",
                                       runtime_version="1.0",
                                       runtime_api_version="v1").SerializeToString()

    def list_containers(self, request: bytes, ctx) -> bytes:
        self._count("ListContainers")
        req = cri_pb2.ListContainersRequest.FromString(request)
        assert req.filter.state.state == cri_pb2.CONTAINER_RUNNING
        resp = cri_pb2.ListContainersResponse()
        for cid, name, labels, _pid in self.containers:
            c = resp.containers.add()
            c.id = cid
            c.metadata.name = name
            c.state = cri_pb2.CONTAINER_RUNNING
            c.image.image = f"img/{name}"
            for k, v in labels.items():
                c.labels[k] = v
        return resp.SerializeToString()

    def container_status(self, request: bytes, ctx) -> bytes:
        self._count("ContainerStatus")
        req = cri_pb2.ContainerStatusRequest.FromString(request)
        assert req.verbose
        match = next(((n, lb, p) for cid, n, lb, p in self.containers
                      if cid == req.container_id), None)
        resp = cri_pb2.ContainerStatusResponse()
        if match is None:
            ctx.abort(grpc.StatusCode.NOT_FOUND, "no such container")
        name, labels, pid = match
        resp.status.id = req.container_id
        resp.status.metadata.name = name
        resp.status.image_ref = f"sha256:{name}"
        for k, v in labels.items():
            resp.status.labels[k] = v
        resp.info["info"] = json.dumps({"pid": pid, "sandboxID": "s1"})
        return resp.SerializeToString()


@pytest.fixture()
def fake_cri():
    tmp = tempfile.mkdtemp()
    sock = f"{tmp}/cri.sock"
    fake = _FakeCri()
    ident = lambda b: b  # noqa: E731
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(fn, request_deserializer=ident,
                                                  response_serializer=ident)
        for name, fn in (("Version", fake.version), ("ListContainers", fake.list_containers),
                         ("ContainerStatus", fake.container_status))}
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler("runtime.v1.RuntimeService", handlers),))
    server.add_insecure_port(f"unix://{sock}")
    server.start()
    yield sock, fake
    server.stop(grace=0.2)


def test_cri_grpc_client_lists_with_pids(fake_cri):
    sock, _fake = fake_cri
    got = {}
    for name, C in BOTH:
        with C.CriGrpcClient(socket_path=sock) as client:
            got[name] = (client.available(), client.version(), _dicts(client.get_containers()),
                         dataclasses.asdict(client.get_container("c1" * 16)))
    assert got["port"] == got["reference"]
    assert {c["name"]: c["pid"] for c in got["port"][2]} == {"web": 111, "db": 222}


def test_cri_grpc_client_single_channel_rpc_budget(fake_cri, monkeypatch):
    """A 10-container listing costs ONE dial and 1+N RPCs in both
    packages (the reference's cri.go holds a single long-lived conn)."""
    sock, fake = fake_cri
    fake.containers = [(f"{i:02d}" * 16, f"c{i}", {}, 1000 + i) for i in range(10)]
    dials = {"n": 0}
    real_dial = grpc.insecure_channel

    def counting_dial(*a, **kw):
        dials["n"] += 1
        return real_dial(*a, **kw)

    monkeypatch.setattr(grpc, "insecure_channel", counting_dial)
    got = {}
    for name, C in BOTH:
        dials["n"] = 0
        fake.calls.clear()
        with C.CriGrpcClient(socket_path=sock) as client:
            listed = _dicts(client.get_containers())
        got[name] = (listed, dials["n"], dict(fake.calls))
    assert got["port"] == got["reference"]
    assert got["port"][1:] == (1, {"ListContainers": 1, "ContainerStatus": 10})


def test_cri_grpc_client_redials_after_transport_error(fake_cri, tmp_path):
    sock, _fake = fake_cri
    for name, C in BOTH:
        client = C.CriGrpcClient(socket_path=str(tmp_path / "dead.sock"))
        with pytest.raises(grpc.RpcError):
            client.version()
        assert client._channel is None  # the transport failure dropped the channel
        client.socket_path = sock
        assert client.version() == "fake-cri"  # redialed against the live one
        client.close()


def test_cri_grpc_client_keeps_channel_on_not_found(fake_cri):
    sock, _fake = fake_cri
    for name, C in BOTH:
        client = C.CriGrpcClient(socket_path=sock)
        assert client.version() == "fake-cri"
        chan = client._channel
        assert client.get_container("ff" * 16) is None
        assert client._pid_of("ff" * 16) == 0
        assert client._channel is chan  # the same channel, no redial
        client.close()


def test_cri_grpc_client_degrades_without_socket(tmp_path):
    for name, C in BOTH:
        assert not C.CriGrpcClient(socket_path=str(tmp_path / "absent.sock")).available()


def test_docker_and_crictl_clients_degrade(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no crictl
    for name, C in BOTH:
        d = C.DockerClient(str(tmp_path / "nonexistent.sock"))
        assert d.available() is False and d.get_container("x") is None
        cri = C.CriClient()
        assert cri.available() is False
        assert cri.get_containers() == [] and cri.get_container("x") is None
    assert PRt.DOCKER_SOCKET == RRt.DOCKER_SOCKET
    assert PRt.CONTAINERD_TASK_ROOT == RRt.CONTAINERD_TASK_ROOT
    assert PRt.CRI_SOCKETS == RRt.CRI_SOCKETS


def _docker_server(sock: str, routes: dict[str, object], chunked: bool):
    """A one-connection-at-a-time HTTP/1.1 server on a unix socket,
    answering GET paths from `routes` (JSON bodies), chunked or not."""
    import socket
    import threading

    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock)
    srv.listen(8)
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            with conn:
                req = b""
                while b"\r\n\r\n" not in req:
                    chunk = conn.recv(4096)
                    if not chunk:
                        break
                    req += chunk
                if not req:
                    continue  # an availability probe: connect and close
                path = req.split(b" ")[1].decode()
                body = json.dumps(routes.get(path, {})).encode()
                if chunked:
                    half = len(body) // 2
                    payload = b"".join(b"%x\r\n%s\r\n" % (len(p), p)
                                       for p in (body[:half], body[half:]) if p) + b"0\r\n\r\n"
                    head = b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
                else:
                    payload = body
                    head = b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n" % len(body)
                conn.sendall(head + payload)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return srv, stop


@pytest.mark.parametrize("chunked", [False, True])
def test_docker_client_over_a_fake_engine_socket(tmp_path, chunked):
    routes = {
        "/containers/json": [{"Id": "0123456789abcdef", "Names": ["/web"], "Image": "nginx",
                              "Labels": {"io.kubernetes.pod.name": "p",
                                         "io.kubernetes.pod.namespace": "ns"}}],
        "/containers/0123456789abcdef/json": {
            "Id": "0123456789abcdef", "Name": "/web", "State": {"Pid": 77},
            "Config": {"Image": "nginx:1", "Labels": {"io.kubernetes.pod.name": "p"}}},
    }
    sock = str(tmp_path / "docker.sock")
    srv, stop = _docker_server(sock, routes, chunked)
    try:
        got = {}
        for name, C in BOTH:
            client = C.DockerClient(sock)
            got[name] = (client.available(), _dicts(client.get_containers()),
                         dataclasses.asdict(client.get_container("0123456789abcdef")),
                         client.get_container("missing"))
    finally:
        stop.set()
        srv.close()
    assert got["port"] == got["reference"]
    assert got["port"][1][0]["pid"] == 77 and got["port"][2]["oci_image"] == "nginx:1"


# -- enrichment options ---------------------------------------------------------------

class _FakeRuntime:
    """Duck-typed RuntimeClient backed by a dict."""

    def __init__(self, containers):
        self.by_id = {c.id: c for c in containers}

    def available(self):
        return True

    def get_containers(self):
        return list(self.by_id.values())

    def get_container(self, cid):
        return self.by_id.get(cid[:12])


def test_runtime_enrichment_auto_chain():
    got = {}
    for name, C in BOTH:
        full = C.Container(id="aaa111bbb222", name="web", pid=os.getpid(), namespace="ns",
                           pod="pod-x", runtime="fake", labels={"team": "infra"})
        cc = C.ContainerCollection()
        cc.initialize(C.with_runtime_enrichment(client=_FakeRuntime([full])))
        seeded = dataclasses.asdict(cc.get("aaa111bbb222"))
        cc.remove_container("aaa111bbb222")
        cc.add_container(C.Container(id="aaa111bbb222"))  # hook-shaped: id only
        cc.add_container(C.Container(id="unknown-to-runtime", name="manual",
                                     pid=os.getpid()))
        got[name] = (seeded, dataclasses.asdict(cc.get("aaa111bbb222")),
                     dataclasses.asdict(cc.get("unknown-to-runtime")))
    assert got["port"] == got["reference"]
    assert got["port"][1]["mntns"] > 0 and got["port"][1]["labels"] == {"team": "infra"}


def test_runtime_detection_degrades():
    for name, C in BOTH:
        cc = C.ContainerCollection()
        cc.initialize(C.with_runtime_enrichment())  # no runtime here: a no-op
        assert len(cc) == 0
    assert (type(PRt.detect_runtime_client()).__name__
            == type(RRt.detect_runtime_client()).__name__)


def test_oci_config_enrichment(tmp_path):
    bundle = tmp_path / "c9"
    bundle.mkdir()
    (bundle / "config.json").write_text(json.dumps({
        "process": {"env": ["PATH=/usr/bin", "MODE=prod"]},
        "mounts": [{"destination": "/data"}, {"destination": "/etc/ssl"}, {"type": "x"}],
        "annotations": {"org.opencontainers.image.ref.name": "img:1"},
        "linux": {"seccomp": {"defaultAction": "SCMP_ACT_ERRNO"}},
    }))
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "config.json").write_text("{not json")
    got = {}
    for name, C in BOTH:
        cc = C.ContainerCollection()
        cc.initialize(C.with_oci_config_enrichment(bundle_root=str(tmp_path)))
        for cid in ("c9", "bad", "absent"):
            cc.add_container(C.Container(id=cid, name="app", pid=os.getpid()))
        by_bundle = C.Container(id="zz", bundle=str(bundle))
        cc.add_container(by_bundle)
        got[name] = _dicts(cc.get_all())
    assert got["port"] == got["reference"]
    c9 = next(c for c in got["port"] if c["id"] == "c9")
    assert c9["mounts"] == ["/data", "/etc/ssl"] and c9["seccomp_profile"] == "SCMP_ACT_ERRNO"


ANNOTATIONS = {
    "containerd": {
        "io.kubernetes.cri.sandbox-name": "pod-cd",
        "io.kubernetes.cri.sandbox-namespace": "ns-cd",
        "io.kubernetes.cri.sandbox-uid": "uid-cd",
        "io.kubernetes.cri.container-name": "app-cd",
        "io.kubernetes.cri.container-type": "container",
    },
    "cri-o": {
        "io.container.manager": "cri-o",
        "io.kubernetes.pod.name": "pod-cr",
        "io.kubernetes.pod.namespace": "ns-cr",
        "io.kubernetes.pod.uid": "uid-cr",
        "io.kubernetes.container.name": "app-cr",
        "io.kubernetes.cri-o.ContainerType": "container",
    },
    "mixed, containerd first": {"io.kubernetes.cri.sandbox-namespace": "ns-mixed",
                                "io.kubernetes.container.name": "app-mixed"},
    "mixed, cri-o first": {"io.container.manager": "cri-o",
                           "io.kubernetes.pod.namespace": "ns2",
                           "io.kubernetes.cri.sandbox-name": "pod2"},
    "kubelet labels only": {"io.kubernetes.pod.name": "p"},
    "container name only": {"io.kubernetes.container.name": "n"},
    "cri prefix only": {"io.kubernetes.cri.anything": "v"},
    "unrelated": {"unrelated": "x"},
    "empty": {},
}


@pytest.mark.parametrize("case", list(ANNOTATIONS))
def test_oci_annotation_dialects_resolve_identity(case):
    ann = ANNOTATIONS[case]
    ref, port = ROci.resolve_identity(ann), POci.resolve_identity(ann)
    assert (None if port is None else dataclasses.asdict(port)) == (
        None if ref is None else dataclasses.asdict(ref))
    r, p = ROci.resolver_from_annotations(ann), POci.resolver_from_annotations(ann)
    assert (None if p is None else p.runtime) == (None if r is None else r.runtime)


def test_oci_annotation_resolvers_by_name(tmp_path):
    for runtime in ("containerd", "cri-o", "docker"):
        r, p = ROci.resolver_for(runtime), POci.resolver_for(runtime)
        assert (p is None) == (r is None)
        if p is not None:
            ann = ANNOTATIONS[runtime]
            assert dataclasses.asdict(p.resolve(ann)) == dataclasses.asdict(r.resolve(ann))
    for cid, ann in (("cd1", ANNOTATIONS["containerd"]), ("cr1", ANNOTATIONS["cri-o"])):
        (tmp_path / cid).mkdir()
        (tmp_path / cid / "config.json").write_text(json.dumps({"annotations": ann}))
    got = {}
    for name, C in BOTH:
        cc = C.ContainerCollection()
        cc.initialize(C.with_oci_config_enrichment(bundle_root=str(tmp_path)))
        cc.add_container(C.Container(id="cd1", pid=os.getpid()))
        cc.add_container(C.Container(id="cr1", pid=os.getpid()))
        got[name] = _dicts(cc.get_all())
    assert got["port"] == got["reference"]
    assert [(c["pod"], c["namespace"], c["name"]) for c in got["port"]] == [
        ("pod-cd", "ns-cd", "app-cd"), ("pod-cr", "ns-cr", "app-cr")]


def test_with_host_adds_host_pseudo_container():
    got = {}
    for name, C in BOTH:
        cc = C.ContainerCollection()
        cc.initialize(C.with_host())
        host = cc.get("host")
        got[name] = (dataclasses.asdict(host),
                     host.mntns and cc.lookup_by_mntns(host.mntns).id)
    assert got["port"] == got["reference"]
    assert got["port"][0]["pid"] == 1 and got["port"][0]["runtime"] == "host"
