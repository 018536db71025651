"""The port's Kubernetes-facing pieces on the CPU, against the JAX
package's: the pod informer (its diffing, node filter and resilience,
and the options that feed a collection from it), ``utils/k8s``'s
`KubeClient` against a fake apiserver, the kubeipresolver's cluster
inventory and TTL cache (with an injected clock, where the reference's
own test sleeps on the wall clock), and ``utils/netns``.

Each case feeds the reference's function and the port's the same
inputs and asserts equal results. The fake apiservers listen on
127.0.0.1 in this process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu import containers as RC
from inspektor_gadget_tpu.operators import kubeipresolver as RK
from inspektor_gadget_tpu.operators import operators as ROps
from inspektor_gadget_tpu.utils import k8s as Rk8s
from inspektor_gadget_tpu.utils import netns as Rnetns
from inspektor_gadget_tpu_torch import containers as PC
from inspektor_gadget_tpu_torch.operators import kubeipresolver as PK
from inspektor_gadget_tpu_torch.operators import operators as POps
from inspektor_gadget_tpu_torch.utils import k8s as Pk8s
from inspektor_gadget_tpu_torch.utils import netns as Pnetns

BOTH = (("reference", RC), ("port", PC))


def _dicts(containers) -> list[dict]:
    return sorted((dataclasses.asdict(c) for c in containers), key=lambda d: d["id"])


# -- the pod informer -------------------------------------------------------------------

def pod(name, ns="default", node="node-a", containers=("main",), labels=None):
    return {"name": name, "namespace": ns, "uid": f"uid-{name}", "node": node,
            "labels": labels or {}, "containers": [{"name": c} for c in containers]}


def test_informer_diffs_adds_and_removes():
    got = {}
    for name, C in BOTH:
        pods = [pod("web", containers=("nginx", "sidecar"))]
        inf = C.PodInformer(lambda: pods, interval=999)
        added, removed = [], []
        inf.on_add = lambda c: added.append(dataclasses.asdict(c))
        inf.on_remove = removed.append
        steps = [inf.refresh(), inf.refresh()]
        pods[:] = [pod("web", containers=("nginx",)),
                   pod("db", containers=("pg",), labels={"tier": "data"})]
        steps.append(inf.refresh())
        pods[0]["containers"][0].update(id="abc", pid=7, mntns=9, image="i:1")
        steps.append(inf.refresh())  # a new key: the old one goes, the new one comes
        got[name] = (steps, added, removed)
    assert got["port"] == got["reference"]
    assert got["port"][0] == [(2, 0), (0, 0), (1, 1), (1, 1)]


def test_informer_node_filter_and_error_resilience():
    got = {}
    for name, C in BOTH:
        calls = {"n": 0}

        def source():
            calls["n"] += 1
            if calls["n"] == 2:
                raise OSError("apiserver blip")
            return [pod("web", node="node-a"), pod("other", node="node-b"),
                    pod("unscheduled", node="")]

        inf = C.PodInformer(source, node_name="node-a", interval=999)
        got[name] = [inf.refresh(), inf.refresh(), inf.refresh(), sorted(inf._known)]
    assert got["port"] == got["reference"]
    assert got["port"][:3] == [(2, 0), (0, 0), (0, 0)]


def test_informer_survives_bad_pod_and_bad_subscriber():
    got = {}
    for name, C in BOTH:
        pods = [{"name": "ok", "namespace": "d", "uid": "u", "node": "", "labels": {},
                 "containers": [{"id": "x"}]}]  # no 'name' key
        inf = C.PodInformer(lambda: pods, interval=999)
        steps = [inf.refresh()]
        pods[0]["containers"] = [{"name": "good"}]
        inf.on_add = lambda c: (_ for _ in ()).throw(RuntimeError("subscriber"))
        inf.on_remove = lambda k: (_ for _ in ()).throw(RuntimeError("subscriber"))
        steps += [inf.refresh(), inf.refresh()]
        pods.clear()
        steps.append(inf.refresh())
        got[name] = steps
    assert got["port"] == got["reference"] == [(0, 0), (1, 0), (0, 0), (0, 1)]


def test_informer_thread_starts_and_stops():
    for name, C in BOTH:
        seen = threading.Event()
        inf = C.PodInformer(lambda: [pod("w")], interval=0.01)
        inf.on_add = lambda c: seen.set()
        inf.start()
        inf.start()  # idempotent
        assert seen.wait(5.0)
        inf.stop()
        assert inf._thread is None


def test_with_pod_informer_and_the_fallback(tmp_path):
    manifest = tmp_path / "pods.json"
    manifest.write_text(json.dumps({"pods": [
        pod("web", ns="prod", containers=("nginx",), labels={"app": "web"})]}))
    listed = tmp_path / "list.json"
    listed.write_text(json.dumps([pod("db")]))
    got = {}
    for name, C in BOTH:
        cc = C.ContainerCollection()
        cc.initialize(C.with_pod_informer(C.file_pod_source(str(manifest)), interval=999))
        first = _dicts(cc.get_all(C.ContainerSelector(namespace="prod")))
        cc._pod_informer.stop()
        busy = C.ContainerCollection()
        busy.initialize(C.with_fake_containers([C.Container(id="c1", name="c1")]),
                        C.with_fallback_pod_informer(C.file_pod_source(str(listed)),
                                                     interval=999))
        empty = C.ContainerCollection()
        empty.initialize(C.with_fallback_pod_informer(C.file_pod_source(str(listed)),
                                                      interval=999))
        empty._pod_informer.stop()
        got[name] = (first, _dicts(busy.get_all()), _dicts(empty.get_all()))
    assert got["port"] == got["reference"]
    assert got["port"][0][0]["pod"] == "web" and got["port"][0][0]["labels"] == {"app": "web"}


def test_file_pod_source_raises_on_a_bad_file(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("[")
    for name, C in BOTH:
        with pytest.raises(ValueError):
            C.file_pod_source(str(bad))()
        with pytest.raises(OSError):
            C.file_pod_source(str(tmp_path / "absent.json"))()
        assert C.PodInformer(C.file_pod_source(str(bad)), interval=999).refresh() == (0, 0)


# -- a fake apiserver -----------------------------------------------------------------------

def _item_pod(ns, name, node="node-a", *ips, cid="deadbeef1234"):
    return {"metadata": {"name": name, "namespace": ns, "uid": f"u-{name}",
                         "labels": {"k8s-app": name}},
            "spec": {"nodeName": node, "hostNetwork": True,
                     "containers": [{"name": "agent", "image": "ig:latest"}]},
            "status": {"containerStatuses": [{"name": "agent",
                                              "containerID": f"containerd://{cid}"}],
                       "podIP": ips[0] if ips else "",
                       "podIPs": [{"ip": ip} for ip in ips]}}


def _svc(ns, name, *ips):
    return {"metadata": {"name": name, "namespace": ns},
            "spec": {"clusterIP": ips[0] if ips else "", "clusterIPs": list(ips)}}


class _FakeApi(BaseHTTPRequestHandler):
    pods: list = []
    services: list = []
    requests: list = []

    def do_GET(self):
        _FakeApi.requests.append((self.path, self.headers.get("Authorization")))
        if "/services" in self.path:
            body = {"items": _FakeApi.services}
        elif "/pods" in self.path:
            body = {"items": _FakeApi.pods}
        elif self.path.startswith("/api/v1/nodes"):
            body = {"items": [{"metadata": {"name": "node-a"}}, {"metadata": {"name": "node-b"}}]}
        elif "daemonsets" in self.path:
            body = {"status": {"desiredNumberScheduled": 2, "numberReady": 1}}
        else:
            self.send_error(404)
            return
        self._reply(body)

    def do_PATCH(self):
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n))
        _FakeApi.requests.append((self.path, self.headers.get("Content-Type")))
        self._reply({"echo": body})

    def _reply(self, body):
        data = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture()
def fake_api():
    server = HTTPServer(("127.0.0.1", 0), _FakeApi)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    _FakeApi.pods = [_item_pod("prod", "web-0", "node-a", "10.0.0.5"),
                     _item_pod("prod", "db-0", "node-b", "10.0.0.6", "fd00::6", cid="cafe")]
    _FakeApi.services = [_svc("prod", "web", "10.96.0.10"), _svc("prod", "headless", "None")]
    _FakeApi.requests = []
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()


def test_kube_client_lists_pods_nodes_and_rollout(fake_api):
    got = {}
    for name, K in (("reference", Rk8s), ("port", Pk8s)):
        _FakeApi.requests = []
        client = K.KubeClient(server=fake_api, token="tok-123")
        got[name] = (client.available(), client.list_pods(node_name="node-a"),
                     client.list_pods(namespace="prod", label_selector="a=b"),
                     client.list_services("prod"), client.node_names(),
                     client.daemonset_status("ig-tpu", "ig-tpu-agent"),
                     client.send("/api/v1/x", {"a": 1}, method="PATCH"),
                     list(_FakeApi.requests))
    assert got["port"] == got["reference"]
    assert got["port"][5] == (2, 1)
    path, auth = got["port"][7][0]
    assert auth == "Bearer tok-123" and "fieldSelector=spec.nodeName%3Dnode-a" in path


def test_pod_source_adapters_feed_the_informer(fake_api):
    got = {}
    for (name, C), K in zip(BOTH, (Rk8s, Pk8s)):
        client = K.KubeClient(server=fake_api)
        from_client = K.pod_source_from_client(client, node_name="node-a")()
        from_api = C.kube_api_pod_source(fake_api, node_name="node-a", token="t")()
        cc = C.ContainerCollection()
        cc.initialize(C.with_pod_informer(K.pod_source_from_client(client), interval=30.0))
        cc._pod_informer.stop()
        got[name] = (from_client, from_api, _dicts(cc.get_all()))
    assert got["port"] == got["reference"]
    assert got["port"][0] == got["port"][1]
    assert [(c["pod"], c["id"]) for c in got["port"][2]] == [("db-0", "cafe"),
                                                             ("web-0", "deadbeef1234")]


def test_kube_client_in_and_out_of_cluster(monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    assert not Pk8s.KubeClient().available() and not Rk8s.KubeClient().available()
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    for K in (Rk8s, Pk8s):
        c = K.KubeClient(insecure=True)
        assert c.server == "https://10.0.0.1:6443" and c._ssl_ctx() is not None
        assert K.KubeClient(server="http://x")._ssl_ctx() is None
    assert Pk8s.SA_DIR == Rk8s.SA_DIR


# -- the kubeipresolver ----------------------------------------------------------------------

def test_inventory_polls_pods_and_services(fake_api):
    ref = RK.kube_inventory(Rk8s.KubeClient(server=fake_api))()
    port = PK.kube_inventory(Pk8s.KubeClient(server=fake_api))()
    assert port == ref
    assert port["10.0.0.5"] == ("pod", "prod/web-0")
    assert port["fd00::6"] == ("pod", "prod/db-0")
    assert port["10.96.0.10"] == ("svc", "prod/web") and "None" not in port
    _FakeApi.services = [_svc("prod", "vip", "10.0.0.5")]  # a pod wins a conflict
    assert (PK.kube_inventory(Pk8s.KubeClient(server=fake_api))()
            == RK.kube_inventory(Rk8s.KubeClient(server=fake_api))())


def test_hosts_inventory(tmp_path):
    hosts = tmp_path / "hosts"
    hosts.write_text("127.0.0.1 localhost # loop\n# comment\n\n10.1.1.1 db db.local\nbad\n")
    assert PK.hosts_inventory(str(hosts)) == RK.hosts_inventory(str(hosts)) == {
        "127.0.0.1": ("host", "localhost"), "10.1.1.1": ("host", "db")}
    assert PK.hosts_inventory(str(tmp_path / "absent")) == {}


@dataclasses.dataclass
class NetEv:
    saddr: str = ""
    daddr: str = ""
    remote: str = ""


def _enrich(mod, op, ev):
    inst = op.instantiate(None, None, op.instance_params().to_params())
    inst.enrich(ev)
    return dataclasses.asdict(ev)


def test_resolver_enriches_via_cluster_inventory(fake_api):
    got = {}
    for name, mod, K in (("reference", RK, Rk8s), ("port", PK, Pk8s)):
        op = mod.KubeIPResolver()
        op.use_kube_client(K.KubeClient(server=fake_api))
        got[name] = _enrich(mod, op, NetEv(saddr="10.0.0.5:443", daddr="10.96.0.10",
                                           remote="8.8.8.8"))
    assert got["port"] == got["reference"]
    assert "pod/prod/web-0" in got["port"]["saddr"] and got["port"]["remote"] == "8.8.8.8"


def test_registered_resolver_enriches_addresses():
    """The registered operators with a static inventory (ref
    tests/test_aux.py:112); each test's inventory is put back."""
    got = {}
    for name, Ops, mod in (("reference", ROps, RK), ("port", POps, PK)):
        op = Ops.get("kubeipresolver")
        saved = (op._cache, op._last)
        op.set_inventory({"10.0.0.5": ("pod", "web-0")})
        try:
            got[name] = _enrich(mod, op, NetEv(saddr="10.0.0.5", daddr="8.8.8.8"))
        finally:
            with op._mu:
                op._cache, op._last = saved
    assert got["port"] == got["reference"]
    assert "pod/web-0" in got["port"]["saddr"] and got["port"]["daddr"] == "8.8.8.8"


def test_resolver_applies_to_gadgets_with_address_fields():
    @dataclasses.dataclass
    class NoAddr:
        pid: int = 0

    class Desc:
        def __init__(self, cls):
            self.event_cls = cls

    for cls in (NetEv, NoAddr, None):
        assert (PK.KubeIPResolver().can_operate_on(Desc(cls))
                == RK.KubeIPResolver().can_operate_on(Desc(cls)))
    assert PK.REFRESH_INTERVAL == RK.REFRESH_INTERVAL


class _Clock:
    def __init__(self) -> None:
        self.t = 5000.0

    def __call__(self) -> float:
        return self.t


def test_cache_refreshes_only_after_its_ttl():
    """The TTL cache on an injected clock: within the refresh interval a
    changed cluster is not seen, past it it is, and an inventory that
    raises keeps the stale cache (the reference's semantics, which its
    own tests reach by sleeping)."""
    cluster = {"10.0.0.5": ("pod", "prod/web-0")}
    calls = {"n": 0}

    def inventory():
        calls["n"] += 1
        if cluster.get("fail"):
            raise OSError("apiserver blip")
        return dict(cluster)

    clock = _Clock()
    op = PK.KubeIPResolver(inventory_fn=inventory, clock=clock)
    op.refresh_interval = 300.0
    assert op.lookup("10.0.0.5") == ("pod", "prod/web-0") and calls["n"] == 1
    cluster.clear()
    clock.t += 299.0
    assert op.lookup("10.0.0.5") == ("pod", "prod/web-0") and calls["n"] == 1
    clock.t += 2.0
    assert op.lookup("10.0.0.5") is None and calls["n"] == 2
    cluster.update({"10.0.0.9": ("pod", "new"), "fail": True})
    clock.t += 301.0
    assert op.lookup("10.0.0.9") is None and calls["n"] == 3  # blip: stale kept
    op.set_inventory({"1.1.1.1": ("host", "x")})  # a static inventory restarts the TTL
    clock.t += 299.0
    assert op.lookup("1.1.1.1") == ("host", "x") and calls["n"] == 3


def test_cache_ttl_against_the_cluster(fake_api):
    """The same cache over the fake apiserver, both packages' resolvers
    at refresh interval 0 (every lookup polls) and the port's also at
    300 s on its injected clock."""
    ref, port = RK.KubeIPResolver(), PK.KubeIPResolver()
    ref.use_kube_client(Rk8s.KubeClient(server=fake_api), refresh_interval=0.0)
    port.use_kube_client(Pk8s.KubeClient(server=fake_api), refresh_interval=0.0)
    assert port.lookup("10.0.0.99") is None and ref.lookup("10.0.0.99") is None
    _FakeApi.pods.append(_item_pod("prod", "new-0", "node-a", "10.0.0.99"))
    assert port.lookup("10.0.0.99") == ref.lookup("10.0.0.99") == ("pod", "prod/new-0")
    clock = _Clock()
    ttl = PK.KubeIPResolver(clock=clock)
    ttl.use_kube_client(Pk8s.KubeClient(server=fake_api), refresh_interval=300.0)
    assert ttl.lookup("10.0.0.5") == ("pod", "prod/web-0")
    _FakeApi.pods = []
    clock.t += 100.0
    assert ttl.lookup("10.0.0.5") == ("pod", "prod/web-0")  # within the TTL: stale
    client = Pk8s.KubeClient(server=fake_api)
    ttl.use_kube_client(client, refresh_interval=0.0)
    assert ttl.lookup("10.0.0.5") is None
    client.server = "http://127.0.0.1:1"  # unreachable: the cache is kept
    _FakeApi.pods = [_item_pod("prod", "web-0", "node-a", "10.0.0.5")]
    ttl.use_kube_client(Pk8s.KubeClient(server=fake_api), refresh_interval=0.0)
    assert ttl.lookup("10.0.0.5") == ("pod", "prod/web-0")
    ttl._inventory_fn = Pk8s.KubeClient(server="http://127.0.0.1:1").list_pods
    assert ttl.lookup("10.0.0.5") == ("pod", "prod/web-0")


# -- utils/netns ----------------------------------------------------------------------------

def test_netns_enter_runs_in_the_target_namespace():
    want = os.stat("/proc/self/ns/net").st_ino
    for mod in (Rnetns, Pnetns):
        assert mod.netns_enter(os.getpid(), lambda: os.stat("/proc/self/ns/net").st_ino) == want
        fd = mod.netns_fd_for_pid(os.getpid())
        assert os.fstat(fd).st_ino == want
        os.close(fd)
        with pytest.raises(ZeroDivisionError):
            mod.netns_enter(os.getpid(), lambda: 1 / 0)
