"""The port's container tracking on the CPU, against the JAX package's.

Each case builds the reference's object and the port's from the same
inputs and asserts equal results: selector matching, the mntns lookup
and its removal grace, enrichment by mntns, tracer-collection
membership (and its cap), the native containers map (the port's own
build of the capture library, mirrored from a collection and held to
the reference collection's names), the attach mixins' refcounts and
their detach on teardown, the localmanager and kubemanager selectors,
and the slice end to end: both packages' `LocalRuntime` run
``trace/exec`` on the pysynthetic source with a kubemanager namespace
selector over the same 64 seeded containers, one for each synthetic
mount namespace, and give the same final summary and rows naming the
same containers. The black-box case runs ``ig-tpu-torch trace exec`` on
a child in its own mount namespace.

Both packages' operator registries and localmanager collections live
in this process: a test that seeds a collection removes what it added
(the removal grace cache too), and a test that subscribes unsubscribes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu import containers as RC
from inspektor_gadget_tpu import gadgets as RG
from inspektor_gadget_tpu import params as RPm
from inspektor_gadget_tpu.containers import collection as r_collection
from inspektor_gadget_tpu.gadgets import source_gadget as RSG
from inspektor_gadget_tpu.operators import operators as ROps
from inspektor_gadget_tpu.runtime.local import LocalRuntime as RefLocalRuntime
from inspektor_gadget_tpu_torch import containers as PC
from inspektor_gadget_tpu_torch import gadgets as PG
from inspektor_gadget_tpu_torch import params as PPm
from inspektor_gadget_tpu_torch.containers import collection as p_collection
from inspektor_gadget_tpu_torch.gadgets import source_gadget as PSG
from inspektor_gadget_tpu_torch.operators import operators as POps
from inspektor_gadget_tpu_torch.runtime import LocalRuntime
from inspektor_gadget_tpu_torch.sources import bridge as B

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"reference": (RC, ROps), "port": (PC, POps)}
MNTNS0 = 4026531840  # the synthetic sources' first mount namespace (64 of them)
SMALL = {"enable": "true", "depth": "3", "log2-width": "10", "hll-p": "8",
         "entropy-log2-width": "6", "topk": "8", "harvest-interval": "1h",
         "invertible": "true", "inv-log2-buckets": "9", "quantiles": "true",
         "audit-sample": "64"}
BATCH = 4096
RTOL = 1e-4


# -- the container model and collection -----------------------------------------

def make_cc(C):
    cc = C.ContainerCollection()
    cc.initialize(
        C.with_node_name("node-1"),
        C.with_fake_containers([
            C.Container(id="c1", name="web", pod="web-pod", namespace="prod",
                        mntns=1001, pid=100, labels={"app": "web"}),
            C.Container(id="c2", name="db", pod="db-pod", namespace="prod",
                        mntns=1002, pid=200),
            C.Container(id="c3", name="web", pod="web-2", namespace="dev",
                        mntns=1003, pid=300),
        ]),
    )
    return cc


def both(fn):
    """fn(containers module) for the reference and the port."""
    return fn(RC), fn(PC)


SELECTORS = [{}, {"name": "web"}, {"namespace": "prod", "name": "web"},
             {"labels": {"app": "web"}}, {"labels": {"app": "x"}}, {"pod": "db-pod"},
             {"namespace": "dev", "labels": {}}]


@pytest.mark.parametrize("sel", SELECTORS, ids=lambda s: json.dumps(s, sort_keys=True))
def test_selector_matching(sel):
    ref, port = both(lambda C: sorted(
        c.id for c in make_cc(C).get_all(C.ContainerSelector(**sel))))
    assert port == ref
    r1, p1 = both(lambda C: [C.ContainerSelector(**sel).matches(c)
                             for c in make_cc(C).get_all()])
    assert p1 == r1


def test_container_fields_are_the_reference_s():
    names = [f.name for f in dataclasses.fields(RC.Container)]
    assert [f.name for f in dataclasses.fields(PC.Container)] == names
    assert dataclasses.asdict(PC.Container()) == dataclasses.asdict(RC.Container())
    assert ([f.name for f in dataclasses.fields(PC.ContainerSelector)]
            == [f.name for f in dataclasses.fields(RC.ContainerSelector)])
    assert [e.value for e in PC.EventType] == [e.value for e in RC.EventType]
    assert p_collection.REMOVED_CACHE_TTL == r_collection.REMOVED_CACHE_TTL
    assert PC.__all__ == RC.__all__


class _Clock:
    """A module's `time`, with a monotonic clock the test moves."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def monotonic(self) -> float:
        return self.t


def test_mntns_lookup_and_removal_grace(monkeypatch):
    out = {}
    for name, C, mod in (("reference", RC, r_collection), ("port", PC, p_collection)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        cc = make_cc(C)
        seen = [cc.lookup_by_mntns(1001).name, len(cc)]
        cc.remove_container("c1")
        cc.remove_container("nope")  # unknown ids are ignored
        clock.t += mod.REMOVED_CACHE_TTL - 0.25
        # the grace cache keeps late events enrichable (ref: options.go:689)
        seen += [cc.lookup_by_mntns(1001).name, len(cc), cc.get("c1")]
        clock.t += 0.5  # past the TTL: the hit-time check refuses it
        seen.append(cc.lookup_by_mntns(1001))
        clock.t += 1.0  # the amortized sweep drops it
        seen += [cc.lookup_by_mntns(1001), sorted(cc._removed)]
        seen.append(sorted(c.id for c in cc.lookup_by_netns(0)))
        out[name] = seen
    assert out["port"] == out["reference"] == ["web", 3, "web", 2, None, None, None, [], []]


def test_lookup_by_netns_and_pubsub():
    def run(C):
        cc = C.ContainerCollection()
        cc.initialize(C.with_fake_containers([
            C.Container(id="a", name="a", netns=7, mntns=11),
            C.Container(id="b", name="b", netns=7, mntns=12)]))
        events = []
        current = sorted(c.id for c in cc.subscribe("k", events.append))
        cc.add_container(C.Container(id="c", name="c", netns=8, mntns=13))
        cc.add_container(C.Container(id="c", name="dup"))  # an id is added once
        cc.remove_container("a")
        cc.unsubscribe("k")
        cc.remove_container("b")
        with pytest.raises(RuntimeError, match="already initialized"):
            cc.initialize()
        return (current, [(e.type.value, e.container.id) for e in events],
                [c.id for c in cc.lookup_by_netns(7)], [c.id for c in cc.lookup_by_netns(8)])

    ref, port = both(run)
    assert port == ref == (["a", "b"], [("add", "c"), ("remove", "a")], [], ["c"])


def test_enrichers_run_in_order_and_may_drop():
    def run(C):
        cc = C.ContainerCollection()
        order = []
        cc.add_enricher(lambda c: order.append(("first", c.id)) or True)
        cc.add_enricher(lambda c: order.append(("second", c.id)) or c.id != "drop")
        cc.initialize()
        cc.add_container(C.Container(id="keep", mntns=1))
        cc.add_container(C.Container(id="drop", mntns=2))
        return order, sorted(c.id for c in cc.get_all()), cc.lookup_by_mntns(2)

    ref, port = both(run)
    assert port == ref


@dataclasses.dataclass
class Ev:
    mountnsid: int = 0
    container: str = ""
    pod: str = ""
    namespace: str = ""
    node: str = ""


@pytest.mark.parametrize("mntns, node", [(1002, ""), (1001, "preset"), (999, ""), (0, "")])
def test_event_enrichment_by_mntns(mntns, node):
    def run(C):
        ev = Ev(mountnsid=mntns, node=node)
        make_cc(C).enrich_event_by_mntns(ev)
        return dataclasses.asdict(ev)

    ref, port = both(run)
    assert port == ref


def test_tracer_collection_tracks_membership():
    def run(C):
        cc = make_cc(C)
        tc = C.TracerCollection(cc)
        tc.add_tracer("t1", C.ContainerSelector(name="web"))
        tc.add_tracer("all", C.ContainerSelector())
        seen = [tc.tracer_mntns_set("t1"), tc.tracer_count()]
        cc.add_container(C.Container(id="c4", name="web", mntns=1004, pid=400))
        cc.add_container(C.Container(id="c5", name="db", mntns=1005, pid=500))
        seen.append(tc.tracer_mntns_set("t1"))
        cc.remove_container("c1")
        seen += [tc.tracer_mntns_set("t1"), tc.tracer_mntns_set("all")]
        with pytest.raises(ValueError, match="already exists"):
            tc.add_tracer("t1", C.ContainerSelector())
        tc.remove_tracer("t1")
        with pytest.raises(KeyError):
            tc.tracer_mntns_set("t1")
        tc.close()
        cc.add_container(C.Container(id="c6", name="web", mntns=1006))
        seen.append(tc.tracer_mntns_set("all"))  # closed: no longer follows the collection
        return seen

    ref, port = both(run)
    assert port == ref
    assert port[0] == {1001, 1003} and port[3] == {1003, 1004}


def test_tracer_collection_caps_a_tracer_at_the_reference_s_limit():
    from inspektor_gadget_tpu.containers.tracer_collection import (
        MAX_CONTAINERS_PER_TRACER as REF_MAX)
    from inspektor_gadget_tpu_torch.containers.tracer_collection import (
        MAX_CONTAINERS_PER_TRACER)

    assert MAX_CONTAINERS_PER_TRACER == REF_MAX == 1024

    def run(C):
        cc = C.ContainerCollection()
        cc.initialize(C.with_fake_containers(
            [C.Container(id=f"x{i}", name="n", mntns=10_000 + i) for i in range(1030)]))
        tc = C.TracerCollection(cc, test_only=True)
        tc.add_tracer("t", C.ContainerSelector(name="n"))
        live = C.TracerCollection(cc)
        live.add_tracer("t", C.ContainerSelector(name="n"))
        cc.add_container(C.Container(id="late", name="n", mntns=99))
        got = (sorted(tc.tracer_mntns_set("t")), sorted(live.tracer_mntns_set("t")))
        live.close()
        return got

    ref, port = both(run)
    assert port == ref and len(port[0]) == len(port[1]) == 1024


def test_with_host_and_namespace_enrichment():
    def run(C):
        cc = C.ContainerCollection()
        cc.initialize(C.with_host(), C.with_linux_namespace_enrichment(),
                      C.with_cgroup_enrichment())
        cc.add_container(C.Container(id="me", name="me", pid=os.getpid()))
        return dataclasses.asdict(cc.get("host")), dataclasses.asdict(cc.get("me"))

    ref, port = both(run)
    assert port == ref
    assert port[1]["mntns"] > 0 and port[1]["netns"] > 0


def test_procfs_discovery_scans_as_the_reference_does():
    """Both scans see the same mount namespaces; names and pids may differ
    between two scans only where a process came or went in between."""
    ref, port = both(lambda C: C.ContainerCollection())
    ref.initialize(RC.with_procfs_discovery())
    port.initialize(PC.with_procfs_discovery())
    r = {c.mntns: c.runtime for c in ref.get_all()}
    p = {c.mntns: c.runtime for c in port.get_all()}
    assert set(p.values()) <= {"procfs"}
    stable = set(r) & set(p)
    assert all(p[m] == r[m] for m in stable)


# -- the native containers map ----------------------------------------------------

def test_native_containers_map_mirror():
    """The port's capture library (built by `native.HostLibrary`) holds
    what the collection holds: each add and remove of the reference's
    sequence, read back by mntns, gives the reference collection's name."""
    from inspektor_gadget_tpu_torch.containers.options import with_native_containers_map

    B.LIBRARY.get()  # the port's build; a failure raises
    steps = [("add", "nm1", "webby", 777123), ("add", "nm2", "dbby", 777124),
             ("remove", "nm2", "", 777124), ("add", "nm3", "cache", 777125)]
    ref = RC.ContainerCollection()
    port = PC.ContainerCollection()
    ref.initialize(RC.with_fake_containers([RC.Container(id="nm0", name="seed", mntns=777122)]))
    port.initialize(PC.with_fake_containers([PC.Container(id="nm0", name="seed", mntns=777122)]),
                    with_native_containers_map())
    try:
        assert B.containers_map_lookup(777122) == "seed"
        for op, cid, name, mntns in steps:
            for C, cc in ((RC, ref), (PC, port)):
                if op == "add":
                    cc.add_container(C.Container(id=cid, name=name, mntns=mntns))
                else:
                    cc.remove_container(cid)
            want = ref._by_mntns.get(mntns)
            assert B.containers_map_lookup(mntns) == (want.name if want else "")
        assert B.containers_map_lookup(1) == ""
    finally:
        port.unsubscribe(("native-cmap",))
        for m in (777122, 777123, 777124, 777125):
            B.containers_map_remove(m)
    B.containers_map_set(5, "x" * 300)  # lookups read at most 256 bytes
    assert B.containers_map_lookup(5) == "x" * 256
    B.containers_map_remove(5)
    assert B.containers_map_lookup(5) == ""


# -- the attach mixins --------------------------------------------------------------

needs_attach = pytest.mark.skipif(
    not B.native_available() or os.geteuid() != 0 or not shutil.which("unshare"),
    reason="native capture / root / unshare unavailable")


class _C:
    def __init__(self, id: str, pid: int, name: str = "probe") -> None:
        self.id, self.pid, self.name = id, pid, name


class _Stub:
    """A capture source's lifecycle without the reference's library."""

    def __init__(self) -> None:
        self.stopped = self.closed = False

    def pop(self):
        from inspektor_gadget_tpu.sources import EventBatch
        return EventBatch.alloc(1)

    def stop(self) -> None:
        self.stopped = True

    def close(self) -> None:
        self.closed = True


def _mount_gadget(port: bool):
    """A test-only mount-namespace attacher: one mountinfo poller for each
    distinct mount namespace of the attached containers (the reference's
    trace/mount shape, item 17's gadget). The reference's sources are
    stubs, so its library is never built here."""
    SG, G, kind = (PSG, PG, B.SRC_MOUNTINFO) if port else (RSG, RG, 104)

    class MntWatch(SG.NsRefcountAttachMixin, SG.SourceTraceGadget):
        attach_ns = "mnt"
        native_kind = kind
        kind_filter = (10,)  # EV_MOUNT

        def _ns_source_args(self, pid):
            return kind, f"pid={pid}", 0

        def decode_row(self, batch, i):
            return (int(batch.cols["kind"][i]), int(batch.cols["mntns"][i]))

        if not port:
            def _attach_native_source(self, key, kind, cfg="", ring_pow2=18, seed=0):
                with self._attach_lock:
                    old = self._attach_sources.get(key)
                    self._attach_sources[key] = _Stub()
                if old is not None:
                    self._retire(old)

    ctx = G.GadgetContext(G.get("trace", "exec"), timeout=0.5)
    return MntWatch(ctx), ctx


def _refs(g) -> tuple:
    return (sorted(g._ns_refs.values()), sorted(g._container_ns),
            sorted(k.split("-")[0] for k in g._attach_sources), len(g._retired_sources))


@needs_attach
def test_ns_refcount_attach_matches_the_reference_and_detaches_on_teardown():
    child = subprocess.Popen(["unshare", "-m", "sleep", "30"])
    other = subprocess.Popen(["unshare", "-m", "sleep", "30"])
    try:
        time.sleep(0.3)
        runs = {}
        for port in (False, True):
            g, ctx = _mount_gadget(port)
            seen = []
            g.attach_container(_C("self", os.getpid()))  # the gadget's own mntns: no source
            seen.append(_refs(g))
            g.attach_container(_C("a", child.pid))
            g.attach_container(_C("b", child.pid))  # same mntns: one source, two refs
            g.attach_container(_C("c", other.pid))
            seen.append(_refs(g))
            first = g._attach_sources[f"mntns-{os.stat(f'/proc/{child.pid}/ns/mnt').st_ino}"]
            g.detach_container(_C("a", child.pid))
            seen.append(_refs(g))
            g.detach_container(_C("b", child.pid))  # last ref: retired, not yet closed
            g.detach_container(_C("never", 1))
            seen.append(_refs(g))
            with pytest.raises(ValueError, match="live pid"):
                g.attach_container(_C("dead", 0))
            src = g._attach_sources[f"mntns-{os.stat(f'/proc/{other.pid}/ns/mnt').st_ino}"]
            threading.Thread(target=ctx.wait_for_timeout_or_done, daemon=True).start()
            g.run(ctx)  # attach mode: the attached poller is the capture
            closed = [first, src]
            seen.append((_refs(g)[3], [(s.closed if not port else s._h == 0)
                                       for s in closed]))
            runs[port] = seen
        assert runs[True] == runs[False]
        assert runs[True][1] == ([1, 2], ["a", "b", "c"], ["mntns", "mntns"], 0)
        assert runs[True][3] == ([1], ["c"], ["mntns"], 1)
        assert runs[True][4] == (0, [True, True])
    finally:
        for p in (child, other):
            p.kill()
            p.wait()


@needs_attach
def test_ptrace_attach_matches_the_reference():
    child = subprocess.Popen(["sleep", "30"])
    try:
        runs = {}
        for port in (False, True):
            SG, G = (PSG, PG) if port else (RSG, RG)
            stub = {}

            class Tracer(SG.PtraceAttachMixin, SG.SourceTraceGadget):
                native_kind = 108

                if not port:
                    def _attach_native_source(self, key, kind, cfg="", ring_pow2=18, seed=0):
                        stub[key] = (kind, cfg)
                        self._attach_sources[key] = _Stub()

            ctx = G.GadgetContext(G.get("trace", "exec"))
            g = Tracer(ctx)
            g.attach_container(_C("ptr", child.pid))
            keys = sorted(g._attach_sources)
            with pytest.raises(ValueError, match="live pid"):
                g.attach_container(_C("zero", 0))
            g.detach_container(_C("ptr", child.pid))
            runs[port] = (keys, sorted(g._attach_sources), len(g._retired_sources),
                          g.attach_requires_selector, g.attach_replaces_main)
            for s in g._retired_sources:
                s.close()
        assert runs[True] == runs[False] == (["ptr"], [], 1, True, True)
    finally:
        child.kill()
        child.wait()


def test_container_key_and_mountinfo_helpers(tmp_path):
    for c in (_C("abc", 5), _C("", 7)):
        assert PSG.container_key(c) == RSG.container_key(c)
    for raw in ("/plain", "/with\\040space", "/tab\\011x", "/back\\134slash", "/bad\\0x",
                "/end\\04"):
        assert PSG._unescape_mountinfo(raw) == RSG._unescape_mountinfo(raw)
    assert PSG.fanotify_mount_paths(os.getpid()) == RSG.fanotify_mount_paths(os.getpid())
    assert PSG.fanotify_mount_paths(os.getpid(), max_marks=2) == RSG.fanotify_mount_paths(
        os.getpid(), max_marks=2)
    assert PSG.fanotify_mount_paths(2**22 + 7) == [f"/proc/{2**22 + 7}/root"]


# -- the manager operators ------------------------------------------------------------

def _localmanager(Ops):
    """The package's localmanager, initialized once per process; a first
    init here takes no procfs scan (the test seeds what it needs)."""
    lm = Ops.get("localmanager")
    with Ops._init_lock:
        if "localmanager" not in Ops._initialized:
            gp = lm.global_params().to_params()
            gp.set("containerd-like-discovery", "none")
            lm.init(gp)
            Ops._initialized.add("localmanager")
    return lm


def fleet(C) -> list:
    """64 containers, one for each synthetic mount namespace: 16 of them
    (every fourth) in namespace team-a, the rest in team-b..d."""
    return [C.Container(id=f"synth-{k:02d}", name=f"ctr-{k:02d}", pod=f"pod-{k // 2:02d}",
                        namespace=f"team-{'abcd'[k % 4]}", mntns=MNTNS0 + k,
                        labels={"app": f"app-{k % 3}"}, runtime="fake")
            for k in range(64)]


@pytest.fixture()
def seeded():
    """Both packages' localmanager collections seeded with `fleet`; the
    containers and their grace entries are removed afterwards."""
    lms = {name: _localmanager(Ops) for name, (C, Ops) in PACKAGES.items()}
    for name, (C, Ops) in PACKAGES.items():
        for c in fleet(C):
            lms[name].cc.add_container(c)
    yield lms
    for name, (C, Ops) in PACKAGES.items():
        cc = lms[name].cc
        for c in fleet(C):
            cc.remove_container(c.id)
            with cc._mu:
                cc._removed.pop(c.mntns, None)


class _FilterGadget:
    def __init__(self) -> None:
        self.filter = None

    def set_mntns_filter(self, ids):
        self.filter = ids


KUBE_CASES = [({"namespace": "team-a"}, None), ({"namespace": "team-b", "podname": "pod-00"}, None),
              ({"selector": "app=app-1"}, None), ({"containername": "ctr-05"}, None),
              ({"namespace": "team-a", "selector": "app=app-2,x="}, None),
              ({}, None), (None, {"containername": "ctr-07"}), (None, {})]


@pytest.mark.parametrize("kube, local", KUBE_CASES, ids=lambda v: json.dumps(v))
def test_manager_selectors_push_the_reference_s_filter(seeded, kube, local):
    """The kubemanager's namespace/podname/containername/label selector
    and the localmanager's containername give the reference's mntns
    filter (ref tests/test_aux.py:131), and a bare run sets none."""
    out = {}
    for name, (C, Ops) in PACKAGES.items():
        G = PG if name == "port" else RG
        ctx = G.GadgetContext(G.get("trace", "exec"))
        got = []
        insts = []
        for op_name, values in (("localmanager", local), ("kubemanager", kube)):
            op = Ops.get(op_name)
            params = op.instance_params().to_params()
            for k, v in (values or {}).items():
                params.set(k, v)
            g = _FilterGadget()
            insts.append((op.instantiate(ctx, g, params), g))
        for inst, g in insts:
            inst.pre_gadget_run()
            got.append(None if g.filter is None else sorted(g.filter))
        got.append(bool(ctx.extra.get("container_selector_active")))
        n_tracers = seeded[name].tc.tracer_count()
        for inst, _ in insts:
            inst.post_gadget_run()
        got.append(n_tracers - seeded[name].tc.tracer_count())
        out[name] = got
    assert out["port"] == out["reference"]
    if kube == {"namespace": "team-a"}:
        assert out["port"][1] == [MNTNS0 + k for k in range(0, 64, 4)]


def test_localmanager_enriches_rows_and_tracks_late_containers(seeded):
    """`enrich` names a row by its mount namespace, a container added
    during the run joins the filter, and teardown unsubscribes."""
    out = {}
    for name, (C, Ops) in PACKAGES.items():
        G = PG if name == "port" else RG
        ctx = G.GadgetContext(G.get("trace", "exec"))
        lm = seeded[name]
        params = lm.instance_params().to_params()
        params.set("containername", "late")
        g = _FilterGadget()
        g.attach_container = lambda c, seen=[]: seen.append(c.id)
        g.detach_container = lambda c: None
        inst = lm.instantiate(ctx, g, params)
        inst.pre_gadget_run()
        first = sorted(g.filter)
        lm.cc.add_container(C.Container(id="late-1", name="late", mntns=MNTNS0 + 100))
        second = sorted(g.filter)
        rows = [Ev(mountnsid=MNTNS0 + k) for k in (0, 5, 100, 200)]
        for ev in rows:
            inst.enrich(ev)
        inst.post_gadget_run()
        subscribed = inst in lm.cc._subs
        lm.cc.remove_container("late-1")
        with lm.cc._mu:
            lm.cc._removed.pop(MNTNS0 + 100, None)
        out[name] = (first, second, [dataclasses.asdict(e) for e in rows], subscribed)
    assert out["port"] == out["reference"]
    assert out["port"][1] == [MNTNS0 + 100] and out["port"][3] is False


def test_manager_operators_are_registered_as_the_reference_s():
    """Registered with the reference's params and dependencies; the chain
    for trace/exec (its order fixed by the dependency sort, whatever the
    import order) is the reference's."""
    names = [op.name for op in POps.get_all()]
    assert {"localmanager", "kubemanager", "kubeipresolver"} <= set(names)
    assert names[0] == "localmanager"  # registered first, as in the reference's all_gadgets
    assert POps.get("kubemanager").dependencies() == ["localmanager"]
    desc = PG.get("trace", "exec")
    assert ([op.name for op in POps.get_operators_for_gadget(desc)]
            == [op.name for op in ROps.get_operators_for_gadget(RG.get("trace", "exec"))
                if op.name in names])
    for op in ("localmanager", "kubemanager", "kubeipresolver"):
        assert ([p.key for p in POps.get(op).instance_params()]
                == [p.key for p in ROps.get(op).instance_params()])
        assert ([p.key for p in POps.get(op).global_params()]
                == [p.key for p in ROps.get(op).global_params()])
    assert POps.ensure_initialized("localmanager") is POps.get("localmanager")


# -- the slice end to end -------------------------------------------------------------

class _Run:
    """One package's LocalRuntime run of trace/exec on pysynthetic (seed
    7, batches of 4096), cancelled after `batches` batches."""

    def __init__(self, port: bool, ops: dict, batches: int, rows: bool = False,
                 timeout: float = 0.0) -> None:
        G, Pm, Ops = (PG, PPm, POps) if port else (RG, RPm, ROps)
        desc = G.get("trace", "exec")
        gp = desc.params().to_params()
        for k, v in {"source": "pysynthetic", "seed": "7", "batch-size": str(BATCH),
                     "rate": "1e9"}.items():
            gp.set(k, v)
        col = Pm.Collection()
        for name, values in ops.items():
            col[f"operator.{name}."] = Ops.get(name).instance_params().to_params()
            for k, v in values.items():
                col[f"operator.{name}."].set(k, v)
        self.summaries: list = []
        self.rows: list = []
        self.counts: list[int] = []
        kw = {"device": "cpu"} if port else {}
        self.ctx = G.GadgetContext(desc, gadget_params=gp, operator_params=col,
                                   extra={"on_sketch_summary": self.summaries.append},
                                   timeout=timeout, **kw)

        def batch_cb(batch):
            self.counts.append(batch.count)
            if len(self.counts) == batches:
                self.ctx.cancel()

        runtime = LocalRuntime() if port else RefLocalRuntime()
        self.result = runtime.run_gadget(self.ctx, on_event=self.rows.append if rows else None,
                                         on_batch=batch_cb)["local"]


def _stream_counts(batches: int) -> list[int]:
    """Events of team-a's 16 mount namespaces in each batch of the seeded
    pysynthetic stream (rebuilt here, independently of the runs)."""
    from inspektor_gadget_tpu_torch.sources import PySyntheticSource
    src = PySyntheticSource(kind=1, seed=7, vocab=1000, zipf_s=1.2, batch_size=BATCH)
    out = []
    while len(out) < batches:
        m = src.generate().cols["mntns"][:BATCH]
        n = int(np.isin(m, np.arange(MNTNS0, MNTNS0 + 64, 4, dtype=np.uint64)).sum())
        if n:
            out.append(n)
    return out


def test_namespace_scoped_run_matches_the_reference(seeded):
    ops = {"tpusketch": SMALL, "kubemanager": {"namespace": "team-a"}}
    ref, port = _Run(False, ops, 5), _Run(True, ops, 5)
    assert ref.result.error is None and port.result.error is None, port.result.error
    want = _stream_counts(5)
    assert port.counts == ref.counts == want and 0 < sum(want) < 5 * BATCH
    (got,), (exp,) = port.summaries, ref.summaries
    assert got.events == exp.events == sum(want) and got.drops == exp.drops == 0
    assert np.isclose(got.distinct, exp.distinct, rtol=RTOL, atol=0)
    assert got.entropy_bits == exp.entropy_bits
    for field in ("heavy_hitters", "epoch", "names", "approx", "decoded", "decoded_only",
                  "inv", "classes", "quantiles"):
        assert getattr(got, field) == getattr(exp, field), field
    for k, v in exp.accuracy.items():
        assert np.isclose(got.accuracy[k], v, rtol=RTOL, atol=1e-7) if isinstance(
            v, float) else got.accuracy[k] == v, k


IDENTITY = ("node", "namespace", "pod", "container")


def test_scoped_rows_name_the_seeded_containers_as_the_reference_does(seeded):
    ops = {"kubemanager": {"namespace": "team-a"}}
    ref, port = _Run(False, ops, 3, rows=True), _Run(True, ops, 3, rows=True)
    assert ref.result.error is None and port.result.error is None, port.result.error
    assert len(port.rows) == len(ref.rows) == sum(_stream_counts(3))
    names = {MNTNS0 + k: (f"team-{'abcd'[k % 4]}", f"pod-{k // 2:02d}", f"ctr-{k:02d}")
             for k in range(64)}
    rcols, pcols = ref.ctx.columns, port.ctx.columns
    for r_ev, p_ev in zip(ref.rows, port.rows):
        r, p = rcols.to_dict(r_ev), pcols.to_dict(p_ev)
        assert r.pop("timestamp") and p.pop("timestamp")
        assert p == r
        assert (p["namespace"], p["pod"], p["container"]) == names[p["mountnsid"]]
        assert p["node"] == "local" and p["namespace"] == "team-a"


def test_a_selector_matching_nothing_scores_nothing(seeded):
    """Every batch is filtered to nothing: none reaches the operator, and
    the run's final harvest is empty, as the reference's is."""
    ops = {"tpusketch": SMALL, "localmanager": {"containername": "no-such-ctr"}}
    ref, port = _Run(False, ops, 1, timeout=0.5), _Run(True, ops, 1, timeout=0.5)
    assert ref.result.error is None and port.result.error is None, port.result.error
    assert port.counts == ref.counts == []
    assert [s.events for s in port.summaries] == [s.events for s in ref.summaries] == [0]


# -- the black box ---------------------------------------------------------------------

COMM = "igbb-exec"  # a comm no other process has, so the selector matches only the child


def _child(tmp_path: Path) -> subprocess.Popen:
    """A 'container': a copied shell with a unique comm in its own mount
    namespace, exec'ing /bin/true in a loop."""
    shell = tmp_path / COMM
    shutil.copy("/bin/bash", shell)
    shell.chmod(0o755)
    return subprocess.Popen(["unshare", "-m", str(shell), "-c",
                             "for i in $(seq 1 400); do /bin/true; sleep 0.02; done"])


def _cli(args: list[str]) -> tuple[subprocess.CompletedProcess, list[dict]]:
    proc = subprocess.run(
        [sys.executable, "-m", "inspektor_gadget_tpu_torch.cli.main", "trace", "exec",
         "--device", "cpu", "--source", "native", *args, "--timeout", "4", "-o", "json"],
        capture_output=True, text=True, cwd=ROOT, timeout=240)
    return proc, [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]


@needs_attach
def test_trace_exec_containername_black_box(tmp_path):
    child = _child(tmp_path)
    try:
        time.sleep(1.0)  # the container must exist before the CLI's procfs scan
        mntns = os.stat(f"/proc/{child.pid}/ns/mnt").st_ino
        proc, rows = _cli(["--localmanager-containername", COMM])
        neg, neg_rows = _cli(["--localmanager-containername", "no-such-ctr"])
    finally:
        child.kill()
        child.wait()
    assert proc.returncode == 0, proc.stderr[-2000:]
    mine = [r for r in rows if r["mountnsid"] == mntns]
    assert mine, rows[:5]
    assert all(r["container"] == COMM for r in mine), mine[:3]
    assert not [r for r in rows if r.get("container") not in ("", COMM, None)], rows[:5]
    assert neg.returncode == 0, neg.stderr[-2000:]
    assert not [r for r in neg_rows if r["mountnsid"] == mntns], neg_rows[:5]
