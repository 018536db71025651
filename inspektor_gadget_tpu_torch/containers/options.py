"""ContainerCollection initialization options.

Reference contract: pkg/container-collection/options.go — ~14 functional
options composing discovery + enrichment (WithPodInformer :199,
WithRuncFanotify :533, WithCgroupEnrichment :570,
WithLinuxNamespaceEnrichment :598, WithNodeName :669, ...). In this build
the discovery backends are: explicit/fake containers (tests, agent RPC),
and procfs scanning (every process group with a distinct mntns ≈ a
container-ish workload unit on hosts without a runtime socket).

The port's copy of ``inspektor_gadget_tpu/containers/options.py``. The
options over the native capture library (fanotify and netlink
discovery, the native containers map) degrade as the reference's do
when the library does not build or load here (`native_available` logs
why) or fanotify is unsupported; the library itself never falls back.
"""

from __future__ import annotations

import os
import re
from typing import Iterable

from .collection import ContainerCollection
from .container import Container


def with_node_name(name: str):
    """ref: options.go:669 WithNodeName."""

    def opt(cc: ContainerCollection):
        cc.node_name = name

    return opt


def with_fake_containers(containers: Iterable[Container]):
    """Seed a fixed container set — the TestOnly/fixture path
    (ref: internal/benchmarks fake containers; gadgettracermanager
    TestOnly constructors)."""

    def opt(cc: ContainerCollection):
        for c in containers:
            cc.add_container(c)

    return opt


def _read_ns(pid: int, ns: str) -> int:
    try:
        link = os.readlink(f"/proc/{pid}/ns/{ns}")
        m = re.search(r"\[(\d+)\]", link)
        return int(m.group(1)) if m else 0
    except OSError:
        return 0


def with_cgroup_enrichment():
    """Fill cgroup path/id from /proc (ref: options.go:570
    WithCgroupEnrichment)."""

    def enrich(c: Container) -> bool:
        if c.pid and not c.cgroup_path:
            try:
                with open(f"/proc/{c.pid}/cgroup") as f:
                    line = f.readline().strip()
                c.cgroup_path = line.split(":", 2)[-1]
            except OSError:
                pass
        return True

    def opt(cc: ContainerCollection):
        cc.add_enricher(enrich)

    return opt


def with_linux_namespace_enrichment():
    """Fill mntns/netns from /proc/<pid>/ns (ref: options.go:598)."""

    def enrich(c: Container) -> bool:
        if c.pid:
            if not c.mntns:
                c.mntns = _read_ns(c.pid, "mnt")
            if not c.netns:
                c.netns = _read_ns(c.pid, "net")
        return True

    def opt(cc: ContainerCollection):
        cc.add_enricher(enrich)

    return opt


def with_oci_config_enrichment(bundle_root: str = ""):
    """Fill mounts/env/annotations/seccomp from the container's OCI bundle
    config.json (ref: options.go:628 WithOCIConfigEnrichment — the
    reference parses the runtime-spec config the hook/fanotify path found).
    The bundle comes from c.bundle (set by runtime clients / runc
    fanotify); bundle_root lets tests point at a fake tree keyed by id."""

    def enrich(c: Container) -> bool:
        path = ""
        if c.bundle:
            path = os.path.join(c.bundle, "config.json")
        elif bundle_root:
            path = os.path.join(bundle_root, c.id, "config.json")
        if not path:
            return True
        try:
            import json
            with open(path) as f:
                cfg = json.load(f)
        except (OSError, ValueError):
            return True
        if not c.mounts:
            c.mounts = [m.get("destination", "") for m in
                        cfg.get("mounts", []) if m.get("destination")]
        if not c.env:
            c.env = list(cfg.get("process", {}).get("env", []))
        annotations = cfg.get("annotations", {})
        for k, v in annotations.items():
            c.labels.setdefault(k, v)
        # interpret the runtime's annotation dialect into k8s identity so
        # enrichment works without the k8s API (ref: options.go:628 calls
        # ociannotations.NewResolverFromAnnotations)
        from .oci_annotations import resolve_identity
        ident = resolve_identity(annotations)
        if ident is not None:
            if not c.pod:
                c.pod = ident.pod
            if not c.namespace:
                c.namespace = ident.namespace
            if ident.name and (not c.name or c.name == c.id):
                c.name = ident.name
        sec = cfg.get("linux", {}).get("seccomp")
        if sec and not c.seccomp_profile:
            c.seccomp_profile = sec.get("defaultAction", "")
        return True

    def opt(cc: ContainerCollection):
        cc.add_enricher(enrich)

    return opt


def with_host():
    """Add a pseudo-container for the host itself (ref: options.go:303
    WithHost) so host (non-container) events resolve to a stable identity:
    id 'host', pid 1, the init process's namespaces."""

    def opt(cc: ContainerCollection):
        host = Container(id="host", name="host", pid=1, runtime="host",
                         host_network=True)
        host.mntns = _read_ns(1, "mnt")  # 0 when /proc/1/ns is unreadable
        host.netns = _read_ns(1, "net")
        cc.add_container(host)

    return opt


def with_fanotify_discovery(paths: str = ""):
    """Live container detection via the native fanotify exec-watch on
    container-runtime binaries (ref: options.go:533 WithRuncFanotify →
    pkg/runcfanotify). Each watched-binary exec becomes a container-start
    candidate; EV_EXIT prunes. Degrades silently when fanotify or the
    native library is unavailable."""

    def opt(cc: ContainerCollection):
        from ..sources.bridge import (SRC_FANOTIFY_EXEC, NativeCapture, fanotify_supported,
                                      native_available)
        if not native_available() or not fanotify_supported():
            return
        import threading

        if paths:
            os.environ["IG_FANOTIFY_PATHS"] = paths
        src = NativeCapture(SRC_FANOTIFY_EXEC, ring_pow2=14, batch_size=256)
        src.start()

        def pump():
            import time as _t
            while True:
                b = src.pop()
                for i in range(b.count):
                    pid = int(b.cols["pid"][i])
                    kind = int(b.cols["kind"][i])
                    if kind == 1:  # EV_EXEC
                        cc.add_container(Container(
                            id=f"fan-{pid}", name=b.comm_str(i) or f"pid-{pid}",
                            pid=pid, mntns=int(b.cols["mntns"][i]),
                            runtime="fanotify",
                        ))
                    elif kind == 2:  # EV_EXIT
                        cc.remove_container(f"fan-{pid}")
                if b.count == 0:
                    _t.sleep(0.05)

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        cc._fanotify_source = src  # keep alive with the collection

    return opt


def with_netlink_discovery():
    """Live process-lifecycle tracking via the netlink proc-connector
    source: new mount namespaces appearing on exec become container
    candidates; exits prune (the hookless runtime-agnostic path)."""

    def opt(cc: ContainerCollection):
        from ..sources.bridge import NativeCapture, SRC_PROC_EXEC, native_available
        if not native_available():
            return
        import threading

        host_mntns = _read_ns(os.getpid(), "mnt")
        src = NativeCapture(SRC_PROC_EXEC, ring_pow2=14, batch_size=256)
        src.start()
        pid_to_id: dict[int, str] = {}

        def pump():
            import time as _t
            while True:
                b = src.pop()
                for i in range(b.count):
                    pid = int(b.cols["pid"][i])
                    kind = int(b.cols["kind"][i])
                    mntns = int(b.cols["mntns"][i])
                    if kind == 1 and mntns and mntns != host_mntns:
                        cid = f"nl-{pid}"
                        pid_to_id[pid] = cid
                        cc.add_container(Container(
                            id=cid, name=b.comm_str(i) or f"pid-{pid}",
                            pid=pid, mntns=mntns, runtime="netlink",
                        ))
                    elif kind == 2 and pid in pid_to_id:
                        cc.remove_container(pid_to_id.pop(pid))
                if b.count == 0:
                    _t.sleep(0.05)

        threading.Thread(target=pump, daemon=True).start()
        cc._netlink_source = src

    return opt


def with_native_containers_map():
    """Mirror the collection into the native containers map so the C++
    capture layer self-enriches (ref: pkg/gadgettracermanager/containers-map
    pinned BPF map role)."""

    def opt(cc: ContainerCollection):
        from ..sources.bridge import (
            containers_map_remove, containers_map_set, native_available,
        )
        if not native_available():
            return
        from .collection import EventType

        def on_event(ev):
            if ev.container.mntns:
                if ev.type == EventType.ADD:
                    containers_map_set(ev.container.mntns, ev.container.name)
                else:
                    containers_map_remove(ev.container.mntns)

        for c in cc.subscribe(("native-cmap",), on_event):
            if c.mntns:
                containers_map_set(c.mntns, c.name)

    return opt


def with_pod_informer(source, node_name: str = "", interval: float = 2.0):
    """Discover containers from this node's pods via a polling informer
    (ref: options.go:199 WithPodInformer → pkg/container-collection/
    podinformer.go). `source` is any PodSource: a callable, or build one
    with podinformer.file_pod_source / kube_api_pod_source. Does one
    synchronous refresh (the initial-containers snapshot, ref
    options.go:320) then polls in the background."""

    def opt(cc: ContainerCollection):
        from .podinformer import PodInformer

        inf = PodInformer(source, node_name=node_name or cc.node_name,
                          interval=interval)
        inf.on_add = cc.add_container
        inf.on_remove = cc.remove_container
        inf.refresh()
        inf.start()
        cc._pod_informer = inf  # keep alive with the collection

    return opt


def with_fallback_pod_informer(source, node_name: str = "",
                               interval: float = 2.0):
    """Pod informer that only activates when no other discovery backend
    produced containers (ref: options.go:207 WithFallbackPodInformer —
    used when the runtime socket is absent). Must be last in the option
    list, as in the reference."""

    inner = with_pod_informer(source, node_name, interval)

    def opt(cc: ContainerCollection):
        if len(cc) == 0:
            inner(cc)

    return opt


def with_procfs_discovery(max_pids: int = 4096):
    """Discover initial 'containers' by scanning /proc session leaders with
    distinct mount namespaces — the no-runtime-socket analogue of
    WithInitialKubernetesContainers (:320)."""

    def opt(cc: ContainerCollection):
        host_mntns = _read_ns(os.getpid(), "mnt")
        seen: set[int] = set()
        count = 0
        try:
            pids = sorted(
                (int(d) for d in os.listdir("/proc") if d.isdigit())
            )
        except OSError:
            return
        for pid in pids:
            if count >= max_pids:
                break
            mntns = _read_ns(pid, "mnt")
            if not mntns or mntns == host_mntns or mntns in seen:
                continue
            seen.add(mntns)
            try:
                with open(f"/proc/{pid}/comm") as f:
                    comm = f.read().strip()
            except OSError:
                comm = f"pid-{pid}"
            cc.add_container(
                Container(
                    id=f"proc-{pid}", name=comm, pid=pid, mntns=mntns,
                    netns=_read_ns(pid, "net"), runtime="procfs",
                )
            )
            count += 1

    return opt
