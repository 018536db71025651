"""KubeIPResolver operator: IP → workload-name enrichment.

Reference contract: pkg/operators/kubeipresolver — a polled cluster
inventory cache (k8sInventoryCache, kubeipresolver.go:62-156) maps event
IPs to pod/service names for gadgets exposing KubeNetworkInformation
(:46-59). Inventory backends, most to least capable: `kube_inventory`
polls pods **and services** through a KubeClient into the operator's TTL
cache (the reference's path); a static inventory map (tests/agents);
/etc/hosts as the no-cluster fallback.

The port's copy of ``inspektor_gadget_tpu/operators/kubeipresolver.py`` with one addition: the
operator takes its cache's clock (`clock`, `time.monotonic` by default),
so a test can age the cache without sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from ..gadgets.context import GadgetContext
from ..gadgets.interface import GadgetDesc
from ..params import ParamDesc, ParamDescs, Params
from .operators import Operator, OperatorInstance, register

REFRESH_INTERVAL = 30.0  # inventory poll cadence


def hosts_inventory(path: str = "/etc/hosts") -> dict[str, tuple[str, str]]:
    """ip → (kind, name) from a hosts file."""
    out: dict[str, tuple[str, str]] = {}
    try:
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                parts = line.split()
                if len(parts) >= 2:
                    out[parts[0]] = ("host", parts[1])
    except OSError:
        pass
    return out


def kube_inventory(client: Any) -> Callable[[], dict[str, tuple[str, str]]]:
    """ip → (kind, namespace/name) polled off the apiserver — pods AND
    services, the reference's inventory (kubeipresolver.go:62-156 polls
    both into the cache). Pods win conflicts (more specific than a
    service VIP); headless services ('None') are skipped."""

    def poll() -> dict[str, tuple[str, str]]:
        out: dict[str, tuple[str, str]] = {}
        for svc in client.list_services():
            meta = svc.get("metadata", {})
            name = f"{meta.get('namespace', '')}/{meta.get('name', '')}"
            spec = svc.get("spec", {})
            ips = [ip for ip in (spec.get("clusterIPs") or []) if ip]
            head = spec.get("clusterIP", "")
            if head and head not in ips:
                ips.append(head)
            for ip in ips:
                if ip != "None":
                    out[ip] = ("svc", name)
        for pod in client.list_pods():
            meta = pod.get("metadata", {})
            name = f"{meta.get('namespace', '')}/{meta.get('name', '')}"
            status = pod.get("status", {})
            ips = [p.get("ip") for p in status.get("podIPs", []) if p.get("ip")]
            head = status.get("podIP", "")
            if head and head not in ips:
                ips.append(head)
            for ip in ips:
                out[ip] = ("pod", name)
        return out

    return poll


class KubeIPResolver(Operator):
    name = "kubeipresolver"

    def __init__(self, inventory_fn: Callable[[], dict] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self._inventory_fn = inventory_fn or hosts_inventory
        self._clock = clock
        self._cache: dict[str, tuple[str, str]] = {}
        self._last = 0.0
        self._mu = threading.Lock()
        self.refresh_interval = REFRESH_INTERVAL

    def use_kube_client(self, client: Any,
                        refresh_interval: float | None = None) -> None:
        """Switch the inventory to the cluster poll (agent wiring when
        --kube-api is configured)."""
        with self._mu:
            self._inventory_fn = kube_inventory(client)
            self._cache = {}
            self._last = 0.0
            if refresh_interval is not None:
                self.refresh_interval = refresh_interval

    def instance_params(self) -> ParamDescs:
        return ParamDescs([
            ParamDesc(key="resolve-ips", default="true"),
        ])

    def can_operate_on(self, desc: GadgetDesc) -> bool:
        # applies to gadgets whose events expose address fields
        if desc.event_cls is None:
            return False
        fields = {f.name for f in __import__("dataclasses").fields(desc.event_cls)}
        return bool(fields & {"saddr", "daddr", "remote", "remoteaddr", "localaddr"})

    def lookup(self, ip: str) -> tuple[str, str] | None:
        # the poll can be two cluster-wide HTTP lists (seconds on a big
        # cluster): never hold _mu across it — one caller claims the
        # refresh, every other enrich() keeps reading the stale cache
        now = self._clock()
        with self._mu:
            claimed = now - self._last > self.refresh_interval
            if claimed:
                self._last = now
            fn = self._inventory_fn
        if claimed:
            try:
                fresh = fn()
            except Exception:  # noqa: BLE001 — apiserver blip: keep stale
                fresh = None
            if fresh is not None:
                with self._mu:
                    self._cache = fresh
        with self._mu:
            return self._cache.get(ip)

    def set_inventory(self, inventory: dict[str, tuple[str, str]]) -> None:
        with self._mu:
            self._cache = dict(inventory)
            self._last = self._clock()

    def instantiate(self, ctx: GadgetContext, gadget: Any,
                    instance_params: Params) -> "KubeIPResolverInstance":
        return KubeIPResolverInstance(self, ctx)


class KubeIPResolverInstance(OperatorInstance):
    def __init__(self, op: KubeIPResolver, ctx: GadgetContext):
        super().__init__(op.name)
        self.op = op

    def enrich(self, event: Any) -> None:
        for field in ("saddr", "daddr", "remote", "remoteaddr", "localaddr"):
            ip = getattr(event, field, None)
            if not ip:
                continue
            hit = self.op.lookup(str(ip).split(":", 1)[0])
            if hit is not None:
                setattr(event, field, f"{ip} ({hit[0]}/{hit[1]})")


register(KubeIPResolver())
