"""Process-wide active-alert table + cluster-wide fold-in.

ActiveAlerts is the role the tpusketch `_live` map plays for sketches:
one process-global registry every surface reads — `ig-tpu alerts list`,
the `top alerts` gadget, and the agent's DumpState (so a remote `alerts
list` sees each node's table). Entries are keyed (scope, rule, key):
node-scope entries come from this process's engines, cluster-scope
entries from the client-side aggregator.

ClusterAlertAggregator is GrpcRuntime's fan-in dedup: the same rule+key
firing on N nodes folds into ONE cluster alert carrying the node list —
the first node's transition surfaces it, later nodes only extend the
list, and the cluster alert resolves when the last node resolves.

The port's copy of ``inspektor_gadget_tpu/alerts/store.py``; the port's
`GrpcRuntime` folds its fan-out's alerts through the aggregator.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable

MAX_RESOLVED = 256  # resolved entries retained for `alerts list`


class ActiveAlerts:
    def __init__(self):
        self._mu = threading.Lock()
        self._alerts: OrderedDict[tuple, dict] = OrderedDict()

    def update(self, event, scope: str = "node") -> None:
        """Fold one AlertEvent (or its wire dict) into the table."""
        d = event if isinstance(event, dict) else event.to_dict()
        key = (scope, d["rule"], d.get("key", ""))
        with self._mu:
            cur = self._alerts.get(key)
            if cur is not None and cur.get("state") == "resolved" \
                    and d.get("transition") in ("pending", "firing"):
                # a NEW episode: node attribution and age from prior,
                # resolved episodes must not bleed into this one
                cur = None
            if cur is None:
                cur = {"scope": scope, "rule": d["rule"],
                       "key": d.get("key", ""),
                       "severity": d.get("severity", ""),
                       "kind": d.get("kind", ""),
                       "since": d.get("ts") or time.time(),
                       "nodes": []}
                self._alerts[key] = cur
            cur["state"] = d["transition"]
            cur["value"] = d.get("value", 0.0)
            cur["threshold"] = d.get("threshold", 0.0)
            cur["ts"] = d.get("ts") or time.time()
            if d.get("transition") == "pending":
                cur["since"] = cur["ts"]
            for n in (d.get("nodes") or ([d["node"]] if d.get("node") else [])):
                if n not in cur["nodes"]:
                    cur["nodes"].append(n)
            self._trim()

    def _trim(self) -> None:
        resolved = [k for k, v in self._alerts.items()
                    if v.get("state") == "resolved"]
        while len(resolved) > MAX_RESOLVED:
            self._alerts.pop(resolved.pop(0), None)

    def active(self) -> list[dict]:
        with self._mu:
            return [dict(v) for v in self._alerts.values()
                    if v.get("state") in ("pending", "firing")]

    def all(self) -> list[dict]:
        with self._mu:
            return [dict(v) for v in self._alerts.values()]

    def clear(self) -> None:
        with self._mu:
            self._alerts.clear()


ACTIVE = ActiveAlerts()


class ClusterAlertAggregator:
    """Client-side fold-in of per-node alert streams (GrpcRuntime).

    observe() returns the cluster-level AlertEvent dict to surface, or
    None when the transition deduplicates away (another node already
    surfaced this alert and it is still active)."""

    def __init__(self, on_alert: Callable[[dict], None] | None = None,
                 store: ActiveAlerts | None = None):
        self.on_alert = on_alert
        self.store = store if store is not None else ACTIVE
        self._mu = threading.Lock()
        self._active: dict[tuple, dict] = {}  # (rule,key) → {nodes,...}

    def observe(self, node: str, alert: dict) -> dict | None:
        transition = alert.get("transition", "")
        key = (alert.get("rule", ""), alert.get("key", ""))
        surfaced: dict | None = None
        with self._mu:
            entry = self._active.get(key)
            if transition in ("pending", "firing"):
                if entry is None:
                    entry = {"nodes": [], "fired": False}
                    self._active[key] = entry
                if node not in entry["nodes"]:
                    entry["nodes"].append(node)
                # surface the FIRST pending and the FIRST firing; later
                # nodes fold into the node list silently (the dedup)
                if transition == "firing" and not entry["fired"]:
                    entry["fired"] = True
                    surfaced = self._cluster_event(alert, entry)
                elif transition == "pending" and len(entry["nodes"]) == 1:
                    surfaced = self._cluster_event(alert, entry)
                else:
                    self._update_nodes(alert, entry)
            elif transition == "resolved" and entry is not None:
                if node in entry["nodes"]:
                    entry["nodes"].remove(node)
                if not entry["nodes"]:
                    # last node out resolves the cluster alert
                    all_nodes = entry.get("all_nodes", [node])
                    surfaced = dict(alert)
                    surfaced["nodes"] = all_nodes
                    del self._active[key]
        if surfaced is not None:
            self.store.update(surfaced, scope="cluster")
            if self.on_alert is not None:
                self.on_alert(surfaced)
        return surfaced

    def _cluster_event(self, alert: dict, entry: dict) -> dict:
        ev = dict(alert)
        ev["nodes"] = list(entry["nodes"])
        entry["all_nodes"] = list(entry["nodes"])
        return ev

    def _update_nodes(self, alert: dict, entry: dict) -> None:
        """A deduplicated transition still extends the surfaced alert's
        node list in the store (no new event)."""
        entry.setdefault("all_nodes", [])
        for n in entry["nodes"]:
            if n not in entry["all_nodes"]:
                entry["all_nodes"].append(n)
        folded = dict(alert)
        folded["transition"] = "firing" if entry["fired"] else "pending"
        folded["nodes"] = list(entry["all_nodes"])
        self.store.update(folded, scope="cluster")

    def node_done(self, node: str) -> list[dict]:
        """A node's stream ended: whatever that node still holds active
        resolves here. Transitions ride the lossy event stream — a
        dropped 'resolved' (or a crashed node) must not wedge a cluster
        alert active forever; stream end is the reconciliation point.
        Returns the surfaced cluster resolves (entries whose LAST node
        left)."""
        surfaced: list[dict] = []
        with self._mu:
            for (rule, key), entry in list(self._active.items()):
                if node in entry["nodes"]:
                    entry["nodes"].remove(node)
                    if not entry["nodes"]:
                        surfaced.append(
                            {"rule": rule, "key": key,
                             "transition": "resolved", "node": node,
                             "ts": time.time(),
                             "nodes": entry.get("all_nodes", [node])})
                        del self._active[(rule, key)]
        for ev in surfaced:
            self.store.update(ev, scope="cluster")
            if self.on_alert is not None:
                self.on_alert(ev)
        return surfaced

    def active(self) -> list[dict]:
        with self._mu:
            return [{"rule": r, "key": k, "nodes": list(v["nodes"])}
                    for (r, k), v in self._active.items()]
