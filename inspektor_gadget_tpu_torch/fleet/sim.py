"""In-process fleet simulator: ~100 agents of sealed-window state with
fault injection, no subprocesses (the port's copy of
``inspektor_gadget_tpu/fleet/sim.py``).

The chaos tier (testing/chaos.py) tortures REAL agent processes —
right for transport/resume bugs, too heavy for 100 nodes in tier-1. The
scale proof needs the opposite trade: each agent is just its QueryWindows
pushdown reply (one merged sealed window + level/drop accounting), so a
hundred of them fit in one process and the faults under test are the
DISTRIBUTED ones — partition (fetch raises), churn (roster changes
between queries), clock skew (per-agent ts offsets), aggregator crash
(a subtree fold raises mid-query). `fetches` counts every leaf pull, so
exactly-once accounting is a direct assertion: one query folds each
reachable leaf exactly once, no matter how many subtree re-folds the
injected chaos causes.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..history.window import SealedWindow, window_digest
from .aggregator import AggregatorNode, canonical_order, flat_summary
from .topology import Topology, TreeNode, parse_topology

GADGET = "trace/exec"


def make_window(node: str, seed: int, *, gadget: str = GADGET,
                window: int = 1, width: int = 64, inv: bool = False,
                qt: bool = False, rs: bool = False, approx: bool = False,
                slices: bool = True, skew: float = 0.0) -> SealedWindow:
    """One synthetic sealed window, deterministic in (node, seed): every
    plane the merge algebra folds, each one optional so plane-on/off
    matrices and geometry-mismatch refusals are one kwarg away."""
    # crc32, not hash(): Python string hashing is salted per process,
    # and the sim's windows must be reproducible across runs
    rng = np.random.default_rng([seed, zlib.crc32(node.encode())])
    keys = rng.integers(1, 500, 256, dtype=np.uint32)
    sl = {}
    if slices:
        from ..history.window import SliceSketch
        s = SliceSketch()
        s.update(keys, keys, keys)
        sl[f"mntns:{seed % 2}"] = {"events": s.events, "hll": s.hll,
                                   "ent": s.ent, "hh": s.sealed_hh()}
    w = SealedWindow(
        gadget=gadget, node=node, run_id="r", window=window,
        start_ts=1000.0 + window + skew, end_ts=1001.0 + window + skew,
        events=len(keys), drops=seed % 3,
        cms=rng.integers(0, 9, (4, width)).astype(np.int32),
        hll=rng.integers(0, 5, 256).astype(np.int32),
        ent=rng.integers(0, 9, 64).astype(np.float32),
        topk_keys=rng.integers(1, 500, 8, dtype=np.uint32),
        topk_counts=np.sort(rng.integers(1, 99, 8))[::-1].astype(np.int64),
        slices=sl, names={int(keys[0]): f"comm-{node}"},
        approx=approx)
    if inv:
        w.inv_count = rng.integers(0, 50, (2, 32)).astype(np.int32)
        w.inv_keysum = rng.integers(0, 2**31, (2, 32)).astype(np.uint32)
        w.inv_fpsum = rng.integers(0, 2**31, (2, 32)).astype(np.uint32)
    if qt:
        w.qt_counts = rng.integers(0, 30, 128).astype(np.int64)
        w.qt_zeros = int(seed % 5)
        w.qt_total = int(w.qt_counts.sum()) + w.qt_zeros
    if rs:
        w.rs_capacity = 16
        w.rs_keys = rng.integers(1, 500, 16, dtype=np.uint64)
        w.rs_weights = np.ones(16, np.float64)
    w.digest = window_digest(w)
    return w


class SimAgent:
    """One simulated agent: its windows plus the pushdown reply shape
    (`query_windows`-compatible dict) `fold_tree`'s fetch_leaf expects."""

    def __init__(self, node: str, seed: int, *, n_windows: int = 2,
                 skew: float = 0.0, **plane_kw):
        self.node = node
        self.seed = seed
        self.skew = skew
        self.plane_kw = dict(plane_kw)
        self.windows = [
            make_window(node, seed + i, window=i + 1, skew=skew,
                        **plane_kw)
            for i in range(n_windows)
        ]

    def summary(self) -> dict:
        """The per-agent pushdown reply: ONE merged sealed window (the
        agent folds its own windows server-side) + level accounting —
        byte-identical to what client.query_windows decodes."""
        win = flat_summary(self.windows, gadget=self.windows[0].gadget,
                           node=self.node)
        return {"node": self.node, "window": win, "folded": True,
                "levels": {0: len(self.windows)}, "torn": 0,
                "dropped": [], "losses": []}


class SimFleet:
    """N simulated agents + the fault controls the scale proof drives.

    fetch_leaf is the seam: it raises ConnectionError for partitioned or
    churned-out agents and counts every successful pull in `fetches`
    (the exactly-once witness). `flat_reference()` is the byte-identity
    anchor — the flat fold over currently-reachable agents' windows.
    """

    def __init__(self, n: int, *, seed: int = 0, n_windows: int = 2,
                 **plane_kw):
        self.seed = seed
        self.n_windows = n_windows
        self.plane_kw = dict(plane_kw)
        self.agents: dict[str, SimAgent] = {}
        self.partitioned: set[str] = set()
        self.fetches: dict[str, int] = {}
        self.spawned = 0
        for _ in range(n):
            self.spawn()

    # -- roster / fault controls ------------------------------------------

    def spawn(self, *, skew: float = 0.0) -> str:
        """Churn-in: a fresh agent joins the roster (new node id — a
        respawned agent is a new fleet member as far as the tree is
        concerned; rebuild the topology after churn)."""
        node = f"n{self.spawned:03d}"
        self.spawned += 1
        self.agents[node] = SimAgent(node, self.seed + self.spawned,
                                     n_windows=self.n_windows, skew=skew,
                                     **self.plane_kw)
        return node

    def kill(self, node: str) -> None:
        """Churn-out: the agent leaves the roster entirely (vs
        partition(), where it stays a target but stops answering)."""
        self.agents.pop(node, None)
        self.partitioned.discard(node)

    def partition(self, *nodes: str) -> None:
        self.partitioned.update(nodes)

    def heal(self, *nodes: str) -> None:
        if nodes:
            self.partitioned.difference_update(nodes)
        else:
            self.partitioned.clear()

    def skew(self, node: str, seconds: float) -> None:
        """Re-seal `node`'s windows with a clock offset (the SkewClock
        fault, applied to sealed history: its timestamps disagree with
        the fleet's but its sketch planes still fold)."""
        a = self.agents[node]
        self.agents[node] = SimAgent(node, a.seed,
                                     n_windows=self.n_windows,
                                     skew=a.skew + seconds,
                                     **self.plane_kw)

    # -- the fold seams ----------------------------------------------------

    def nodes(self) -> list[str]:
        return sorted(self.agents)

    def fetch_leaf(self, node: str) -> dict:
        if node not in self.agents:
            raise ConnectionError(f"agent {node} gone (churned out)")
        if node in self.partitioned:
            raise ConnectionError(f"agent {node} unreachable (partition)")
        self.fetches[node] = self.fetches.get(node, 0) + 1
        return self.agents[node].summary()

    def make_fetch_subtree(self, *, fail: set[str] | None = None,
                           gadget: str = GADGET):
        """A server-side aggregator tier: each fetch_subtree call plays
        the deployed AggregatorNode for that subtree (fold children via
        this same fleet, one reply up). Ids in `fail` raise — the
        crashed/partitioned-aggregator fault."""
        fail = set(fail or ())

        def fetch_subtree(tree_node: TreeNode) -> dict:
            if tree_node.id in fail:
                raise ConnectionError(
                    f"aggregator {tree_node.id} unreachable")
            agg = AggregatorNode(
                tree_node.id,
                [c.id for c in tree_node.children], gadget=gadget)
            levels: dict[int, int] = {}
            dropped: list[str] = []
            for child in tree_node.children:
                if child.is_leaf:
                    try:
                        res = self.fetch_leaf(child.id)
                    except Exception:
                        continue  # the aggregator's own missing-child row
                else:
                    res = fetch_subtree(child)
                if res.get("window") is not None:
                    agg.observe(child.id, res["window"])
                for lvl, n in (res.get("levels") or {}).items():
                    levels[int(lvl)] = levels.get(int(lvl), 0) + int(n)
                dropped.extend(res.get("dropped") or ())
            win, acct = agg.publish()
            dropped.extend(f"{tree_node.id}: child {c} missing"
                           for c in acct["missing"])
            # no node prefix: fold_tree's accounting prefixes the
            # replying aggregator's id when it ingests this reply
            dropped.extend(acct["skipped"])
            return {"node": tree_node.id, "window": win, "folded": True,
                    "levels": levels, "torn": 0, "dropped": dropped,
                    "losses": [], "aggregate": acct}

        return fetch_subtree

    def reachable_windows(self) -> list[SealedWindow]:
        return canonical_order(
            w for node, a in self.agents.items()
            if node not in self.partitioned for w in a.windows)

    def flat_reference(self, *, gadget: str = GADGET) -> SealedWindow | None:
        """What the pre-tree client loop would seal: per-agent pushdown
        summaries folded flat in canonical node order."""
        summaries = []
        for node in self.nodes():
            if node in self.partitioned:
                continue
            win = self.agents[node].summary()["window"]
            if win is not None:
                summaries.append(win)
        return flat_summary(summaries, gadget=gadget)

    def topology(self, spec: str = "auto") -> Topology:
        return parse_topology(spec, self.nodes())


__all__ = ["GADGET", "SimAgent", "SimFleet", "make_window"]
