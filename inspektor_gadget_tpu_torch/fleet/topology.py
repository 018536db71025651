"""Merge-tree topology: which aggregator folds which agents (the port's
copy of ``inspektor_gadget_tpu/fleet/topology.py``).

A topology is a rooted tree whose leaves are agent node names and whose
interior nodes are aggregators. Two ways to get one:

- **Declared** (`parse_topology`): a compact grammar mapping zones to
  members, one assignment per `;`-separated clause::

      zone-a=n0,n1;zone-b=n2,n3            # root → {zone-a, zone-b}
      dc1/rack-a=n0,n1;dc1/rack-b=n2;dc2=n3  # nested via '/' paths

  Every `/`-separated path segment names an aggregator under the
  implicit root (``fleet``); the clause's members become that
  aggregator's leaf children. Validation is loud and typed
  (`TopologyError`): every known agent appears exactly once, no agent
  is invented, no clause is empty, no aggregator id collides with an
  agent name.

- **Auto-balanced** (`auto_topology`): leaves sorted by node id are
  grouped into contiguous runs of `fan_in`, then the groups are grouped
  again until one root remains — depth is O(log_fan_in N). Contiguity
  over the SORTED ids is deliberate: it keeps the tree's leaf order
  equal to the flat fold's canonical order, which is what makes the
  tree-merged summary byte-identical to the flat client-side fold
  (see aggregator.py).

The spec string accepted everywhere a topology param appears:
``auto`` (fan-in 4), ``auto:<fan_in>``, or the declared grammar above.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

DEFAULT_FAN_IN = 4
ROOT_ID = "fleet"


class TopologyError(ValueError):
    """A topology spec that cannot be trusted to fold the whole fleet
    exactly once — raised instead of silently dropping or double-
    counting agents."""


@dataclasses.dataclass(frozen=True)
class TreeNode:
    """One topology vertex: a leaf (agent, no children) or an
    aggregator (folds its children's summaries)."""

    id: str
    children: tuple["TreeNode", ...] = ()

    @property
    def is_leaf(self) -> bool:
        return not self.children


@dataclasses.dataclass(frozen=True)
class Topology:
    """A validated merge tree. `leaves()` is the exactly-once agent
    set; `depth()`/`fan_in()` are the shape facts the doctor row, the
    CLI, and the perf ledger report."""

    root: TreeNode

    def leaves(self) -> list[str]:
        out: list[str] = []

        def walk(n: TreeNode) -> None:
            if n.is_leaf:
                out.append(n.id)
                return
            for c in n.children:
                walk(c)

        walk(self.root)
        return out

    def aggregators(self) -> list[TreeNode]:
        out: list[TreeNode] = []

        def walk(n: TreeNode) -> None:
            if n.is_leaf:
                return
            out.append(n)
            for c in n.children:
                walk(c)

        walk(self.root)
        return out

    def depth(self) -> int:
        """Edges on the longest root→leaf path (a root folding leaves
        directly has depth 1)."""

        def walk(n: TreeNode) -> int:
            if n.is_leaf:
                return 0
            return 1 + max(walk(c) for c in n.children)

        return walk(self.root)

    def fan_in(self) -> int:
        """Largest child count any aggregator folds — the per-link load
        bound the tree exists to enforce."""
        return max((len(a.children) for a in self.aggregators()),
                   default=0)

    def edges(self) -> int:
        """Parent←child summary hops per merged query: every child
        (leaf or aggregator) ships ONE sealed window to its parent."""
        return sum(len(a.children) for a in self.aggregators())

    def to_dict(self) -> dict:
        def walk(n: TreeNode):
            if n.is_leaf:
                return n.id
            return {n.id: [walk(c) for c in n.children]}

        return {"root": walk(self.root), "leaves": len(self.leaves()),
                "aggregators": len(self.aggregators()),
                "depth": self.depth(), "fan_in": self.fan_in(),
                "edges": self.edges()}


def _validate(topo: Topology, nodes: Iterable[str]) -> Topology:
    known = list(nodes)
    leaves = topo.leaves()
    seen: set[str] = set()
    for leaf in leaves:
        if leaf in seen:
            raise TopologyError(
                f"agent {leaf!r} assigned twice — a tree that folds a "
                "node's summary into two subtrees double-counts it")
        seen.add(leaf)
    unknown = sorted(seen - set(known))
    if unknown:
        raise TopologyError(
            f"unknown agent(s) {', '.join(unknown)} — topology names "
            f"must come from the target set ({', '.join(sorted(known))})")
    missing = sorted(set(known) - seen)
    if missing:
        raise TopologyError(
            f"agent(s) {', '.join(missing)} not placed in any zone — a "
            "fleet query through this tree would silently omit them")
    agg_ids = [a.id for a in topo.aggregators()]
    dup_agg = sorted({a for a in agg_ids if agg_ids.count(a) > 1})
    if dup_agg:
        raise TopologyError(
            f"aggregator id(s) {', '.join(dup_agg)} reused — per-node "
            "path accounting needs unique ids")
    clash = sorted(set(agg_ids) & seen)
    if clash:
        raise TopologyError(
            f"aggregator id(s) {', '.join(clash)} collide with agent "
            "names — accounting rows would be ambiguous")
    return topo


def auto_topology(nodes: Iterable[str], fan_in: int = DEFAULT_FAN_IN
                  ) -> Topology:
    """Balance sorted leaves into a fan_in-ary tree: contiguous runs of
    `fan_in` children per aggregator, repeated until one root remains.
    A run of one is promoted, not wrapped — no single-child aggregator
    ever exists (it would add a hop and fold nothing)."""
    if fan_in < 2:
        raise TopologyError(f"fan-in must be >= 2, got {fan_in} — a "
                            "1-ary tree is a linked list of folds")
    names = sorted(nodes)
    if not names:
        raise TopologyError("no agents to build a topology over")
    level: list[TreeNode] = [TreeNode(t) for t in names]
    depth = 0
    while len(level) > 1:
        depth += 1
        nxt: list[TreeNode] = []
        for i in range(0, len(level), fan_in):
            chunk = level[i:i + fan_in]
            if len(chunk) == 1:
                nxt.append(chunk[0])
                continue
            last = len(level) <= fan_in
            # zero-padded chunk index so id order matches chunk order
            # wherever accounting rows get sorted for display
            nxt.append(TreeNode(
                ROOT_ID if last else f"agg{depth}-{i // fan_in:03d}",
                tuple(chunk)))
        level = nxt
    root = level[0]
    if root.is_leaf:
        # single-agent fleet: the root still aggregates (folds one)
        root = TreeNode(ROOT_ID, (root,))
    return _validate(Topology(root), names)


def _parse_declared(spec: str, nodes: Iterable[str]) -> Topology:
    # paths["dc1/rack-a"] = [members...]; tree assembled per segment
    clauses = [c.strip() for c in spec.split(";") if c.strip()]
    if not clauses:
        raise TopologyError("empty topology spec")
    assigned: list[tuple[tuple[str, ...], list[str]]] = []
    for clause in clauses:
        if "=" not in clause:
            raise TopologyError(
                f"bad clause {clause!r} — expected zone[/zone...]=n1,n2")
        path_s, members_s = clause.split("=", 1)
        path = tuple(p.strip() for p in path_s.split("/"))
        if not all(path):
            raise TopologyError(f"bad zone path {path_s!r} in {clause!r}")
        members = [m.strip() for m in members_s.split(",") if m.strip()]
        if not members:
            raise TopologyError(
                f"zone {path_s!r} has no members — an empty zone folds "
                "nothing and hides a misspelled assignment")
        assigned.append((path, members))

    # nested dict of aggregators: {zone: ({subzone: ...}, [leaf, ...])}
    def new_level() -> tuple[dict, list]:
        return ({}, [])

    tree = new_level()
    for path, members in assigned:
        cur = tree
        for seg in path:
            cur = cur[0].setdefault(seg, new_level())
        cur[1].extend(members)

    def build(name: str, level: tuple[dict, list]) -> TreeNode:
        subs, members = level
        children = [build(seg, lv) for seg, lv in subs.items()]
        children.extend(TreeNode(m) for m in members)
        return TreeNode(name, tuple(children))

    return _validate(Topology(build(ROOT_ID, tree)), nodes)


def parse_topology(spec: str, nodes: Iterable[str]) -> Topology:
    """Spec string → validated Topology. ``auto``/``auto:<fan_in>``
    balances over the target set; anything else is the declared zone
    grammar. All failures are TopologyError with the reason."""
    spec = (spec or "auto").strip()
    if spec == "auto" or spec.startswith("auto:"):
        fan_in = DEFAULT_FAN_IN
        if spec.startswith("auto:"):
            try:
                fan_in = int(spec.split(":", 1)[1])
            except ValueError:
                raise TopologyError(
                    f"bad auto fan-in in {spec!r} — expected auto:<int>")
        return auto_topology(nodes, fan_in=fan_in)
    return _parse_declared(spec, nodes)


__all__ = ["DEFAULT_FAN_IN", "ROOT_ID", "Topology", "TopologyError",
           "TreeNode", "auto_topology", "parse_topology"]
