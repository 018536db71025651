"""The port's merge-tree topology (`fleet/topology.py`) against the
reference's: the declared zone grammar, the auto-balancer's O(log N)
shape, and the TopologyError validation that keeps every tree an
exactly-once fold over the roster; the same cases as the reference's
tests/test_fleet_topology.py, and every parsed tree's `to_dict` equal to
the reference's for the same spec."""

from __future__ import annotations

import pytest

from inspektor_gadget_tpu_torch.fleet import (
    Topology,
    TopologyError,
    TreeNode,
    auto_topology,
    parse_topology,
)

NODES = [f"n{i:03d}" for i in range(100)]


# ---------------------------------------------------------------------------
# auto-balancer
# ---------------------------------------------------------------------------

def test_auto_100_agents_fan4_is_log_depth():
    topo = auto_topology(NODES, fan_in=4)
    # level sizes 100 → 25 → 7 → 2 → 1
    assert topo.depth() == 4
    assert topo.fan_in() == 4
    assert topo.leaves() == sorted(NODES)
    # 25 + 6 + 2 + 1 aggregators (remainder chunks promote, not wrap)
    assert len(topo.aggregators()) == 34
    # every vertex but the root ships one summary frame up
    assert topo.edges() == 100 + 34 - 1
    assert topo.root.id == "fleet"


def test_auto_leaves_are_exactly_once_and_in_canonical_order():
    import random
    shuffled = NODES[:]
    random.Random(7).shuffle(shuffled)
    topo = auto_topology(shuffled, fan_in=4)
    # roster order can't leak: leaves come out sorted, each exactly once
    assert topo.leaves() == sorted(NODES)


@pytest.mark.parametrize("fan_in", [2, 3, 4, 8])
@pytest.mark.parametrize("n", [1, 2, 5, 9, 17, 64, 100])
def test_auto_every_aggregator_folds_at_least_two(n, fan_in):
    topo = auto_topology(NODES[:n], fan_in=fan_in)
    assert sorted(topo.leaves()) == sorted(NODES[:n])
    for agg in topo.aggregators():
        if n == 1:
            assert len(agg.children) == 1  # single-agent root folds one
        else:
            # a run of one is promoted, never wrapped — a single-child
            # aggregator would add a hop and fold nothing
            assert len(agg.children) >= 2
        assert len(agg.children) <= fan_in


def test_auto_promotes_remainder_chunk():
    # 5 agents, fan-in 4: [n000..n003] fold under one aggregator, n004
    # is promoted to sit beside it under the root
    topo = auto_topology(NODES[:5], fan_in=4)
    assert topo.depth() == 2
    kinds = [c.is_leaf for c in topo.root.children]
    assert kinds == [False, True]
    assert topo.root.children[1].id == "n004"


def test_auto_single_agent_still_aggregates():
    topo = auto_topology(["solo"])
    assert topo.root.id == "fleet"
    assert topo.leaves() == ["solo"]
    assert topo.depth() == 1


def test_auto_rejects_degenerate_inputs():
    with pytest.raises(TopologyError, match="fan-in must be >= 2"):
        auto_topology(NODES[:4], fan_in=1)
    with pytest.raises(TopologyError, match="no agents"):
        auto_topology([])


def test_auto_chunk_ids_sort_in_chunk_order():
    # 100 leaves at fan-in 2 puts 50 chunks on one level: zero-padded
    # ids keep display sorts aligned with chunk order (agg1-002 before
    # agg1-010)
    topo = auto_topology(NODES, fan_in=2)
    ids = [a.id for a in topo.aggregators() if a.id.startswith("agg1-")]
    assert ids == sorted(ids)
    assert len(ids) == 50


# ---------------------------------------------------------------------------
# spec parsing
# ---------------------------------------------------------------------------

def test_parse_auto_specs():
    assert parse_topology("auto", NODES[:8]).fan_in() == 4
    assert parse_topology("", NODES[:8]).fan_in() == 4  # default
    assert parse_topology("auto:8", NODES[:9]).fan_in() == 8
    with pytest.raises(TopologyError, match="auto:<int>"):
        parse_topology("auto:x", NODES[:8])


def test_declared_flat_zones():
    topo = parse_topology("zone-a=n000,n001;zone-b=n002,n003", NODES[:4])
    assert [c.id for c in topo.root.children] == ["zone-a", "zone-b"]
    assert topo.leaves() == ["n000", "n001", "n002", "n003"]
    assert topo.depth() == 2
    assert topo.fan_in() == 2


def test_declared_nested_zone_paths():
    topo = parse_topology(
        "dc1/rack-a=n000,n001;dc1/rack-b=n002;dc2=n003", NODES[:4])
    dc1 = topo.root.children[0]
    assert dc1.id == "dc1"
    assert [c.id for c in dc1.children] == ["rack-a", "rack-b"]
    assert topo.depth() == 3
    # fleet, dc1, rack-a, rack-b, dc2
    assert topo.to_dict()["aggregators"] == 5


@pytest.mark.parametrize("spec,match", [
    ("z1=n000,n000;z2=n001", "assigned twice"),
    ("z1=n000,n001;z2=n000", "assigned twice"),
    ("z1=n000,nope", "unknown agent"),
    ("z1=n000", "not placed in any zone"),
    ("a=n000;b/a=n001", "reused"),
    ("n000=n000,n001", "collide with agent names"),
    (";;", "empty topology spec"),
    ("zone-a", "bad clause"),
    ("zone-a=", "no members"),
    ("/=n000", "bad zone path"),
])
def test_declared_validation_refuses(spec, match):
    with pytest.raises(TopologyError, match=match):
        parse_topology(spec, NODES[:2])


def test_to_dict_shape():
    d = auto_topology(NODES[:8], fan_in=4).to_dict()
    assert d["leaves"] == 8
    assert d["depth"] == 2
    assert d["fan_in"] == 4
    assert d["edges"] == 10  # 8 leaf edges + 2 zone edges
    assert set(d) == {"root", "leaves", "aggregators", "depth",
                      "fan_in", "edges"}


def test_validate_catches_hand_built_double_count():
    n0 = TreeNode("n000")
    tree = Topology(TreeNode("fleet", (TreeNode("a", (n0,)),
                                      TreeNode("b", (n0,)))))
    from inspektor_gadget_tpu_torch.fleet.topology import _validate
    with pytest.raises(TopologyError, match="assigned twice"):
        _validate(tree, ["n000"])


@pytest.mark.parametrize("spec, n", [("auto", 100), ("auto:2", 9), ("auto:8", 65),
                                     ("auto:4", 1),
                                     ("dc1/rack-a=n000,n001;dc1/rack-b=n002;dc2=n003", 4),
                                     ("za=n002,n000;zb=n001", 3)])
def test_trees_equal_the_references(spec, n):
    from inspektor_gadget_tpu.fleet import parse_topology as ref_parse
    nodes = NODES[:n]
    assert parse_topology(spec, nodes).to_dict() == ref_parse(spec, nodes).to_dict()


@pytest.mark.parametrize("spec", [";", "za=", "za=n000;za=n000", "a/=n000", "auto:x",
                                  "za=n000,n999", "auto:1"])
def test_refusals_equal_the_references(spec):
    from inspektor_gadget_tpu.fleet import TopologyError as RefTopologyError
    from inspektor_gadget_tpu.fleet import parse_topology as ref_parse
    nodes = NODES[:3]
    with pytest.raises(RefTopologyError) as want:
        ref_parse(spec, nodes)
    with pytest.raises(TopologyError) as got:
        parse_topology(spec, nodes)
    assert str(got.value) == str(want.value)
