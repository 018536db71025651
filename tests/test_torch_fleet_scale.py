"""The port's fleet tier at scale: ~100 in-process agents (`fleet/sim.py`)
folded through the merge tree under churn, partition, clock skew and
aggregator crashes; every query byte-identical to the flat fold over the
same reachable roster, every reachable leaf counted exactly once a
query; the same cases as the reference's tests/test_fleet_scale.py. The
last case runs the same chaos on both packages' simulators and holds
the port's sealed bytes to the reference's every round.
"""

from __future__ import annotations

import time

import pytest

from inspektor_gadget_tpu_torch.fleet import fold_tree
from inspektor_gadget_tpu_torch.fleet.sim import GADGET, SimFleet
from inspektor_gadget_tpu_torch.history import encode_window, pack_frames

N = 100


def frame(win) -> bytes:
    return pack_frames([encode_window(win)])


@pytest.fixture
def fleet() -> SimFleet:
    # one window per agent keeps a 100-agent fold tier-1 fast; inv+qt on
    # so the identity claim covers the refusal-bearing planes at scale
    return SimFleet(N, n_windows=1, inv=True, qt=True)


def tree_query(fleet: SimFleet, spec: str = "auto:4", **kw):
    return fold_tree(fleet.topology(spec), fleet.fetch_leaf,
                     gadget=GADGET, **kw)


def test_100_agents_tree_identical_to_flat(fleet):
    tf = tree_query(fleet)
    assert tf.depth == 4
    assert frame(tf.window) == frame(fleet.flat_reference())
    assert tf.levels == {0: N}
    assert tf.errors == {} and tf.fallback == []
    # exactly-once: one leaf pull per agent for the whole tree
    assert sorted(fleet.fetches) == fleet.nodes()
    assert all(v == 1 for v in fleet.fetches.values())
    # every aggregator folded client-side exactly once
    assert tf.subtree_folds == len(fleet.topology("auto:4").aggregators())
    assert tf.aggregate["folded"] == N
    assert tf.aggregate["missing"] == []


def test_churn_rebuild_topology_and_refold(fleet):
    tf0 = tree_query(fleet)
    # churn: 7 agents leave, 5 fresh ones join — the tree is a function
    # of the roster, so the next query folds through a REBUILT topology
    for node in ["n003", "n017", "n042", "n055", "n068", "n081", "n099"]:
        fleet.kill(node)
    joined = [fleet.spawn() for _ in range(5)]
    assert len(fleet.nodes()) == N - 7 + 5
    tf1 = tree_query(fleet)
    assert frame(tf1.window) == frame(fleet.flat_reference())
    assert tf1.levels == {0: N - 7 + 5}
    assert tf1.window.digest != tf0.window.digest  # the roster changed
    assert all(j in tf1.paths for j in joined)
    # exactly-once PER QUERY: survivors were pulled twice (two queries),
    # joiners once, the churned-out never after leaving
    assert all(fleet.fetches[j] == 1 for j in joined)
    assert all(fleet.fetches[node] == 2 for node in fleet.nodes()
               if node not in joined)


def test_partition_10_nodes_then_heal(fleet):
    dark = [f"n{i:03d}" for i in range(0, N, 10)]
    fleet.partition(*dark)
    tf = tree_query(fleet)
    # the tree answers for the 90 reachable agents, byte-identical to
    # the flat fold over the same survivors
    assert frame(tf.window) == frame(fleet.flat_reference())
    assert tf.levels == {0: N - len(dark)}
    assert sorted(tf.errors) == dark
    assert all(tf.paths[n] == "unreachable" for n in dark)
    assert tf.aggregate["missing"] == dark
    fleet.heal()
    tf2 = tree_query(fleet)
    assert frame(tf2.window) == frame(fleet.flat_reference())
    assert tf2.levels == {0: N} and tf2.errors == {}


def test_skewed_clocks_still_fold_identically(fleet):
    for node, s in [("n010", 300.0), ("n020", -300.0), ("n030", 4e6)]:
        fleet.skew(node, s)
    tf = tree_query(fleet)
    assert frame(tf.window) == frame(fleet.flat_reference())
    # the skew is visible (span stretched by the worst offender), just
    # never a fold divergence
    assert tf.window.end_ts - tf.window.start_ts > 4e6


def test_aggregator_crash_refolds_flat_exactly_once(fleet):
    # the deployed tier: one fetch_subtree hop per zone, with a nested
    # aggregator crashed — its failure surfaces at the root hop, the
    # whole fold falls back flat, and no leaf is pulled twice
    fetch_subtree = fleet.make_fetch_subtree(fail={"agg2-001"})
    tf = tree_query(fleet, fetch_subtree=fetch_subtree)
    assert tf.fallback == ["fleet"]
    assert any("aggregator unreachable" in d for d in tf.dropped)
    assert frame(tf.window) == frame(fleet.flat_reference())
    # exactly-once is an ACCOUNTING guarantee: the crashed subtree's
    # partial remote pulls are wasted network work, but no leaf enters
    # the merged answer twice — levels stays one count per agent
    assert tf.levels == {0: N}
    assert tf.aggregate["folded"] == N
    assert all(p == "flat-fallback" for p in tf.paths.values())


def test_chaos_soak_identity_holds_every_round(fleet):
    # churn + partition + skew layered across rounds; after each fault
    # the tree answer must still match the flat fold over whatever
    # roster is currently reachable
    rounds = [
        lambda: fleet.partition("n001", "n002", "n003"),
        lambda: fleet.kill("n050"),
        lambda: fleet.skew("n060", 120.0),
        lambda: [fleet.spawn(), fleet.heal("n002")],
        lambda: fleet.partition("n099"),
    ]
    before = {}
    for i, chaos in enumerate(rounds):
        chaos()
        before = dict(fleet.fetches)
        tf = tree_query(fleet)
        flat = fleet.flat_reference()
        assert frame(tf.window) == frame(flat), f"round {i} diverged"
        reachable = [n for n in fleet.nodes()
                     if n not in fleet.partitioned]
        assert tf.levels == {0: len(reachable)}
        # exactly-once per round: each reachable leaf +1 fetch, no more
        assert all(fleet.fetches[n] - before.get(n, 0) == 1
                   for n in reachable), f"round {i} double-counted"


def test_scaling_series_shapes():
    # the bench's agents axis, in miniature: identity at every N the
    # perf ledger publishes (100 covered above)
    for n in (4, 16, 64):
        fleet = SimFleet(n, n_windows=1)
        tf = tree_query(fleet)
        assert frame(tf.window) == frame(fleet.flat_reference()), n
        assert tf.levels == {0: n}


def test_chaos_rounds_seal_the_references_bytes(monkeypatch):
    """100 agents of each package, the same churn, partition and skew
    applied to both: every round's tree answer has the reference tree's
    frame bytes (the npz entries' wall clock pinned)."""
    from inspektor_gadget_tpu.fleet import fold_tree as ref_fold_tree
    from inspektor_gadget_tpu.fleet.sim import SimFleet as RefSimFleet
    from inspektor_gadget_tpu.history import encode_window as ref_encode
    from inspektor_gadget_tpu.history import pack_frames as ref_pack
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.0)
    fleets = (SimFleet(N, n_windows=1, inv=True, qt=True),
              RefSimFleet(N, n_windows=1, inv=True, qt=True))
    rounds = [
        lambda f: f.partition("n001", "n002", "n003"),
        lambda f: [f.kill("n050"), f.kill("n017")],
        lambda f: f.skew("n060", 120.0),
        lambda f: [f.spawn(), f.heal("n002")],
    ]
    for i, chaos in enumerate(rounds):
        for f in fleets:
            chaos(f)
        port, ref = fleets
        tf = fold_tree(port.topology("auto:4"), port.fetch_leaf, gadget=GADGET)
        rtf = ref_fold_tree(ref.topology("auto:4"), ref.fetch_leaf, gadget=GADGET)
        assert frame(tf.window) == ref_pack([ref_encode(rtf.window)]), f"round {i}"
        assert frame(tf.window) == frame(port.flat_reference()), f"round {i}"
        assert tf.errors == rtf.errors and tf.levels == rtf.levels
