"""The port's aggregation tier (`fleet/aggregator.py`, `fleet/sim.py`):
the tree-merged fleet summary is byte-identical to the flat client-side
fold (the same frame bytes, not just the same digest) for every plane
combination, at any fan-in, through the client-driven tier and the
server-side aggregator tier, under partition, refusal, approx taint and
crash-mid-fold refolds (which never double-count a leaf); the same cases
as the reference's tests/test_fleet_merge.py. The last case holds the
port's sealed bytes to the reference's tier over the same simulated
windows.
"""

from __future__ import annotations

import random
import time

import pytest

from inspektor_gadget_tpu_torch.fleet import (
    canonical_order,
    flat_summary,
    fold_tree,
)
from inspektor_gadget_tpu_torch.fleet.sim import GADGET, SimAgent, SimFleet
from inspektor_gadget_tpu_torch.history import encode_window, pack_frames


def frame(win) -> bytes:
    return pack_frames([encode_window(win)])


PLANES = [
    pytest.param({}, id="base"),
    pytest.param({"inv": True}, id="inv"),
    pytest.param({"qt": True}, id="qt"),
    pytest.param({"rs": True}, id="rs"),
    pytest.param({"inv": True, "qt": True, "rs": True}, id="all"),
    pytest.param({"inv": True, "qt": True, "rs": True, "approx": True},
                 id="all+approx"),
]


# ---------------------------------------------------------------------------
# the identity matrix: fan-in × planes × tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fan_in", [2, 4, 8])
@pytest.mark.parametrize("planes", PLANES)
def test_tree_fold_byte_identical_to_flat(fan_in, planes):
    # 9 agents: every fan-in here produces a remainder chunk somewhere,
    # so promotion (the shape that once permuted the label-map order)
    # is always part of the matrix
    fleet = SimFleet(9, n_windows=2, **planes)
    topo = fleet.topology(f"auto:{fan_in}")
    flat = fleet.flat_reference()

    tf = fold_tree(topo, fleet.fetch_leaf, gadget=GADGET)
    assert frame(tf.window) == frame(flat)
    assert tf.window.digest == flat.digest
    assert tf.levels == {0: 18}
    assert tf.errors == {} and tf.fallback == []
    assert all(p == "tree" for p in tf.paths.values())

    # the server-side aggregator tier (one fetch_subtree hop per zone)
    # seals the same bytes
    tf2 = fold_tree(topo, fleet.fetch_leaf,
                    fetch_subtree=fleet.make_fetch_subtree(),
                    gadget=GADGET)
    assert frame(tf2.window) == frame(flat)
    assert tf2.subtree_folds >= 1


def test_declared_zone_shuffled_child_order_same_digest():
    """Zone members listed in any order still seal the same digest —
    the merge algebra is commutative on every digest-covered plane."""
    fleet = SimFleet(8, n_windows=1, inv=True, qt=True, rs=True)
    flat = fleet.flat_reference()
    rng = random.Random(3)
    for _ in range(4):
        members = [fleet.nodes()[:4], fleet.nodes()[4:]]
        for m in members:
            rng.shuffle(m)
        spec = (f"za={','.join(members[0])};"
                f"zb={','.join(members[1])}")
        tf = fold_tree(fleet.topology(spec), fleet.fetch_leaf,
                       gadget=GADGET)
        assert tf.window.digest == flat.digest


def test_declared_contiguous_zones_full_byte_identity():
    # contiguous zones in roster order preserve canonical leaf order,
    # so even the digest-exempt label map matches byte-for-byte
    fleet = SimFleet(8, n_windows=1, inv=True)
    spec = ("za=n000,n001,n002;zb=n003,n004,n005;zc=n006,n007")
    tf = fold_tree(fleet.topology(spec), fleet.fetch_leaf, gadget=GADGET)
    assert frame(tf.window) == frame(fleet.flat_reference())


# ---------------------------------------------------------------------------
# determinism pin: the flat fold itself
# ---------------------------------------------------------------------------

def test_flat_fold_identical_bytes_regardless_of_reply_order():
    fleet = SimFleet(12, n_windows=2, inv=True, qt=True)
    summaries = [fleet.agents[n].summary()["window"]
                 for n in fleet.nodes()]
    anchor = frame(flat_summary(summaries, gadget=GADGET))
    rng = random.Random(11)
    for _ in range(5):
        shuffled = summaries[:]
        rng.shuffle(shuffled)
        assert frame(flat_summary(shuffled, gadget=GADGET)) == anchor


def test_canonical_order_is_pure_function_of_window_set():
    fleet = SimFleet(6, n_windows=2)
    ws = fleet.reachable_windows()
    shuffled = ws[:]
    random.Random(5).shuffle(shuffled)
    assert [w.digest for w in canonical_order(shuffled)] == \
        [w.digest for w in ws]


# ---------------------------------------------------------------------------
# partition / churn accounting
# ---------------------------------------------------------------------------

def test_partitioned_leaves_become_error_rows_not_poison():
    fleet = SimFleet(16, n_windows=1, inv=True)
    fleet.partition("n003", "n007", "n012")
    topo = fleet.topology("auto:4")
    tf = fold_tree(topo, fleet.fetch_leaf, gadget=GADGET)
    # identical to the flat fold over the REACHABLE set
    assert frame(tf.window) == frame(fleet.flat_reference())
    assert sorted(tf.errors) == ["n003", "n007", "n012"]
    assert all("unreachable" in e or "partition" in e
               for e in tf.errors.values())
    assert all(tf.paths[n] == "unreachable"
               for n in ("n003", "n007", "n012"))
    assert tf.levels == {0: 13}
    # heal and refold: the healed fleet answers whole again
    fleet.heal()
    tf2 = fold_tree(topo, fleet.fetch_leaf, gadget=GADGET)
    assert tf2.errors == {}
    assert frame(tf2.window) == frame(fleet.flat_reference())


def test_whole_fleet_partitioned_yields_no_window():
    fleet = SimFleet(4, n_windows=1)
    fleet.partition(*fleet.nodes())
    tf = fold_tree(fleet.topology("auto"), fleet.fetch_leaf,
                   gadget=GADGET)
    assert tf.window is None
    assert len(tf.errors) == 4
    assert tf.aggregate["digest"] == ""
    assert tf.aggregate["missing"] == sorted(fleet.nodes())


# ---------------------------------------------------------------------------
# refusal propagation through the tiers
# ---------------------------------------------------------------------------

def test_geometry_mismatch_skipped_with_note_both_paths():
    fleet = SimFleet(8, n_windows=1, inv=True)
    odd = fleet.nodes()[5]
    a = fleet.agents[odd]
    fleet.agents[odd] = SimAgent(odd, a.seed, n_windows=1, inv=True,
                                 width=32)  # disagreeing CMS geometry
    topo = fleet.topology("auto:4")
    tf = fold_tree(topo, fleet.fetch_leaf, gadget=GADGET)
    flat = fleet.flat_reference()
    assert frame(tf.window) == frame(flat)
    # the refusal surfaced, naming the odd window, in the tree's
    # accounting — answer_query renders tf.dropped as dropped_windows
    assert any(odd in note for note in tf.dropped)
    # and through the server-side tier
    tf2 = fold_tree(topo, fleet.fetch_leaf,
                    fetch_subtree=fleet.make_fetch_subtree(),
                    gadget=GADGET)
    assert tf2.window.digest == flat.digest
    assert any(odd in note for note in tf2.dropped)


def test_partial_plane_coverage_drops_plane_with_note():
    # half the fleet seals the invertible plane, half doesn't: total-
    # coverage refusal drops it everywhere, with the note propagated
    fleet = SimFleet(8, n_windows=1, inv=True, qt=True)
    for n in fleet.nodes()[4:]:
        a = fleet.agents[n]
        fleet.agents[n] = SimAgent(n, a.seed, n_windows=1, qt=True)
    topo = fleet.topology("auto:4")
    tf = fold_tree(topo, fleet.fetch_leaf, gadget=GADGET)
    flat = fleet.flat_reference()
    assert tf.window.digest == flat.digest
    assert tf.window.inv_count is None and flat.inv_count is None
    assert tf.window.qt_counts is not None  # covered plane survives
    assert any("invertible" in note for note in tf.dropped)
    assert any("invertible" in note for note in tf.aggregate["skipped"])


def test_approx_taint_from_one_agent_ors_through_the_tree():
    fleet = SimFleet(8, n_windows=1)
    tainted = fleet.nodes()[6]
    a = fleet.agents[tainted]
    fleet.agents[tainted] = SimAgent(tainted, a.seed, n_windows=1,
                                     approx=True)
    tf = fold_tree(fleet.topology("auto:4"), fleet.fetch_leaf,
                   gadget=GADGET)
    flat = fleet.flat_reference()
    assert tf.window.approx and flat.approx
    assert frame(tf.window) == frame(flat)
    assert tf.aggregate["approx"] is True


# ---------------------------------------------------------------------------
# crash mid-fold: refold answers the same bytes, no double-count
# ---------------------------------------------------------------------------

def test_client_fold_crash_refolds_flat_without_double_count(monkeypatch):
    from inspektor_gadget_tpu_torch.fleet import aggregator as agg_mod
    fleet = SimFleet(16, n_windows=1, inv=True)
    topo = fleet.topology("auto:4")
    flat = fleet.flat_reference()

    real = agg_mod.merged_to_sealed
    crashed = []

    def crash_once(merged, *, gadget, node):
        if node == "agg1-001" and not crashed:
            crashed.append(node)
            raise RuntimeError("injected seal crash")
        return real(merged, gadget=gadget, node=node)

    monkeypatch.setattr(agg_mod, "merged_to_sealed", crash_once)
    tf = fold_tree(topo, fleet.fetch_leaf, gadget=GADGET)
    assert crashed == ["agg1-001"]
    assert tf.fallback == ["agg1-001"]
    assert any("crashed" in note for note in tf.dropped)
    # the answer is unchanged — the subtree re-folded flat from the
    # leaves' CACHED summaries
    assert frame(tf.window) == frame(flat)
    # exactly-once: one fetch per leaf for the whole query, crash
    # refold included
    assert sorted(fleet.fetches) == fleet.nodes()
    assert all(v == 1 for v in fleet.fetches.values())
    assert tf.levels == {0: 16}
    # the crashed zone's leaves answered via the fallback path
    assert [n for n, p in sorted(tf.paths.items())
            if p == "flat-fallback"] == ["n004", "n005", "n006", "n007"]


def test_remote_aggregator_unreachable_falls_back_exactly_once():
    fleet = SimFleet(16, n_windows=2, inv=True, qt=True)
    topo = fleet.topology("auto:4")
    flat = fleet.flat_reference()
    # the sim's server-side tier is recursive, so a failed mid-tree
    # aggregator surfaces at the root hop: the whole tree re-folds flat
    tf = fold_tree(
        topo, fleet.fetch_leaf,
        fetch_subtree=fleet.make_fetch_subtree(fail={"agg1-001"}),
        gadget=GADGET)
    assert tf.fallback  # some subtree answered flat
    assert frame(tf.window) == frame(flat)
    # exactly-once accounting across remote replies + client refolds:
    # every (leaf, window) counted once — 16 agents × 2 windows
    assert tf.levels == {0: 32}


def test_root_aggregator_down_means_whole_tree_flat_fallback():
    fleet = SimFleet(8, n_windows=1)
    topo = fleet.topology("auto:4")
    tf = fold_tree(topo, fleet.fetch_leaf,
                   fetch_subtree=fleet.make_fetch_subtree(fail={"fleet"}),
                   gadget=GADGET)
    assert tf.fallback == ["fleet"]
    assert tf.subtree_folds == 0
    assert all(p == "flat-fallback" for p in tf.paths.values())
    assert frame(tf.window) == frame(fleet.flat_reference())


# ---------------------------------------------------------------------------
# the root aggregate header matches the wire contract
# ---------------------------------------------------------------------------

def test_root_aggregate_carries_wire_schema_fields():
    from inspektor_gadget_tpu_torch.agent import wire
    fleet = SimFleet(6, n_windows=1)
    fleet.partition("n002")
    tf = fold_tree(fleet.topology("auto:4"), fleet.fetch_leaf,
                   gadget=GADGET)
    assert set(tf.aggregate) == set(wire.FLEET_AGGREGATE_FIELDS)
    assert tf.aggregate["schema"] == wire.FLEET_AGGREGATE_SCHEMA
    assert tf.aggregate["aggregator"] == "fleet"
    assert tf.aggregate["missing"] == ["n002"]
    assert tf.aggregate["digest"] == tf.window.digest
    assert tf.aggregate["folded"] == 5


@pytest.mark.parametrize("fan_in", [2, 4])
@pytest.mark.parametrize("planes", PLANES)
def test_tree_fold_bytes_equal_the_references(fan_in, planes, monkeypatch):
    """The same simulated fleet folded by both packages' tiers seals the
    same frame bytes (the npz entries' wall clock pinned)."""
    from inspektor_gadget_tpu.fleet import fold_tree as ref_fold_tree
    from inspektor_gadget_tpu.fleet.sim import SimFleet as RefSimFleet
    from inspektor_gadget_tpu.history import encode_window as ref_encode
    from inspektor_gadget_tpu.history import pack_frames as ref_pack
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.0)
    fleet, ref = SimFleet(9, n_windows=2, **planes), RefSimFleet(9, n_windows=2, **planes)
    tf = fold_tree(fleet.topology(f"auto:{fan_in}"), fleet.fetch_leaf, gadget=GADGET)
    rtf = ref_fold_tree(ref.topology(f"auto:{fan_in}"), ref.fetch_leaf, gadget=GADGET)
    assert frame(tf.window) == ref_pack([ref_encode(rtf.window)])
    assert tf.aggregate == rtf.aggregate
    assert (tf.levels, tf.paths, tf.dropped) == (rtf.levels, rtf.paths, rtf.dropped)
