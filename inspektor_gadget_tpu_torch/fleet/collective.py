"""The collective merge: the aggregation tier for hosts that hold the
sketch state themselves (PyTorch port of
``inspektor_gadget_tpu/fleet/collective.py``).

When the fleet is a set of GPU hosts in one job, the merge tree needs no
gRPC hop: the sharded harvest leaves one `SketchBundle` a lane, and
`parallel.cluster.cluster_merge` over a `torch.distributed` group is one
reduction a plane (NCCL between cards, gloo on the CPU). Lanes are in
rank-major order (`parallel.distributed.make_multihost_mesh`), so the
fleet-merged bundle comes out the same on every rank and the invertible
decode runs on the merged state.

Bit-identity: every plane folds in integer arithmetic (count-min,
entropy, DDSketch and invertible counts add, the uint32 key and
fingerprint sums wrap mod 2**32 under any association, HLL registers
max, top-k candidates gather in lane order), so a two-process merge
equals the same rows' `cluster_merge` in one process and the host-side
fold of the equivalent sealed windows (``tests/test_torch_fleet_collective.py``).
The float32 counters are exact while their sums stay below 2**24.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import torch

from ..ops.sketches import SketchBundle, bundle_map, bundle_to_numpy
from ..parallel.cluster import cluster_merge


def fleet_collective_merge(rows: Sequence[SketchBundle], group=None) -> SketchBundle:
    """This process's lane rows, merged across `group`: exactly
    `cluster_merge`, so the on-device fold and the host-side window fold
    cannot drift apart."""
    return cluster_merge(rows, group)


def make_fleet_merge(group=None):
    """``merge(rows) ->`` the fleet bundle: this process's lane bundles
    (rank-major order across the group) folded and reduced across
    `group` (a `torch.distributed` process group; None merges this
    process's rows alone). Every rank gets the same bundle, on its lane
    0's device."""

    def merge(rows: Sequence[SketchBundle]) -> SketchBundle:
        return fleet_collective_merge(rows, group)

    return merge


def shard_over_nodes(mesh: Sequence[torch.device],
                     rows: Sequence[SketchBundle]) -> list[SketchBundle]:
    """Row k of `rows` onto lane k's device of `mesh` (copies)."""
    if len(rows) != len(mesh):
        raise ValueError(f"{len(rows)} rows for a mesh of {len(mesh)}")
    return [bundle_map(lambda t, d=torch.device(d): t.to(d, copy=True), r)
            for r, d in zip(rows, mesh)]


def _treedef(bundle: SketchBundle) -> str:
    """The reference's ``str(jax.tree.structure(bundle))`` for the same
    bundle: its static fields (count-min and entropy log2 widths, HLL p,
    invertible log2 buckets, DDSketch alpha and min value) and which
    optional planes are on."""
    b = bundle
    inv = (f"CustomNode(InvSketch[({b.inv.log2_buckets},)], [*, *, *])"
           if b.inv is not None else "None")
    qt = (f"CustomNode(DDSketch[({b.quantiles.alpha!r}, {b.quantiles.min_value!r})], [*, *, *])"
          if b.quantiles is not None else "None")
    return (f"PyTreeDef(CustomNode(SketchBundle[()], [CustomNode(CountMin[({b.cms.log2_width},)]"
            f", [*, *]), CustomNode(HLL[({b.hll.p},)], [*]), CustomNode(EntropySketch["
            f"({b.entropy.log2_width},)], [*]), CustomNode(TopK[()], [*, *, *]), *, *, {inv}, "
            f"{qt}]))")


def bundle_digest(bundle: SketchBundle) -> str:
    """sha256 over every leaf's dtype name, shape and bytes in the
    reference's leaf order and dtypes (`bundle_to_numpy`), then the
    reference's tree structure string: the same hex digest the
    reference's ``bundle_digest`` gives for the same state, so two
    processes, two fold shapes or two packages compare by it."""
    h = hashlib.sha256()
    for arr in bundle_to_numpy(bundle):
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    h.update(_treedef(bundle).encode())
    return h.hexdigest()


__all__ = ["bundle_digest", "fleet_collective_merge", "make_fleet_merge",
           "shard_over_nodes"]
