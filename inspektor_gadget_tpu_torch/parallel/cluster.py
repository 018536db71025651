"""Cluster-wide sketch pipeline: per-lane updates and collective merges
(PyTorch port of ``inspektor_gadget_tpu/parallel/cluster.py``).

Each lane of a mesh (`parallel.mesh`) holds its own `SketchBundle` on its
own device, so state lives where events land. One `cluster_sketch_step`
absorbs every lane's event batch into its bundle and trains the shared
autoencoder data-parallel: each lane's gradient on its own rows, the
mean over the lanes (and over the ranks of a process group), then ONE
Adam step on the replicated scorer (reference
``models/autoencoder.py:98-106`` under ``shard_map``). `cluster_merge`
is the harvest's collective: the additive planes summed, the HLL
registers maxed, every lane's top-k candidates gathered and re-ranked
against the merged count-min, the invertible and DDSketch lanes summed.

Two forms, as in `ops/lanes.py`: lanes of one process fold in lane order
onto lane 0's device; with a `torch.distributed` group each rank folds
its own lanes and the group reduces once (NCCL on the card, gloo on the
CPU). The merged view is computed per harvest, never per batch, so the
ingest path has no collective.

On a (node, model) mesh (a list of node rows of model lanes,
`parallel.mesh`) the scorer is tensor-parallel, as the reference's is on
its 2-D mesh: `cluster_init` splits it over the model lanes
(`models.autoencoder.ae_shard_tp`, the Megatron split), node row i's
bundle lives on its first lane, and the step runs each row's rows
through its own model lanes, averages the gradients over the rows and
steps each shard's Adam (`ae_train_step_tp`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..models.autoencoder import (AnomalyScorer, TPScorer, ae_loss, ae_param_pspecs,
                                  ae_shard_tp, ae_train_step_tp, normalize_counts)
from ..ops.countmin import cms_psum
from ..ops.entropy import entropy_psum
from ..ops.hll import hll_pmax
from ..ops.invertible import inv_psum
from ..ops.lanes import group_reduce_, psum
from ..ops.quantiles import dd_psum
from ..ops.sketches import SketchBundle, bundle_init, bundle_update
from ..ops.topk import topk_gather_merge
from .mesh import MODEL_AXIS, mesh_shape


@dataclasses.dataclass
class ClusterState:
    """One bundle a node lane (lane k on the mesh's k-th device, or on
    the first lane of row k of a (node, model) mesh) and the scorer:
    replicated, or split over the model lanes (`TPScorer`, with `rows`
    the mesh's rows)."""

    lanes: list[SketchBundle]
    scorer: AnomalyScorer | TPScorer
    rows: list[list[torch.device]] | None = None


def scorer_pspecs(scorer: AnomalyScorer | TPScorer,
                  model_axis: str = MODEL_AXIS) -> dict[str, dict[str, tuple]]:
    """Where the tensor-parallel scorer's leaves live, by dotted name, as
    the reference's PartitionSpec tree: ``params`` by the Megatron split
    (`ae_param_pspecs`), and Adam's ``mu`` and ``nu`` sharded like the
    weight each belongs to."""
    pp = ae_param_pspecs(model_axis)
    params = {f"{layer}.{leaf}": spec for layer, d in pp.items() for leaf, spec in d.items()}
    return {"params": params, "mu": dict(params), "nu": dict(params)}


def cluster_init(mesh: Sequence, scorer: AnomalyScorer, **bundle_kw) -> ClusterState:
    """An empty bundle on every node lane of `mesh`. On a flat mesh the
    scorer stays where it is (one replica in this process); on a (node,
    model) mesh with more than one model lane it is split over row 0's
    model lanes (its own copy: `scorer` is not changed)."""
    shape = mesh_shape(list(mesh))
    if shape[MODEL_AXIS] == 1:
        flat = [row[0] if isinstance(row, (list, tuple)) else row for row in mesh]
        return ClusterState(lanes=[bundle_init(**bundle_kw, device=d) for d in flat],
                            scorer=scorer)
    rows = [[torch.device(d) for d in row] for row in mesh]
    return ClusterState(lanes=[bundle_init(**bundle_kw, device=row[0]) for row in rows],
                        scorer=ae_shard_tp(scorer, rows[0]), rows=rows)


def cluster_sketch_step(state: ClusterState, hh_keys, distinct_keys, dist_keys, mask,
                        ae_batch, use_tp: bool = False, group=None
                        ) -> tuple[ClusterState, torch.Tensor]:
    """Every lane's batch into its bundle (`bundle_update`, in place), and
    one data-parallel Adam step of the autoencoder. Each batch argument
    holds one entry a lane on the lane's device; `ae_batch[k]` is lane
    k's (rows, input_dim) count matrix. Returns the state and the mean
    loss over the lanes (and the group's ranks). With `use_tp` the
    scorer is the state's `TPScorer` (`cluster_init` on a (node, model)
    mesh), each node row's rows run through that row's model lanes
    (`ae_train_step_tp`); a process group does not apply."""
    for k, b in enumerate(state.lanes):
        bundle_update(b, hh_keys[k], distinct_keys[k], dist_keys[k], mask[k])
    if use_tp:
        if not isinstance(state.scorer, TPScorer):
            raise ValueError("use_tp needs a tensor-parallel scorer: cluster_init on a "
                             "(node, model) mesh with n_model > 1")
        if group is not None:
            raise ValueError("the tensor-parallel step runs on this process's lanes only")
        xs = [normalize_counts(torch.as_tensor(a).to(row[0]))
              for a, row in zip(ae_batch, state.rows)]
        _, loss = ae_train_step_tp(state.scorer, xs, state.rows)
        return state, loss
    scorer = state.scorer
    params = [p for p in scorer.model.parameters()]
    grads = [torch.zeros_like(p) for p in params]
    loss = torch.zeros((), device=scorer.device)
    for k in range(len(state.lanes)):
        x = normalize_counts(torch.as_tensor(ae_batch[k]).to(scorer.device))
        lane_loss = ae_loss(scorer.model, x, scorer.config)
        for g, lg in zip(grads, torch.autograd.grad(lane_loss, params)):
            g.add_(lg)
        loss += lane_loss.detach()
    n = len(state.lanes)
    if group is not None:
        import torch.distributed as dist
        for g in grads:
            group_reduce_(g, "sum", group)
        group_reduce_(loss, "sum", group)
        n *= dist.get_world_size(group)
    for p, g in zip(params, grads):
        p.grad = g.div_(n)
    scorer.opt.step()
    scorer.opt.zero_grad(set_to_none=True)
    scorer.steps += 1
    return state, loss / n


def cluster_merge(lanes: Sequence[SketchBundle], group=None) -> SketchBundle:
    """The cluster view of per-lane bundles: count-min, entropy, events,
    drops, invertible and DDSketch lanes summed, HLL maxed, top-k
    gathered in global lane order and re-ranked against the merged
    count-min. On lane 0's device; reduced across `group`'s ranks when
    one is given. No lane is changed."""
    cms = cms_psum([b.cms for b in lanes], group)
    first = lanes[0]
    return SketchBundle(
        cms=cms,
        hll=hll_pmax([b.hll for b in lanes], group),
        entropy=entropy_psum([b.entropy for b in lanes], group),
        topk=topk_gather_merge([b.topk for b in lanes], cms, group),
        events=psum([b.events for b in lanes], group),
        drops=psum([b.drops for b in lanes], group),
        inv=inv_psum([b.inv for b in lanes], group) if first.inv is not None else None,
        quantiles=(dd_psum([b.quantiles for b in lanes], group)
                   if first.quantiles is not None else None))


def make_cluster_step(mesh: Sequence, state: ClusterState, group=None):
    """The pair (step, merge): ``step(state, hh, distinct, dist, mask,
    ae_batch) -> (state, loss)`` (no collective but the gradients' mean;
    tensor-parallel when the mesh has more than one model lane) and
    ``merge(lanes) ->`` the cluster bundle, the harvest's collective."""
    if len(state.lanes) != len(mesh):
        raise ValueError(f"{len(state.lanes)} lane bundles for a mesh of {len(mesh)}")
    use_tp = mesh_shape(list(mesh))[MODEL_AXIS] > 1

    def step(st, hh, distinct, dist, mask, ae_batch):
        return cluster_sketch_step(st, hh, distinct, dist, mask, ae_batch, use_tp=use_tp,
                                   group=group)

    def merge(lanes):
        return cluster_merge(lanes, group)

    return step, merge


__all__ = ["ClusterState", "cluster_init", "cluster_merge", "cluster_sketch_step",
           "make_cluster_step", "scorer_pspecs"]
