"""Autoencoder anomaly scorer over per-container event distributions
(PyTorch port of ``inspektor_gadget_tpu/models/autoencoder.py``).

Input: L1-normalised, log-scaled count vectors (the per-container
distribution over the entropy sketch's 2^12 buckets). A 4-layer MLP
reconstructs the vector; the per-row MSE is the anomaly score. Weights
in f32, matmuls in ``compute_dtype`` (bf16). `ae_train_step` steps the
scorer's own Adam in place, where the reference returns a new scorer.

The tensor-parallel variant (the ``*_tp`` functions) is the reference's
Megatron split over the lanes of a model axis (`parallel.mesh`): enc1
and dec1 column-parallel (the hidden units split, no collective), enc2
and dec2 row-parallel (each lane contracts its hidden units, then one
sum over the lanes, in lane order and in the compute type, before the
bias). A `TPScorer` holds one shard a lane with its own Adam state;
Adam is elementwise, so the shards step as the whole would.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from ..device import resolve_device
from .params import Dense, gelu


@dataclasses.dataclass(frozen=True)
class AEConfig:
    input_dim: int = 4096        # the entropy sketch's width (2^12)
    hidden_dim: int = 512
    latent_dim: int = 128
    learning_rate: float = 1e-3
    compute_dtype: torch.dtype = torch.bfloat16


class AEModel(nn.Module):
    def __init__(self, cfg: AEConfig, gen: torch.Generator) -> None:
        super().__init__()

        def dense(fi: int, fo: int) -> Dense:
            return Dense(fi, fo, (2.0 / fi) ** 0.5, gen)

        self.enc1 = dense(cfg.input_dim, cfg.hidden_dim)
        self.enc2 = dense(cfg.hidden_dim, cfg.latent_dim)
        self.dec1 = dense(cfg.latent_dim, cfg.hidden_dim)
        self.dec2 = dense(cfg.hidden_dim, cfg.input_dim)


@dataclasses.dataclass
class AnomalyScorer:
    model: AEModel
    opt: torch.optim.Adam
    steps: int
    config: AEConfig

    @property
    def device(self) -> torch.device:
        return self.model.enc1.w.device


def ae_init(cfg: AEConfig = AEConfig(), seed: int = 0,
            device: str | torch.device = "cuda") -> AnomalyScorer:
    """Weights drawn on the CPU from ``torch.Generator().manual_seed(seed)``,
    then moved to `device`."""
    model = AEModel(cfg, torch.Generator().manual_seed(seed)).to(resolve_device(device))
    opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
    return AnomalyScorer(model=model, opt=opt, steps=0, config=cfg)


def ae_apply(model: AEModel, x: torch.Tensor, cfg: AEConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    h = gelu(model.enc1(x, dt))
    z = gelu(model.enc2(h, dt))
    h = gelu(model.dec1(z, dt))
    return model.dec2(h, dt).float()


def normalize_counts(counts: torch.Tensor) -> torch.Tensor:
    """log1p + L1 normalise a (batch, dim) count matrix."""
    x = torch.log1p(counts.float())
    return x / torch.clamp(x.sum(dim=-1, keepdim=True), min=1e-6)


def ae_loss(model: AEModel, x: torch.Tensor, cfg: AEConfig) -> torch.Tensor:
    return ((ae_apply(model, x, cfg) - x) ** 2).mean()


@torch.no_grad()
def ae_score(scorer: AnomalyScorer, x: torch.Tensor) -> torch.Tensor:
    """Per-row anomaly score: reconstruction MSE, scaled by the width."""
    recon = ae_apply(scorer.model, x, scorer.config)
    return ((recon - x) ** 2).mean(dim=-1) * x.shape[-1]


def ae_train_step(scorer: AnomalyScorer, x: torch.Tensor) -> tuple[AnomalyScorer, torch.Tensor]:
    """One Adam step; returns the scorer, stepped in place, and the loss
    before it."""
    scorer.opt.zero_grad(set_to_none=True)
    loss = ae_loss(scorer.model, x, scorer.config)
    loss.backward()
    scorer.opt.step()
    scorer.steps += 1
    return scorer, loss.detach()


# -- tensor parallelism over a model axis ----------------------------------------

_COL, _ROW = ("enc1", "dec1"), ("enc2", "dec2")


def ae_param_pspecs(model_axis: str = "model") -> dict[str, dict[str, tuple]]:
    """Where each weight of a tensor-parallel autoencoder lives, as the
    reference's PartitionSpecs: column-parallel layers split w on its
    output axis and b with it, row-parallel layers split w on its input
    axis and keep b whole (``()``: replicated)."""
    col = {"w": (None, model_axis), "b": (model_axis,)}
    row = {"w": (model_axis, None), "b": ()}
    return {"enc1": col, "enc2": row, "dec1": col, "dec2": row}


class AEShard(nn.Module):
    """One model lane's share of the autoencoder's weights. The
    row-parallel layers' biases are whole on every lane, as the
    reference replicates them; the forward adds lane 0's once after the
    model axis' sum, so only lane 0's copy trains."""

    def __init__(self, cfg: AEConfig, n: int) -> None:
        super().__init__()
        h = cfg.hidden_dim // n
        for name, (fi, fo, bo) in {"enc1": (cfg.input_dim, h, h),
                                   "enc2": (h, cfg.latent_dim, cfg.latent_dim),
                                   "dec1": (cfg.latent_dim, h, h),
                                   "dec2": (h, cfg.input_dim, cfg.input_dim)}.items():
            layer = nn.Module()
            layer.w = nn.Parameter(torch.zeros(fi, fo))
            layer.b = nn.Parameter(torch.zeros(bo))
            self.add_module(name, layer)


def _shard_slice(t: torch.Tensor, layer: str, leaf: str, r: int, n: int) -> torch.Tensor:
    """Lane r of n's part of `t` (a weight or an Adam moment of it)."""
    if layer in _COL:
        return t.chunk(n, dim=-1)[r]
    return t.chunk(n, dim=0)[r] if leaf == "w" else t


@dataclasses.dataclass
class TPScorer:
    """A tensor-parallel autoencoder: shard r on lane r of the model axis,
    each with its own Adam."""

    shards: list[AEShard]
    opts: list[torch.optim.Adam]
    steps: int
    config: AEConfig

    @property
    def lanes(self) -> list[torch.device]:
        return [s.enc1.w.device for s in self.shards]


def ae_shard_tp(scorer: AnomalyScorer, lanes: Sequence[torch.device]) -> TPScorer:
    """Split a replicated scorer's weights and Adam state over the model
    lanes `lanes` (`ae_param_pspecs`); its hidden width must divide by
    their count."""
    n = len(lanes)
    cfg = scorer.config
    if cfg.hidden_dim % n:
        raise ValueError(f"hidden_dim={cfg.hidden_dim} not divisible by {n} model lane(s)")
    master = dict(scorer.model.named_parameters())
    shards, opts = [], []
    for r, dev in enumerate(lanes):
        shard = AEShard(cfg, n).to(dev)
        opt = torch.optim.Adam(shard.parameters(), lr=cfg.learning_rate)
        with torch.no_grad():
            for name, p in shard.named_parameters():
                layer, leaf = name.split(".")
                p.copy_(_shard_slice(master[name].detach(), layer, leaf, r, n))
                st = scorer.opt.state.get(master[name])
                if st:
                    opt.state[p] = {"step": st["step"].clone(), **{
                        k: _shard_slice(st[k], layer, leaf, r, n).clone().to(dev)
                        for k in ("exp_avg", "exp_avg_sq")}}
        shards.append(shard)
        opts.append(opt)
    return TPScorer(shards=shards, opts=opts, steps=scorer.steps, config=cfg)


def ae_gather_tp(tp: TPScorer, moment: str | None = None) -> dict[str, dict[str, torch.Tensor]]:
    """The whole weights of a tensor-parallel scorer, as the reference's
    parameter tree of fresh CPU tensors (row-parallel biases from lane
    0); with `moment` (``exp_avg`` or ``exp_avg_sq``), that Adam moment
    of every weight instead."""
    out: dict[str, dict[str, torch.Tensor]] = {}
    for layer in _COL + _ROW:
        for leaf in ("w", "b"):
            ps = [getattr(getattr(s, layer), leaf) for s in tp.shards]
            if layer in _ROW and leaf == "b":  # the forward adds lane 0's copy
                ps = ps[:1]
            parts = [(p if moment is None else opt.state[p][moment]).detach().cpu()
                     for p, opt in zip(ps, tp.opts)]
            if layer in _COL:
                whole = torch.cat(parts, dim=-1)
            else:
                whole = torch.cat(parts, dim=0) if leaf == "w" else parts[0].clone()
            out.setdefault(layer, {})[leaf] = whole
    return out


def _psum_lanes(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The model axis' sum, in lane order on lane 0's device (autograd
    flows back to every lane)."""
    out = parts[0]
    for t in parts[1:]:
        out = out + t.to(out.device)
    return out


def _weights(shards: Sequence[AEShard], lanes: Sequence[torch.device] | None = None
             ) -> list[dict[str, tuple[torch.Tensor, torch.Tensor]]]:
    """Each shard's (w, b) by layer, copied to `lanes` when given (a data
    lane's row of the mesh; autograd flows back to the shard)."""
    devs = lanes or [s.enc1.w.device for s in shards]
    return [{name: (getattr(s, name).w.to(d), getattr(s, name).b.to(d)) for name in _COL + _ROW}
            for s, d in zip(shards, devs)]


def _apply_tp(ws, x: torch.Tensor, cfg: AEConfig) -> torch.Tensor:
    dt = cfg.compute_dtype

    def layer(v, wb):
        return v.to(dt) @ wb[0].to(dt) + wb[1].to(dt)

    lanes = [w["enc1"][0].device for w in ws]
    hs = [gelu(layer(x.to(d), w["enc1"])) for w, d in zip(ws, lanes)]
    z = _psum_lanes([h.to(dt) @ w["enc2"][0].to(dt) for h, w in zip(hs, ws)])
    z = gelu(z + ws[0]["enc2"][1].to(dt))
    h2 = [gelu(layer(z.to(d), w["dec1"])) for w, d in zip(ws, lanes)]
    out = _psum_lanes([h.to(dt) @ w["dec2"][0].to(dt) for h, w in zip(h2, ws)])
    return (out + ws[0]["dec2"][1].to(dt)).float()


def ae_apply_tp(shards: Sequence[AEShard], x: torch.Tensor, cfg: AEConfig) -> torch.Tensor:
    """The tensor-parallel forward: x [b, input_dim] -> the
    reconstruction [b, input_dim] (f32) on the first model lane's device."""
    return _apply_tp(_weights(shards), x, cfg)


def ae_loss_tp(shards: Sequence[AEShard], x: torch.Tensor, cfg: AEConfig,
               lanes: Sequence[torch.device] | None = None) -> torch.Tensor:
    ws = _weights(shards, lanes)
    return ((_apply_tp(ws, x, cfg) - x.to(ws[0]["enc1"][0].device)) ** 2).mean()


@torch.no_grad()
def ae_score_tp(tp: TPScorer, x: torch.Tensor) -> torch.Tensor:
    """Per-row anomaly score of the tensor-parallel scorer."""
    recon = ae_apply_tp(tp.shards, x, tp.config)
    x = x.to(recon.device)
    return ((recon - x) ** 2).mean(dim=-1) * x.shape[-1]


def ae_train_step_tp(tp: TPScorer, xs: Sequence[torch.Tensor],
                     rows: Sequence[Sequence[torch.device]] | None = None
                     ) -> tuple[TPScorer, torch.Tensor]:
    """One data-parallel x tensor-parallel Adam step: data lane i's rows
    `xs[i]` through the model lanes ``rows[i]`` (default: the shards'
    own), the gradients' mean over the data lanes (the reference's
    ``pmean`` over its data axis), then each shard's Adam. Returns the
    scorer, stepped in place, and the mean loss before it."""
    for opt in tp.opts:
        opt.zero_grad(set_to_none=True)
    rows = rows or [None] * len(xs)
    dev = tp.lanes[0]
    loss = torch.stack([ae_loss_tp(tp.shards, x, tp.config, row).to(dev)
                        for x, row in zip(xs, rows)]).mean()
    loss.backward()
    for opt in tp.opts:
        opt.step()
    tp.steps += 1
    return tp, loss.detach()
