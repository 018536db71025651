"""Autoencoder anomaly scorer over per-container event distributions
(PyTorch port of ``inspektor_gadget_tpu/models/autoencoder.py``).

Input: L1-normalised, log-scaled count vectors (the per-container
distribution over the entropy sketch's 2^12 buckets). A 4-layer MLP
reconstructs the vector; the per-row MSE is the anomaly score. Weights
in f32, matmuls in ``compute_dtype`` (bf16). `ae_train_step` steps the
scorer's own Adam in place, where the reference returns a new scorer.
The tensor-parallel ``*_tp`` variants wait for ROADMAP queue A item 13.
"""

from __future__ import annotations

import dataclasses

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
