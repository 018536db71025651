"""Variational autoencoder anomaly scorer (PyTorch port of
``inspektor_gadget_tpu/models/vae.py``).

Score = negative ELBO (reconstruction error + KL to the unit Gaussian).
Same interface as the AE scorer. The reparameterisation noise comes from
the scorer's own ``torch.Generator`` on the scorer's device, seeded from
the weights' generator (so a seed fixes both), and is drawn where it is
used; the card's and the CPU's draws differ. `vae_elbo_terms`,
`vae_loss` and `vae_train_step` also take the noise as a tensor.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from .params import Dense, gelu


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    input_dim: int = 4096
    hidden_dim: int = 512
    latent_dim: int = 64
    learning_rate: float = 1e-3
    kl_weight: float = 1e-2
    compute_dtype: torch.dtype = torch.bfloat16


class VAEModel(nn.Module):
    def __init__(self, cfg: VAEConfig, gen: torch.Generator) -> None:
        super().__init__()

        def dense(fi: int, fo: int) -> Dense:
            return Dense(fi, fo, (2.0 / fi) ** 0.5, gen)

        self.enc = dense(cfg.input_dim, cfg.hidden_dim)
        self.mu = dense(cfg.hidden_dim, cfg.latent_dim)
        self.logvar = dense(cfg.hidden_dim, cfg.latent_dim)
        self.dec1 = dense(cfg.latent_dim, cfg.hidden_dim)
        self.dec2 = dense(cfg.hidden_dim, cfg.input_dim)


@dataclasses.dataclass
class VAEScorer:
    model: VAEModel
    opt: torch.optim.Adam
    gen: torch.Generator
    steps: int
    config: VAEConfig

    @property
    def device(self) -> torch.device:
        return self.model.enc.w.device


def vae_init(cfg: VAEConfig = VAEConfig(), seed: int = 0,
             device: str | torch.device = "cuda") -> VAEScorer:
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = VAEModel(cfg, gen).to(dev)
    noise = torch.Generator(device=dev)
    noise.manual_seed(int(torch.randint(2**62, (), generator=gen)))
    opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
    return VAEScorer(model=model, opt=opt, gen=noise, steps=0, config=cfg)


def vae_encode(model: VAEModel, x: torch.Tensor, cfg: VAEConfig):
    h = gelu(model.enc(x, cfg.compute_dtype))
    return (model.mu(h, cfg.compute_dtype).float(),
            model.logvar(h, cfg.compute_dtype).float())


def vae_decode(model: VAEModel, z: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    h = gelu(model.dec1(z, cfg.compute_dtype))
    return model.dec2(h, cfg.compute_dtype).float()


def vae_elbo_terms(model: VAEModel, x: torch.Tensor, eps: torch.Tensor | None,
                   cfg: VAEConfig):
    """(reconstruction error, KL) per row, with z = mu + sigma * eps, or
    z = mu when `eps` is None (the score)."""
    mu, logvar = vae_encode(model, x, cfg)
    logvar = torch.clamp(logvar, -8.0, 8.0)
    z = mu if eps is None else mu + torch.exp(0.5 * logvar) * eps
    recon = vae_decode(model, z, cfg)
    rec_err = ((recon - x) ** 2).mean(dim=-1) * x.shape[-1]
    kl = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1)
    return rec_err, kl


def vae_loss(model: VAEModel, x: torch.Tensor, eps: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    rec, kl = vae_elbo_terms(model, x, eps, cfg)
    return (rec + cfg.kl_weight * kl).mean()


@torch.no_grad()
def vae_score(scorer: VAEScorer, x: torch.Tensor) -> torch.Tensor:
    """Anomaly score = negative ELBO per row (deterministic: z = mu)."""
    rec, kl = vae_elbo_terms(scorer.model, x, None, scorer.config)
    return rec + scorer.config.kl_weight * kl


def vae_train_step(scorer: VAEScorer, x: torch.Tensor,
                   eps: torch.Tensor | None = None) -> tuple[VAEScorer, torch.Tensor]:
    """One Adam step on the ELBO loss, with noise `eps` (batch, latent)
    or, by default, the next draw of the scorer's generator; returns the
    scorer, stepped in place, and the loss before it."""
    if eps is None:
        eps = torch.randn(x.shape[0], scorer.config.latent_dim, generator=scorer.gen,
                          device=scorer.device)
    scorer.opt.zero_grad(set_to_none=True)
    loss = vae_loss(scorer.model, x, eps.to(x.device), scorer.config)
    loss.backward()
    scorer.opt.step()
    scorer.steps += 1
    return scorer, loss.detach()
