"""Sequence anomaly scorer: a causal transformer LM over syscall tokens
(PyTorch port of ``inspektor_gadget_tpu/models/seqmodel.py``, the dense
configuration).

Trained online as a next-token LM over each container's recent event-key
window; the anomaly score is the mean next-token NLL. Matmuls in
``cfg.dtype`` (bf16), layer norm, softmax and attention state in f32,
sinusoidal positions. Attention backends: ``full`` (materialised
scores), ``blockwise`` (streaming over KV chunks) and ``flash`` (K3, the
CUDA kernel on the card, with a recompute backward).

Where the reference is pure, the port updates in place: `seq_train_step`
steps the scorer's own AdamW and returns the same scorer.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..parallel.flash_attention import flash_attention
from ..parallel.ring_attention import blockwise_attention, full_attention
from .params import Dense, Norm, gelu

WEIGHT_DECAY = 1e-4  # optax.adamw's default; torch's AdamW defaults to 1e-2
_LATER = ("waits for the port of parallel/moe.py and the training-side "
          "parallelism (ROADMAP queue A item 13)")


@dataclasses.dataclass(frozen=True)
class SeqConfig:
    vocab: int = 512          # syscall/key token space (key % vocab)
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    lr: float = 1e-3
    dtype: torch.dtype = torch.bfloat16
    n_experts: int = 0        # MoE feed-forward: not ported (raises)


class SeqLayer(nn.Module):
    def __init__(self, d: int, f: int, gen: torch.Generator) -> None:
        super().__init__()

        def dense(fi: int, fo: int) -> Dense:
            return Dense(fi, fo, (2.0 / (fi + fo)) ** 0.5, gen)

        self.ln1 = Norm(d)
        self.qkv = dense(d, 3 * d)
        self.out = dense(d, d)
        self.ln2 = Norm(d)
        self.ff1 = dense(d, f)
        self.ff2 = dense(f, d)


class SeqModel(nn.Module):
    def __init__(self, cfg: SeqConfig, gen: torch.Generator) -> None:
        super().__init__()
        d = cfg.d_model
        self.layers = nn.ModuleList(SeqLayer(d, cfg.d_ff, gen) for _ in range(cfg.n_layers))
        self.embed = nn.Parameter(torch.randn(cfg.vocab, d, generator=gen) * 0.02)
        self.lnf = Norm(d)
        self.unembed = Dense(d, cfg.vocab, (2.0 / (d + cfg.vocab)) ** 0.5, gen)


@dataclasses.dataclass
class SeqScorer:
    model: SeqModel
    opt: torch.optim.AdamW
    steps: int
    config: SeqConfig

    @property
    def device(self) -> torch.device:
        return self.model.embed.device


def seq_init(cfg: SeqConfig = SeqConfig(), seed: int = 0,
             device: str | torch.device = "cuda") -> SeqScorer:
    """Weights drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (the same weights on every device), then moved to `device`."""
    if cfg.n_experts:
        raise NotImplementedError(f"n_experts={cfg.n_experts}: the MoE feed-forward {_LATER}")
    model = SeqModel(cfg, torch.Generator().manual_seed(seed)).to(resolve_device(device))
    opt = torch.optim.AdamW(model.parameters(), lr=cfg.lr, weight_decay=WEIGHT_DECAY)
    return SeqScorer(model=model, opt=opt, steps=0, config=cfg)


def _ln(x: torch.Tensor, p: Norm) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6) * p.g + p.b).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _frequencies(half: int, device: torch.device) -> torch.Tensor:
    """The encoding's f32 frequencies, computed once on the CPU (the same
    values on every device) and kept on `device`."""
    step = torch.tensor(math.log(10000.0), dtype=torch.float32) / max(half - 1, 1)
    return torch.exp(-torch.arange(half, dtype=torch.float32) * step).to(device)


def _sincos_positions(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal encoding, f32, in the reference's order of operations."""
    ang = pos[:, None].float() * _frequencies(d // 2, pos.device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attend(q, k, v, attn: str) -> torch.Tensor:
    if attn == "full":
        return full_attention(q, k, v, causal=True)
    if attn == "flash":
        return flash_attention(q, k, v, causal=True)
    if attn == "blockwise":
        t = q.shape[1]
        chunk = next(c for c in range(min(128, t), 0, -1) if t % c == 0)
        return blockwise_attention(q, k, v, causal=True, chunk=chunk)
    if attn in ("ring", "ulysses"):
        raise NotImplementedError(f"attn={attn!r} shards the sequence over a mesh axis; it "
                                  "waits for the port of sharded ingest and collectives and "
                                  "the training-side parallelism (ROADMAP queue A items 11 "
                                  "and 13)")
    raise ValueError(f"unknown attention impl {attn!r}")


def seq_apply(model: SeqModel, tokens: torch.Tensor, cfg: SeqConfig, attn: str = "full",
              pos_offset: int = 0) -> torch.Tensor:
    """Logits [B, T, vocab] (f32) for token ids [B, T]. A negative id
    takes the embedding row it names from the end, as the reference's
    ``embed[tokens]`` does (padding -1 reads row vocab - 1). The lookup is
    `F.embedding`, whose backward sums a token's rows in parallel; the
    backward of ``embed[idx]`` adds them one at a time, and the zipf token
    windows repeat a few ids thousands of times."""
    b, t = tokens.shape
    d, h = cfg.d_model, cfg.n_heads
    pos = pos_offset + torch.arange(t, device=tokens.device)
    idx = torch.where(tokens < 0, tokens + cfg.vocab, tokens)
    x = (F.embedding(idx, model.embed) + _sincos_positions(pos, d)).to(cfg.dtype)
    for lp in model.layers:
        y = _ln(x, lp.ln1)
        qkv = lp.qkv(y).reshape(b, t, 3, h, d // h)
        a = _attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn).reshape(b, t, d)
        x = x + lp.out(a)
        y = _ln(x, lp.ln2)
        x = x + lp.ff2(gelu(lp.ff1(y)))
    return model.unembed(_ln(x, model.lnf)).float()


def _token_nll(logits: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sequence (sum NLL, count) over masked next-token targets."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0] * mask
    return nll.sum(dim=-1), mask.sum(dim=-1)


def _next_token_terms(model: SeqModel, tokens: torch.Tensor, cfg: SeqConfig, attn: str):
    logits = seq_apply(model, tokens[:, :-1], cfg, attn)
    targets = tokens[:, 1:]
    return _token_nll(logits, targets.clamp(min=0), (targets >= 0).float())


def seq_loss(model: SeqModel, tokens: torch.Tensor, cfg: SeqConfig,
             attn: str = "full") -> torch.Tensor:
    """Mean next-token NLL over every unmasked target of the batch."""
    s, c = _next_token_terms(model, tokens, cfg, attn)
    return s.sum() / torch.clamp(c.sum(), min=1.0)


def _tokens(scorer: SeqScorer, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=scorer.device).long()


def seq_train_step(scorer: SeqScorer, tokens, attn: str = "full") -> tuple[SeqScorer, torch.Tensor]:
    """One AdamW step on the next-token loss of `tokens` [B, T] (padding
    -1); returns the scorer, stepped in place, and the loss before it."""
    tokens = _tokens(scorer, tokens)
    scorer.opt.zero_grad(set_to_none=True)
    loss = seq_loss(scorer.model, tokens, scorer.config, attn)
    loss.backward()
    scorer.opt.step()
    scorer.steps += 1
    return scorer, loss.detach()


@torch.no_grad()
def seq_score(scorer: SeqScorer, tokens, attn: str = "full") -> torch.Tensor:
    """Mean next-token NLL per sequence, the anomaly score. Padding is
    marked with negative token ids."""
    s, c = _next_token_terms(scorer.model, _tokens(scorer, tokens), scorer.config, attn)
    return s / torch.clamp(c, min=1.0)


def make_sp_train_step(*args, **kwargs):
    """Sequence-parallel training: not ported yet."""
    raise NotImplementedError(f"make_sp_train_step {_LATER}")


def make_ep_train_step(*args, **kwargs):
    """Expert-parallel training: not ported yet."""
    raise NotImplementedError(f"make_ep_train_step {_LATER}")


def seq_param_pspecs(*args, **kwargs):
    """Expert-parallel partition specs: not ported yet."""
    raise NotImplementedError(f"seq_param_pspecs {_LATER}")


def tokens_from_keys(keys: np.ndarray, vocab: int) -> np.ndarray:
    """Map raw event keys (any uint width) onto the LM token space."""
    return (keys.astype(np.uint64) % np.uint64(vocab)).astype(np.int32)
