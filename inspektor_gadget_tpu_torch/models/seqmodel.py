"""Sequence anomaly scorer: a causal transformer LM over syscall tokens
(PyTorch port of ``inspektor_gadget_tpu/models/seqmodel.py``).

Trained online as a next-token LM over each container's recent event-key
window; the anomaly score is the mean next-token NLL. Matmuls in
``cfg.dtype`` (bf16), layer norm, softmax and attention state in f32,
sinusoidal positions. Attention backends: ``full`` (materialised
scores), ``blockwise`` (streaming over KV chunks), ``flash`` (K3, the
CUDA kernel on the card, with a recompute backward), and ``ring`` and
``ulysses``, which shard the window over the lanes of a mesh
(`parallel.ring_attention`). With ``n_experts > 0`` each layer's
feed-forward is a routed mixture of experts (`parallel.moe`) and the
loss adds ``balance_coef`` times its balance term.

Training across lanes (`make_sp_train_step`, `make_ep_train_step`): a
mesh is a list of lane devices (`parallel.mesh`). Every step gives each
lane the scorer's replicated weights and its share of the expert stacks
(`LaneTrainStep`). The lanes run one forward in lockstep, layer by
layer, so that ring attention's KV hops and the experts' all-to-all are
copies between lanes; autograd runs through them in one process. The
replicated weights' gradients are summed over the lanes, an expert's
gradient comes from the lane that owns it, and the scorer's one AdamW
steps.

Where the reference is pure, the port updates in place: `seq_train_step`
steps the scorer's own AdamW and returns the same scorer.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.lanes import psum
from ..parallel.flash_attention import flash_attention
from ..parallel.moe import MoE, moe_ff, moe_ff_lanes
from ..parallel.ring_attention import (blockwise_attention, full_attention, ring_attention,
                                       ulysses_attention)
from .params import Dense, Norm, gelu

WEIGHT_DECAY = 1e-4  # optax.adamw's default; torch's AdamW defaults to 1e-2
_LANE_ATTN = {"ring": ring_attention, "ulysses": ulysses_attention}


@dataclasses.dataclass(frozen=True)
class SeqConfig:
    vocab: int = 512          # syscall/key token space (key % vocab)
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    lr: float = 1e-3
    dtype: torch.dtype = torch.bfloat16
    # MoE feed-forward (0 = dense): experts shard over the lanes of an
    # expert axis in make_ep_train_step
    n_experts: int = 0
    capacity_factor: float = 2.0
    balance_coef: float = 0.01


class SeqLayer(nn.Module):
    def __init__(self, cfg: SeqConfig, gen: torch.Generator, n_local: int | None = None) -> None:
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff

        def dense(fi: int, fo: int) -> Dense:
            return Dense(fi, fo, (2.0 / (fi + fo)) ** 0.5, gen)

        self.ln1 = Norm(d)
        self.qkv = dense(d, 3 * d)
        self.out = dense(d, d)
        self.ln2 = Norm(d)
        if cfg.n_experts:
            self.moe = MoE(cfg.n_experts, d, f, gen, n_local=n_local)
        else:
            self.ff1 = dense(d, f)
            self.ff2 = dense(f, d)


class SeqModel(nn.Module):
    """The reference's parameter tree as modules. `n_local` experts a
    layer for a lane of an expert-parallel step (default: all of them)."""

    def __init__(self, cfg: SeqConfig, gen: torch.Generator, n_local: int | None = None) -> None:
        super().__init__()
        d = cfg.d_model
        self.layers = nn.ModuleList(SeqLayer(cfg, gen, n_local) for _ in range(cfg.n_layers))
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


def _adamw(model: nn.Module, cfg: SeqConfig) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=cfg.lr, weight_decay=WEIGHT_DECAY)


def seq_init(cfg: SeqConfig = SeqConfig(), seed: int = 0,
             device: str | torch.device = "cuda") -> SeqScorer:
    """Weights drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (the same weights on every device), then moved to `device`."""
    model = SeqModel(cfg, torch.Generator().manual_seed(seed)).to(resolve_device(device))
    return SeqScorer(model=model, opt=_adamw(model, cfg), steps=0, config=cfg)


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
    raise ValueError(f"unknown attention impl {attn!r}")


def _apply_lanes(models: Sequence[SeqModel], tokens: Sequence[torch.Tensor], cfg: SeqConfig,
                 attn: str = "full", pos_offsets: Sequence[int] | None = None,
                 ep: bool = False) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The forward of every lane at once, layer by layer: lane r runs
    ``models[r]`` on ``tokens[r]`` [B_r, T_r] from global position
    ``pos_offsets[r]``. ``ring`` and ``ulysses`` attend across the lanes
    (the lanes hold consecutive shards of one window); with `ep` the MoE
    layers dispatch across the lanes (each model holds its lane's
    experts). Returns each lane's logits [B_r, T_r, vocab] (f32) and
    its summed MoE balance term. A negative id takes the embedding row
    it names from the end, as the reference's ``embed[tokens]`` does
    (padding -1 reads row vocab - 1). The lookup is `F.embedding`, whose
    backward sums a token's rows in parallel; the backward of
    ``embed[idx]`` adds them one at a time, and the zipf token windows
    repeat a few ids thousands of times."""
    d, h = cfg.d_model, cfg.n_heads
    offsets = pos_offsets or [0] * len(models)
    xs, shapes = [], []
    for m, tok, off in zip(models, tokens, offsets):
        b, t = tok.shape
        pos = off + torch.arange(t, device=tok.device)
        idx = torch.where(tok < 0, tok + cfg.vocab, tok)
        xs.append((F.embedding(idx, m.embed) + _sincos_positions(pos, d)).to(cfg.dtype))
        shapes.append((b, t))
    balance = [torch.zeros((), device=tok.device) for tok in tokens]
    for i in range(cfg.n_layers):
        layers = [m.layers[i] for m in models]
        qkv = [lp.qkv(_ln(x, lp.ln1)).reshape(b, t, 3, h, d // h)
               for lp, x, (b, t) in zip(layers, xs, shapes)]
        qs, ks, vs = ([y[:, :, j] for y in qkv] for j in range(3))
        if attn in _LANE_ATTN:
            att = _LANE_ATTN[attn](qs, ks, vs, causal=True)
        else:
            att = [_attend(q, k, v, attn) for q, k, v in zip(qs, ks, vs)]
        xs = [x + lp.out(a.reshape(b, t, d)) for lp, x, a, (b, t) in zip(layers, xs, att, shapes)]
        ys = [_ln(x, lp.ln2) for lp, x in zip(layers, xs)]
        if cfg.n_experts and ep:
            ffs, aux = moe_ff_lanes([lp.moe for lp in layers],
                                    [y.reshape(b * t, d) for y, (b, t) in zip(ys, shapes)],
                                    cfg.capacity_factor)
            balance = [bal + a[0] for bal, a in zip(balance, aux)]
        elif cfg.n_experts:
            ffs = []
            for r, (lp, y, (b, t)) in enumerate(zip(layers, ys, shapes)):
                ff, (bal, _) = moe_ff(lp.moe, y.reshape(b * t, d), cfg.capacity_factor)
                ffs.append(ff)
                balance[r] = balance[r] + bal
        else:
            ffs = [lp.ff2(gelu(lp.ff1(y))) for lp, y in zip(layers, ys)]
        xs = [x + ff.reshape(b, t, d) for x, ff, (b, t) in zip(xs, ffs, shapes)]
    logits = [m.unembed(_ln(x, m.lnf)).float() for m, x in zip(models, xs)]
    return logits, balance


def _seq_apply_aux(model: SeqModel, tokens: torch.Tensor, cfg: SeqConfig, attn: str = "full",
                   pos_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits [B, T, vocab], the MoE balance term) of one model."""
    logits, balance = _apply_lanes([model], [tokens], cfg, attn, [pos_offset])
    return logits[0], balance[0]


def seq_apply(model: SeqModel, tokens: torch.Tensor, cfg: SeqConfig, attn: str = "full",
              pos_offset: int = 0) -> torch.Tensor:
    """Logits [B, T, vocab] (f32) for token ids [B, T] (`_apply_lanes`
    on one lane)."""
    return _seq_apply_aux(model, tokens, cfg, attn, pos_offset)[0]


def _token_nll(logits: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sequence (sum NLL, count) over masked next-token targets."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0] * mask
    return nll.sum(dim=-1), mask.sum(dim=-1)


def _next_token_terms(model: SeqModel, tokens: torch.Tensor, cfg: SeqConfig, attn: str):
    logits, balance = _seq_apply_aux(model, tokens[:, :-1], cfg, attn)
    targets = tokens[:, 1:]
    s, c = _token_nll(logits, targets.clamp(min=0), (targets >= 0).float())
    return s, c, balance


def seq_loss(model: SeqModel, tokens: torch.Tensor, cfg: SeqConfig,
             attn: str = "full") -> torch.Tensor:
    """Mean next-token NLL over every unmasked target of the batch, plus
    ``balance_coef`` times the MoE balance term when there are experts."""
    s, c, balance = _next_token_terms(model, tokens, cfg, attn)
    loss = s.sum() / torch.clamp(c.sum(), min=1.0)
    return loss + cfg.balance_coef * balance if cfg.n_experts else loss


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
    s, c, _ = _next_token_terms(scorer.model, _tokens(scorer, tokens), scorer.config, attn)
    return s / torch.clamp(c, min=1.0)


# -- training across lanes ------------------------------------------------------

def _is_expert_name(name: str) -> bool:
    """An expert stack's leaf (``layers.i.moe.w1`` ...), not the router."""
    parts = name.split(".")
    return "moe" in parts and parts[-1] != "gate"


def seq_param_pspecs(scorer: SeqScorer | SeqModel, ep_axis: str = "expert") -> dict[str, tuple]:
    """Where each weight of a MoE seq model lives, by dotted name, as the
    reference's PartitionSpecs: the expert stacks split on their leading
    axis over `ep_axis`, everything else (embedding, attention, router,
    norms) replicated (``()``). AdamW's moments follow their weight."""
    model = scorer.model if isinstance(scorer, SeqScorer) else scorer
    return {name: ((ep_axis,) if _is_expert_name(name) else ())
            for name, _ in model.named_parameters()}


class _Lanes(nn.Module):
    """The lanes' module trees as one module, so that one
    `torch.func.functional_call` binds every lane's weights for
    ``loss_fn(models, shards)``."""

    def __init__(self, models: Sequence[SeqModel]) -> None:
        super().__init__()
        self.models = nn.ModuleList(models)

    def forward(self, loss_fn, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        return loss_fn(list(self.models), shards)


class LaneTrainStep:
    """A train step over the lanes of a mesh. `scorer` is the one copy of
    the weights and AdamW state. Each call gives every lane the scorer's
    weights (a view where the lane shares the scorer's device, else a
    copy; with `shard_experts`, only the lane's share of each expert
    stack), splits the token matrix over the lanes along `split_dim` (0:
    rows, 1: the window), runs the lanes' forward and backward, and
    gathers their gradients into the scorer: a replicated weight's summed
    over the lanes in lane order, an expert stack's concatenated from the
    lanes that own its experts. Then the scorer's AdamW steps. AdamW is
    elementwise, so this is the step every lane of the reference takes on
    its replica or its share; and whatever trains or reloads the scorer
    between two calls carries into the next. ``step(tokens) -> loss``."""

    def __init__(self, scorer: SeqScorer, mesh: Sequence[torch.device], loss_fn,
                 split_dim: int, shard_experts: bool = False) -> None:
        cfg = scorer.config
        self.scorer, self.config, self.loss_fn = scorer, cfg, loss_fn
        self.split_dim = split_dim
        self.lanes = [torch.device(d) for d in mesh]
        self.n_local = cfg.n_experts // len(self.lanes) if shard_experts else None
        # each lane's module tree, weights-free: a call binds the scorer's
        self.models = [SeqModel(cfg, torch.Generator(), self.n_local).to("meta")
                       for _ in self.lanes]
        self._bind = _Lanes(self.models)

    def _sharded(self, name: str) -> bool:
        return self.n_local is not None and _is_expert_name(name)

    def _lane_leaf(self, p: torch.Tensor, name: str, r: int, dev: torch.device) -> torch.Tensor:
        t = p.detach()
        if self._sharded(name):
            t = t[r * self.n_local:(r + 1) * self.n_local]
        return t.to(dev).requires_grad_()

    def __call__(self, tokens) -> torch.Tensor:
        sc = self.scorer
        master = dict(sc.model.named_parameters())
        lanes = [{name: self._lane_leaf(p, name, r, dev) for name, p in master.items()}
                 for r, dev in enumerate(self.lanes)]
        shards = [t.to(d) for t, d in zip(self._split(tokens), self.lanes)]
        bound = {f"models.{r}.{name}": t for r, ws in enumerate(lanes) for name, t in ws.items()}
        loss = torch.func.functional_call(self._bind, bound, (self.loss_fn, shards))
        loss.backward()
        sc.opt.zero_grad(set_to_none=True)
        for name, p in master.items():
            grads = [ws[name].grad if ws[name].grad is not None else torch.zeros_like(ws[name])
                     for ws in lanes]
            if self._sharded(name):
                p.grad = torch.cat([g.to(p.device) for g in grads])
            else:
                p.grad = psum(grads).to(p.device)
        sc.opt.step()
        sc.steps += 1
        return loss.detach()

    def _split(self, tokens) -> list[torch.Tensor]:
        tokens = torch.as_tensor(tokens).long()
        n, size = len(self.lanes), tokens.shape[self.split_dim]
        if size % n:
            raise ValueError(f"{'BT'[self.split_dim]}={size} is not divisible by the {n} "
                             f"lane(s)")
        return list(tokens.chunk(n, dim=self.split_dim))


def make_sp_train_step(mesh: Sequence[torch.device], cfg: SeqConfig, scorer: SeqScorer,
                       attn: str = "ring", axis: str = "seq") -> LaneTrainStep:
    """A sequence-parallel train step: tokens [B, T] sharded over the
    lanes of `mesh` along T (lane r holds columns ``r * T / n`` on), every
    weight replicated with its gradient summed over the lanes, `attn`
    ``ring`` or ``ulysses`` across the lanes. Each lane's next-token
    targets cross its shard's end: the next lane's first token (the
    reference's ``ppermute``), and the last global position has none.
    The step's loss is the batch's mean next-token NLL, as `seq_loss`
    gives it on one device. Each call steps `scorer`'s weights and AdamW
    state (`LaneTrainStep`)."""
    if attn not in _LANE_ATTN:
        raise ValueError(f"attn={attn!r}: a sequence-parallel step attends with "
                         f"{sorted(_LANE_ATTN)}")
    del axis  # the lanes are the axis

    def loss_fn(models, toks):
        n = len(toks)
        t = toks[0].shape[1]
        logits, _ = _apply_lanes(models, toks, cfg, attn, [r * t for r in range(n)])
        dev = toks[0].device
        s_sum, c_sum = [], []
        for r, (lg, tok) in enumerate(zip(logits, toks)):
            nxt_first = toks[(r + 1) % n][:, 0].to(tok.device)
            targets = torch.cat([tok[:, 1:], nxt_first[:, None]], dim=1)
            mask = (targets >= 0).float()
            if r == n - 1:
                mask[:, -1] = 0.0
            s, c = _token_nll(lg, targets.clamp(min=0), mask)
            s_sum.append(s.sum().to(dev))
            c_sum.append(c.sum().to(dev))
        return torch.stack(s_sum).sum() / torch.clamp(torch.stack(c_sum).sum(), min=1.0)

    return LaneTrainStep(scorer, mesh, loss_fn, split_dim=1)


def make_ep_train_step(mesh: Sequence[torch.device], cfg: SeqConfig, scorer: SeqScorer,
                       attn: str = "full", axis: str = "expert") -> LaneTrainStep:
    """An expert-parallel train step for a MoE seq scorer: token rows
    [B, T] sharded over the lanes of `mesh` (data parallel), each MoE
    layer's experts split over the same lanes (the layers dispatch across
    them), the other weights replicated with their gradients summed over
    the lanes; an expert's gradient is complete on the lane that owns it.
    The loss: the NLL summed over the lanes over their summed count, plus
    ``balance_coef`` times the lanes' mean balance term. Each call steps
    `scorer`'s weights and AdamW state (`LaneTrainStep`)."""
    if not cfg.n_experts:
        raise ValueError("make_ep_train_step requires cfg.n_experts > 0")
    n = len(mesh)
    if cfg.n_experts % n:
        raise ValueError(f"n_experts={cfg.n_experts} not divisible by {n}")
    del axis

    def loss_fn(models, toks):
        logits, balance = _apply_lanes(models, [t[:, :-1] for t in toks], cfg, attn, ep=True)
        dev = toks[0].device
        s_sum, c_sum = [], []
        for lg, tok in zip(logits, toks):
            targets = tok[:, 1:]
            s, c = _token_nll(lg, targets.clamp(min=0), (targets >= 0).float())
            s_sum.append(s.sum().to(dev))
            c_sum.append(c.sum().to(dev))
        nll = torch.stack(s_sum).sum() / torch.clamp(torch.stack(c_sum).sum(), min=1.0)
        return nll + cfg.balance_coef * torch.stack([b.to(dev) for b in balance]).mean()

    return LaneTrainStep(scorer, mesh, loss_fn, split_dim=0, shard_experts=True)


def tokens_from_keys(keys: np.ndarray, vocab: int) -> np.ndarray:
    """Map raw event keys (any uint width) onto the LM token space."""
    return (keys.astype(np.uint64) % np.uint64(vocab)).astype(np.int32)
