"""Expert parallelism: Switch-style top-1 routed mixture of experts
(PyTorch port of ``inspektor_gadget_tpu/parallel/moe.py``).

- Top-1 routing with a fixed per-expert capacity, as the reference
  routes: argmax over the float32 softmax of ``x @ gate`` (the first
  index on ties), each token's slot the exclusive running count of its
  expert, capacity ``max(1, int(t / n_experts * capacity_factor))``; a
  token past its expert's capacity gets a zero expert output (the
  caller's residual carries it). The router reports the Switch
  load-balance term and the dropped fraction.
- The reference dispatches and combines with one-hot einsums over a
  dense [T, E, C] tensor. Each of their sums has one non-zero term, so
  gathering a kept token into its (expert, slot) cell and reading the
  cell back times the gate gives the same values; the port does that
  and keeps `Routing.dispatch` and `Routing.combine`, the dense
  tensors, for comparing the routing.
- The expert matmuls run in bf16 (``torch.matmul``), the biases and the
  output in float32, as in the reference; neither package has a kernel
  for them.
- Expert parallelism over the lanes of a mesh (`parallel.mesh`): tokens
  shard over the lanes, and with E experts over n lanes each lane holds
  E / n of them (`moe_shard`). The reference's two ``all_to_all`` hops
  become lane-to-lane copies: tokens to the lane that owns their
  expert, expert outputs back to the token's lane.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from ..models.params import gelu

EXPERT_AXIS = "expert"
_EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


class MoE(nn.Module):
    """Router and stacked expert FFN weights, experts on the leading
    axis (the reference's ``moe_init`` dict: gate (d, E); w1 (E, d, f),
    b1 (E, f), w2 (E, f, d), b2 (E, d)). A lane's shard holds the global
    gate and its own experts."""

    def __init__(self, n_experts: int, d_model: int, d_ff: int, gen: torch.Generator,
                 n_local: int | None = None) -> None:
        super().__init__()
        e = n_experts if n_local is None else n_local
        s1 = (2.0 / (d_model + d_ff)) ** 0.5
        self.gate = nn.Parameter(torch.randn(d_model, n_experts, generator=gen) * 0.02)
        self.w1 = nn.Parameter(torch.randn(e, d_model, d_ff, generator=gen) * s1)
        self.b1 = nn.Parameter(torch.zeros(e, d_ff))
        self.w2 = nn.Parameter(torch.randn(e, d_ff, d_model, generator=gen) * s1)
        self.b2 = nn.Parameter(torch.zeros(e, d_model))

    @property
    def n_experts(self) -> int:
        return self.gate.shape[1]


def moe_init(seed: int | torch.Generator, n_experts: int, d_model: int, d_ff: int,
             device: str | torch.device = "cpu") -> MoE:
    """Router and stacked expert FFNs drawn from `seed` (an int or a
    ``torch.Generator``) on the CPU, then moved to `device`."""
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    return MoE(n_experts, d_model, d_ff, gen).to(device)


def moe_pspecs(expert_axis: str = EXPERT_AXIS) -> dict[str, tuple]:
    """Where each leaf lives, as the reference's PartitionSpecs: the
    router replicated (``()``), the experts split on their leading axis
    over `expert_axis`. `moe_shard` places them so."""
    return {"gate": (), **{k: (expert_axis,) for k in _EXPERT_LEAVES}}


def moe_shard(moe: MoE, lanes: Sequence[torch.device]) -> list[MoE]:
    """One `MoE` a lane: the router copied, experts ``r * E / n`` to
    ``(r + 1) * E / n - 1`` on lane r, each on its lane's device. The
    shards are new parameters (each lane trains its own)."""
    n = len(lanes)
    e = moe.n_experts
    if e % n:
        raise ValueError(f"n_experts={e} not divisible by the {n} lane(s)")
    local = e // n
    out = []
    for r, dev in enumerate(lanes):
        shard = MoE(e, moe.w1.shape[1], moe.w1.shape[2], torch.Generator(), n_local=local)
        with torch.no_grad():
            shard.gate.copy_(moe.gate)
            for k in _EXPERT_LEAVES:
                getattr(shard, k).copy_(getattr(moe, k)[r * local:(r + 1) * local])
        out.append(shard.to(dev))
    return out


@dataclasses.dataclass
class Routing:
    """Top-1 routing of T tokens: each token's expert, slot and whether
    it was kept, the chosen expert's probability (`gate`), and the
    router's (balance, dropped) terms."""

    expert: torch.Tensor   # [T] int64
    slot: torch.Tensor     # [T] int64, the exclusive running count
    keep: torch.Tensor     # [T] bool, slot < capacity
    gate: torch.Tensor     # [T] float32
    capacity: int
    n_experts: int
    balance: torch.Tensor
    dropped: torch.Tensor

    def dispatch(self) -> torch.Tensor:
        """The reference's dense dispatch tensor [T, E, C] (float32)."""
        onehot = torch.nn.functional.one_hot(self.expert, self.n_experts).float()
        cell = torch.nn.functional.one_hot(self.slot.clamp(0, self.capacity - 1),
                                           self.capacity).float()
        return (onehot * self.keep.float()[:, None])[:, :, None] * cell[:, None, :]

    def combine(self) -> torch.Tensor:
        """The reference's combine tensor: dispatch times the gate."""
        return self.dispatch() * self.gate[:, None, None]


def _route(x: torch.Tensor, gate_w: torch.Tensor, capacity: int) -> Routing:
    """Top-1 routing of x [T, d] over the experts of `gate_w` (d, E), in
    the reference's arithmetic: float32 logits and softmax, argmax (first
    index on ties), slot by an exclusive cumsum of the one-hot rows."""
    t = x.shape[0]
    n_e = gate_w.shape[1]
    probs = torch.softmax(x.float() @ gate_w, dim=-1)             # [T, E]
    expert = torch.argmax(probs, dim=-1)                          # [T]
    onehot = torch.nn.functional.one_hot(expert, n_e).float()
    gate = (probs * onehot).sum(-1)
    slot = ((torch.cumsum(onehot, dim=0) - 1.0) * onehot).sum(-1)
    keep = slot < capacity
    # Switch load-balance loss: E * sum_e(frac_tokens_e * mean_prob_e)
    balance = n_e * torch.sum(onehot.mean(0) * probs.mean(0))
    dropped = 1.0 - keep.float().mean() if t else torch.zeros((), device=x.device)
    return Routing(expert=expert, slot=slot.long(), keep=keep, gate=gate, capacity=capacity,
                   n_experts=n_e, balance=balance, dropped=dropped)


def _gather(r: Routing, x: torch.Tensor) -> torch.Tensor:
    """The reference's ``einsum("tec,td->ecd", dispatch, x)``: every kept
    token's float32 row in its (expert, slot) cell, zeros elsewhere."""
    h = x.new_zeros(r.n_experts * r.capacity, x.shape[1], dtype=torch.float32)
    idx = (r.expert * r.capacity + r.slot)[r.keep]
    h = h.index_copy(0, idx, x.float()[r.keep])
    return h.reshape(r.n_experts, r.capacity, x.shape[1])


def _combine(r: Routing, out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The reference's ``einsum("tec,ecd->td", combine, out)``: each
    kept token's cell times its gate, zero for a dropped token."""
    cells = out.reshape(-1, out.shape[-1])[r.expert * r.capacity + r.slot.clamp(max=r.capacity - 1)]
    return (cells * (r.gate * r.keep.float())[:, None]).to(dtype)


def _expert_ffn(moe: MoE, h: torch.Tensor) -> torch.Tensor:
    """Stacked expert FFNs: h [E, C, d] -> [E, C, d], bf16 matmuls, the
    output bias in float32."""
    bf = torch.bfloat16
    z = torch.matmul(h.to(bf), moe.w1.to(bf)) + moe.b1[:, None, :].to(bf)
    out = torch.matmul(gelu(z), moe.w2.to(bf))
    return out.float() + moe.b2[:, None, :]


def _capacity(t: int, n_experts: int, capacity_factor: float) -> int:
    return max(1, int(t / n_experts * capacity_factor))


def moe_ff(moe: MoE, x: torch.Tensor, capacity_factor: float = 2.0
           ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Routed FF, a drop-in for a dense FF block, every expert local:
    x [T, d] -> (y [T, d], (balance, dropped))."""
    r = _route(x, moe.gate, _capacity(x.shape[0], moe.n_experts, capacity_factor))
    out = _expert_ffn(moe, _gather(r, x))
    return _combine(r, out, x.dtype), (r.balance, r.dropped)


def moe_apply(moe: MoE, x: torch.Tensor, capacity_factor: float = 2.0):
    """Single-device MoE: x [T, d] -> ([T, d], (balance, dropped))."""
    return moe_ff(moe, x, capacity_factor)


def moe_ff_lanes(shards: Sequence[MoE], xs: Sequence[torch.Tensor],
                 capacity_factor: float = 2.0) -> tuple[list[torch.Tensor], list[tuple]]:
    """Expert-parallel routed FF over the lanes: lane r routes its tokens
    xs[r] [T_r, d] over every expert (its own capacity), sends each
    expert's cells to the lane that owns it, runs its own experts, and
    takes its tokens' outputs back. Returns each lane's y and its
    (balance, dropped)."""
    n = len(shards)
    e = shards[0].n_experts
    if shards[0].w1.shape[0] * n != e:
        raise ValueError(f"expert shard {shards[0].w1.shape[0]} x {n} lanes != gate width {e}")
    routes = [_route(x, s.gate, _capacity(x.shape[0], e, capacity_factor))
              for s, x in zip(shards, xs)]
    hs = [_gather(r, x) for r, x in zip(routes, xs)]                    # [E, C, d] a lane
    # all_to_all(split 0, concat 1): lane j gets every lane's cells of its experts
    parts = [h.chunk(n, dim=0) for h in hs]
    recv = [torch.cat([parts[i][j].to(xs[j].device) for i in range(n)], dim=1)
            for j in range(n)]                                          # [E/n, n*C, d]
    outs = [_expert_ffn(s, h) for s, h in zip(shards, recv)]
    # all_to_all(split 1, concat 0): each token's cells back to its lane
    back = [o.chunk(n, dim=1) for o in outs]
    mine = [torch.cat([back[j][i].to(xs[i].device) for j in range(n)], dim=0)
            for i in range(n)]                                          # [E, C, d]
    ys = [_combine(r, o, x.dtype) for r, o, x in zip(routes, mine, xs)]
    return ys, [(r.balance, r.dropped) for r in routes]


def _lane_mean(vals: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """``lax.pmean`` of one scalar a lane, on `dev`."""
    return torch.stack([v.to(dev) for v in vals]).mean()


def make_ep_moe(mesh: Sequence[torch.device], n_experts: int, capacity_factor: float = 2.0,
                axis: str = EXPERT_AXIS):
    """The expert-parallel MoE over the lanes of `mesh`: ``fn(moe, x)``
    shards x [T, d] over the lanes and the experts of `moe` (`moe_shard`,
    a list of lane shards, or a whole `MoE` to shard at each call), and
    returns (y [T, d] on x's device, (balance, dropped)) with the two
    terms averaged over the lanes. T and n_experts must divide by the
    lane count. `axis` names the expert axis, as in the reference."""
    lanes = [torch.device(d) for d in mesh]
    n = len(lanes)
    if n_experts % n:
        raise ValueError(f"n_experts={n_experts} not divisible by the {n} lane(s)")

    def fn(moe, x):
        shards = moe if isinstance(moe, (list, tuple)) else moe_shard(moe, lanes)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} tokens not divisible by the {n} lane(s)")
        xs = [c.to(d) for c, d in zip(x.chunk(n, dim=0), lanes)]
        ys, aux = moe_ff_lanes(shards, xs, capacity_factor)
        y = torch.cat([v.to(x.device) for v in ys], dim=0)
        return y, (_lane_mean([a[0] for a in aux], x.device),
                   _lane_mean([a[1] for a in aux], x.device))

    return fn


__all__ = ["EXPERT_AXIS", "MoE", "Routing", "make_ep_moe", "moe_apply", "moe_ff",
           "moe_ff_lanes", "moe_init", "moe_pspecs", "moe_shard"]
