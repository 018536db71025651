"""Pipeline parallelism: the GPipe microbatch schedule over the lanes of a
stage axis (PyTorch port of ``inspektor_gadget_tpu/parallel/pipeline.py``).

- The model is S identical residual MLP blocks, their weights stacked on
  a leading stage axis (`pp_block_init`); stage s runs on lane s of the
  mesh (`parallel.mesh`), with block s's weights copied to that lane's
  device (`pp_pspecs` names the placement).
- `make_pp_forward` runs the reference's tick schedule: M + S - 1 ticks
  for M microbatches. Each tick, stage 0 takes the next microbatch,
  every stage applies its block, and one hop shifts each stage's output
  to the next stage's lane; the last stage keeps tick t's output as
  microbatch t - (S - 1). Bubble ticks compute on zeros, as in the
  reference, and nothing reads them.
- The schedule is differentiable: `make_pp_train_step` backpropagates
  through the ticks (each block's gradient reaches only its own slice
  of the stacked weights) and trains the linear head on the pipeline's
  output.

The blocks' matmuls run in bf16, their residual and biases in float32,
as in the reference.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..models.params import gelu

STAGE_AXIS = "stage"
_LEAVES = ("w1", "b1", "w2", "b2")


def pp_block_init(seed: int | torch.Generator, n_stages: int, d_model: int, d_ff: int,
                  device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """S stacked residual MLP blocks drawn from `seed` on the CPU, then
    moved to `device`: w1 (S, d, f), b1 (S, f), w2 (S, f, d), b2 (S, d)."""
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    s = (2.0 / (d_model + d_ff)) ** 0.5
    params = {
        "w1": torch.randn(n_stages, d_model, d_ff, generator=gen) * s,
        "b1": torch.zeros(n_stages, d_ff),
        "w2": torch.randn(n_stages, d_ff, d_model, generator=gen) * s,
        "b2": torch.zeros(n_stages, d_model),
    }
    return {k: v.to(device) for k, v in params.items()}


def pp_pspecs(axis: str = STAGE_AXIS) -> dict[str, tuple]:
    """Every leaf split on its leading (stage) axis over `axis`."""
    return {k: (axis,) for k in _LEAVES}


def _block(w1, b1, w2, b2, x):
    """One residual MLP block: bf16 matmuls, float32 residual and bias."""
    bf = torch.bfloat16
    h = gelu(x.to(bf) @ w1.to(bf) + b1.to(bf))
    return x + (h @ w2.to(bf)).float() + b2


def pp_reference(params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Sequential one-device forward through every block (ground truth
    for the pipeline)."""
    for s in range(params["w1"].shape[0]):
        x = _block(*(params[k][s] for k in _LEAVES), x)
    return x


def make_pp_forward(mesh: Sequence[torch.device], axis: str = STAGE_AXIS):
    """The pipelined forward over the lanes of `mesh` (one stage a lane):
    ``fwd(params, x)`` takes the stacked blocks and x [M, mb, d]
    (microbatches) and returns [M, mb, d] on x's device. `axis` names
    the stage axis, as in the reference."""
    lanes = [torch.device(d) for d in mesh]
    n = len(lanes)

    def fwd(params, x):
        if params["w1"].shape[0] != n:
            raise ValueError(f"{params['w1'].shape[0]} stages for {n} lane(s)")
        m, mb, d = x.shape
        blocks = [[params[k][s].to(dev) for k in _LEAVES] for s, dev in enumerate(lanes)]
        act = [torch.zeros(mb, d, dtype=torch.float32, device=dev) for dev in lanes]
        outs: list[torch.Tensor | None] = [None] * m
        for t in range(m + n - 1):
            act[0] = x[min(t, m - 1)].to(lanes[0])
            out = [_block(*blocks[s], act[s]) for s in range(n)]
            if t - (n - 1) >= 0:
                outs[t - (n - 1)] = out[n - 1]
            # one hop: stage s's output to stage s + 1's lane
            act = [out[(s - 1) % n].to(lanes[s]) for s in range(n)]
        return torch.stack([o.to(x.device) for o in outs])

    return fwd


def make_pp_train_step(mesh: Sequence[torch.device], lr: float = 1e-3, axis: str = STAGE_AXIS):
    """The pipeline-parallel train step on (stacked blocks + a linear
    head): MSE of ``fwd(params, x) @ head`` to y, one SGD step.
    ``step(params, head, x, y) -> (params, head, loss)`` returns new
    tensors."""
    fwd = make_pp_forward(mesh, axis)

    def step(params, head, x, y):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        h = head.detach().requires_grad_()
        loss = torch.mean((fwd(leaves, x) @ h - y) ** 2)
        grads = torch.autograd.grad(loss, [*leaves.values(), h])
        with torch.no_grad():
            new = {k: v - lr * g for (k, v), g in zip(leaves.items(), grads)}
            return new, h - lr * grads[-1], loss.detach()

    return step


__all__ = ["STAGE_AXIS", "make_pp_forward", "make_pp_train_step", "pp_block_init",
           "pp_pspecs", "pp_reference"]
