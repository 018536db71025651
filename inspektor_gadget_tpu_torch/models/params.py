"""The scorers' layers and activation, and the carry of their weights
and Adam state from and to the JAX package.

Each scorer's module tree mirrors the reference's parameter pytree:
submodule and parameter names are its dict keys, ``nn.ModuleList``
indices its list indices, and a dense layer's ``w`` is (fan_in,
fan_out) as the reference stores it. So one pair of functions,
`params_from_numpy` and `params_to_numpy`, carries every family's
weights by dotted name ("layers.0.qkv.w"), and `adam_state_from_optax`
carries optax's ``mu``, ``nu`` and ``count`` the same way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """x @ w + b, w (fan_in, fan_out) drawn as normal * `std`, b zero."""

    def __init__(self, fan_in: int, fan_out: int, std: float, gen: torch.Generator) -> None:
        super().__init__()
        self.w = nn.Parameter(torch.randn(fan_in, fan_out, generator=gen) * std)
        self.b = nn.Parameter(torch.zeros(fan_out))

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """The reference's ``_dense``/``_layer``: x, w and b cast to
        `dtype` (x's own by default), the matmul, then the bias add, both
        in that type."""
        dt = dtype or x.dtype
        return x.to(dt) @ self.w.to(dt) + self.b.to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class Norm(nn.Module):
    """Layer-norm gain and bias (ones, zeros)."""

    def __init__(self, d: int) -> None:
        super().__init__()
        self.g = nn.Parameter(torch.ones(d))
        self.b = nn.Parameter(torch.zeros(d))


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for key, sub in items:
        out.update(_flatten(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def _as_lists(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_as_lists(node[str(i)]) for i in range(len(node))]
    return {k: _as_lists(v) for k, v in node.items()}


def _by_name(model: nn.Module, tree: Any, what: str) -> list[tuple[nn.Parameter, np.ndarray]]:
    flat = _flatten(tree)
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise ValueError(f"{what} names differ from the model's: "
                         f"{sorted(set(flat) ^ set(params))}")
    for name, p in params.items():
        if flat[name].shape != tuple(p.shape):
            raise ValueError(f"{what} {name}: shape {flat[name].shape}, model {tuple(p.shape)}")
    return [(p, flat[name]) for name, p in params.items()]


def params_from_numpy(scorer: Any, tree: Any) -> None:
    """Load the reference's parameter pytree (nested dicts and lists of
    arrays) into `scorer`'s model, in place."""
    with torch.no_grad():
        for p, a in _by_name(scorer.model, tree, "params"):
            p.copy_(torch.from_numpy(np.asarray(a, np.float32)))


def params_to_numpy(scorer: Any) -> Any:
    """`scorer`'s weights as the reference's pytree of numpy arrays."""
    root: dict = {}
    for name, p in scorer.model.named_parameters():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().cpu().numpy().copy()
    return _as_lists(root)


def adam_state_from_optax(scorer: Any, mu: Any, nu: Any, count: int) -> None:
    """Set `scorer`'s Adam/AdamW state from optax's ``ScaleByAdamState``
    (``mu``, ``nu`` pytrees like the params, ``count`` steps taken), so
    the next step continues the reference's."""
    opt = scorer.opt
    nus = {id(p): a for p, a in _by_name(scorer.model, nu, "nu")}
    for p, m in _by_name(scorer.model, mu, "mu"):
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.asarray(m, np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.asarray(nus[id(p)], np.float32)).to(p.device),
        }


# -- scorer checkpoint leaves -------------------------------------------------
# The reference's AE and VAE scorers flatten as (params, optax Adam state,
# [the VAE's PRNG key], steps): the parameters in sorted-key order, then
# Adam's count, mu and nu, then the key and the step count. The port
# writes and reads that order, so either package resumes the other's AE
# or VAE. The reference's seq scorer is not a pytree (its checkpoint
# holds one pickled object); the port's seq file has the same layout as
# an AE's, which only the port reads.

def _sorted_names(tree: Any, prefix: str = "") -> list[str]:
    """Dotted leaf names in jax's flatten order: dict keys sorted, list
    items in order."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [prefix]
    out: list[str] = []
    for key, sub in items:
        out += _sorted_names(sub, f"{prefix}.{key}" if prefix else str(key))
    return out


def scorer_leaves(scorer: Any) -> list[np.ndarray]:
    """`scorer`'s state as the reference scorer's checkpoint leaves."""
    names = _sorted_names(params_to_numpy(scorer))
    params = dict(scorer.model.named_parameters())
    state = [scorer.opt.state.get(params[n], {}) for n in names]

    def moment(key: str) -> list[np.ndarray]:
        return [s[key].detach().cpu().numpy().copy() if key in s
                else np.zeros(tuple(params[n].shape), np.float32)
                for n, s in zip(names, state)]

    count = int(state[0]["step"]) if state and "step" in state[0] else 0
    out = [params[n].detach().cpu().numpy().copy() for n in names]
    out += [np.asarray(count, np.int32), *moment("exp_avg"), *moment("exp_avg_sq")]
    if hasattr(scorer, "gen"):  # the VAE: the reference's PRNG key
        out.append(np.zeros(2, np.uint32))
    out.append(np.asarray(scorer.steps, np.int32))
    return out


def scorer_leaf_names(scorer: Any) -> list[str]:
    """The name of each of `scorer_leaves(scorer)`: the parameters by
    their dotted names, ``count``, ``mu.<name>`` and ``nu.<name>`` (Adam's
    moments), the VAE's ``key``, then ``steps``."""
    names = _sorted_names(params_to_numpy(scorer))
    out = names + ["count"] + [f"mu.{n}" for n in names] + [f"nu.{n}" for n in names]
    return out + (["key"] if hasattr(scorer, "gen") else []) + ["steps"]


def scorer_from_leaves(scorer: Any, leaves) -> None:
    """Load checkpoint leaves (`scorer_leaves`' layout) into `scorer`:
    weights, Adam state and step count. The VAE's PRNG key is not
    carried (the port's noise generator goes on with its own draws)."""
    names = _sorted_names(params_to_numpy(scorer))
    n = len(names)
    extra = 1 if hasattr(scorer, "gen") else 0
    if len(leaves) != 3 * n + 2 + extra:
        raise ValueError(f"scorer checkpoint has {len(leaves)} leaves, expected "
                         f"{3 * n + 2 + extra}")
    params_from_numpy(scorer, dict(zip(names, leaves[:n])))
    count = int(np.asarray(leaves[n]))
    if count:
        adam_state_from_optax(scorer, dict(zip(names, leaves[n + 1:2 * n + 1])),
                              dict(zip(names, leaves[2 * n + 1:3 * n + 1])), count)
    scorer.steps = int(np.asarray(leaves[-1]))
