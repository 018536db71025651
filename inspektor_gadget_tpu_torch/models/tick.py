"""The anomaly plane's harvest tick, for the three scorer families.

The tpusketch operator (``inspektor_gadget_tpu/operators/tpusketch.py``,
``anomaly-model=ae|vae|seq``) runs, once per harvest, one optimizer step
on every container's data and then scores every container
(``:1905-1919``; for seq, ``:1540-1560``). `harvest_tick` is that tick;
`seq_window_matrix` builds the seq scorer's token matrix from the
containers' windows as the operator does.
"""

from __future__ import annotations

from collections.abc import Iterable, Sequence

import numpy as np
import torch

from .autoencoder import AnomalyScorer, ae_score, ae_train_step, normalize_counts
from .seqmodel import SeqScorer, seq_score, seq_train_step
from .vae import VAEScorer, vae_score, vae_train_step

Scorer = AnomalyScorer | VAEScorer | SeqScorer


def seq_window_matrix(windows: Iterable[Sequence[int]], window: int) -> tuple[np.ndarray, int] | None:
    """The operator's token matrix (``tpusketch.py:1544-1557``) and its
    number of real rows, or None when no container has 4 tokens yet.

    Containers with fewer than 4 tokens are left out; the rest fill the
    first rows in order. The width is the longest window rounded up to a
    power of two, at most `window`; the row count is rounded up to a power
    of two. Short rows are padded, and filler rows filled, with -1, which
    the loss and the score mask out."""
    ready = [s for s in windows if len(s) >= 4]
    if not ready:
        return None
    w = max(len(s) for s in ready)
    w = min(1 << (w - 1).bit_length(), window)
    rows = 1 << (len(ready) - 1).bit_length() if len(ready) > 1 else 1
    mat = np.full((rows, w), -1, dtype=np.int32)
    for i, s in enumerate(ready):
        mat[i, :len(s)] = s
    return mat, len(ready)


def harvest_tick(scorer: Scorer, batch, attn: str = "flash",
                 eps: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One tick: one optimizer step on `batch`, then every row's score.
    Returns (the loss before the step, the scores).

    `batch` is, for ae and vae, the (containers, input_dim) event-count
    matrix (normalised here, as the operator does) and, for seq, the
    token matrix of `seq_window_matrix`, whose attention goes through
    `attn` (``flash``: K3 on the card). `eps` is the VAE's step noise
    (default: the next draw of its generator)."""
    batch = torch.as_tensor(batch, device=scorer.device)
    if isinstance(scorer, SeqScorer):
        scorer, loss = seq_train_step(scorer, batch, attn)
        return loss, seq_score(scorer, batch, attn)
    x = normalize_counts(batch)
    if isinstance(scorer, VAEScorer):
        scorer, loss = vae_train_step(scorer, x, eps)
        return loss, vae_score(scorer, x)
    scorer, loss = ae_train_step(scorer, x)
    return loss, ae_score(scorer, x)
