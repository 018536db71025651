"""The anomaly scorers (autoencoder, VAE, sequence LM), their harvest
tick, and the carry of their weights from and to the JAX package."""

from .autoencoder import (AEConfig, AnomalyScorer, TPScorer, ae_apply, ae_apply_tp, ae_gather_tp,
                          ae_init,
                          ae_loss, ae_loss_tp, ae_param_pspecs, ae_score, ae_score_tp,
                          ae_shard_tp, ae_train_step, ae_train_step_tp, normalize_counts)
from .params import (adam_state_from_optax, params_from_numpy, params_to_numpy,
                     scorer_from_leaves, scorer_leaf_names, scorer_leaves)
from .seqmodel import (SeqConfig, SeqScorer, make_ep_train_step, make_sp_train_step,
                       seq_apply, seq_init, seq_loss, seq_param_pspecs, seq_score,
                       seq_train_step, tokens_from_keys)
from .tick import harvest_tick, seq_window_matrix
from .vae import VAEConfig, VAEScorer, vae_init, vae_loss, vae_score, vae_train_step

__all__ = [
    "AEConfig", "AnomalyScorer", "ae_apply", "ae_init", "ae_loss", "ae_score",
    "ae_train_step", "normalize_counts",
    "TPScorer", "ae_apply_tp", "ae_gather_tp", "ae_loss_tp", "ae_param_pspecs", "ae_score_tp",
    "ae_shard_tp", "ae_train_step_tp",
    "adam_state_from_optax", "params_from_numpy", "params_to_numpy",
    "scorer_from_leaves", "scorer_leaf_names", "scorer_leaves",
    "SeqConfig", "SeqScorer", "seq_apply", "seq_init", "seq_loss", "seq_score",
    "seq_train_step", "tokens_from_keys", "make_sp_train_step", "make_ep_train_step",
    "seq_param_pspecs",
    "harvest_tick", "seq_window_matrix",
    "VAEConfig", "VAEScorer", "vae_init", "vae_loss", "vae_score", "vae_train_step",
]
