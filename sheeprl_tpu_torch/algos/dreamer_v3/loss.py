"""DreamerV3 world-model loss (counterpart of
``sheeprl_tpu/algos/dreamer_v3/loss.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.distributions import Independent, OneHotCategoricalStraightThrough, kl_divergence

__all__ = ["reconstruction_loss"]


def _categorical(logits: torch.Tensor) -> Independent:
    return Independent(OneHotCategoricalStraightThrough(logits), 1)


def reconstruction_loss(
    po: Dict[str, Any],
    observations: Dict[str, torch.Tensor],
    pr: Any,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,
    posteriors_logits: torch.Tensor,
    kl_dynamic: float = 0.5,
    kl_representation: float = 0.1,
    kl_free_nats: float = 1.0,
    kl_regularizer: float = 1.0,
    pc: Optional[Any] = None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eq. 5 of arXiv:2301.04104 with KL balancing and free nats; logits
    shaped ``(..., S, D)``. Returns ``(loss, kl, kl_loss, reward_loss,
    observation_loss, continue_loss)``, each a mean."""
    observation_loss = -sum(po[k].log_prob(observations[k]) for k in po.keys())
    reward_loss = -pr.log_prob(rewards)
    kl = kl_divergence(_categorical(posteriors_logits.detach()), _categorical(priors_logits))
    dyn_loss = kl_dynamic * torch.clamp(kl, min=kl_free_nats)
    repr_loss = kl_divergence(_categorical(posteriors_logits), _categorical(priors_logits.detach()))
    repr_loss = kl_representation * torch.clamp(repr_loss, min=kl_free_nats)
    kl_loss = dyn_loss + repr_loss
    if pc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -pc.log_prob(continue_targets)
    else:
        continue_loss = torch.zeros_like(reward_loss)
    rec_loss = torch.mean(kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss)
    return rec_loss, kl.mean(), kl_loss.mean(), reward_loss.mean(), observation_loss.mean(), continue_loss.mean()
