"""Dreamer V2 world-model loss (counterpart of
``sheeprl_tpu/algos/dreamer_v2/loss.py``)."""

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
    kl_balancing_alpha: float = 0.8,
    kl_free_nats: float = 0.0,
    kl_free_avg: bool = True,
    kl_regularizer: float = 1.0,
    pc: Optional[Any] = None,
    continue_targets: Optional[torch.Tensor] = None,
    discount_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eq. 2 of arXiv:2010.02193: the observation and reward negative
    log-likelihoods, KL balancing (``alpha`` on the prior's side, the
    posterior stop-gradient, ``1 - alpha`` on the posterior's) with free
    nats, taken after the mean over the batch with ``kl_free_avg`` and per
    element otherwise, scaled by ``kl_regularizer``, and with a continue
    head its negative log-likelihood times ``discount_scale_factor``. Logits
    shaped ``(..., S, D)``. Returns ``(loss, kl, kl_loss, reward_loss,
    observation_loss, continue_loss)``."""
    observation_loss = -sum(po[k].log_prob(observations[k]).mean() for k in po.keys())
    reward_loss = -pr.log_prob(rewards).mean()
    kl = lhs = kl_divergence(_categorical(posteriors_logits.detach()), _categorical(priors_logits))
    rhs = kl_divergence(_categorical(posteriors_logits), _categorical(priors_logits.detach()))
    if kl_free_avg:
        loss_lhs = torch.clamp(lhs.mean(), min=kl_free_nats)
        loss_rhs = torch.clamp(rhs.mean(), min=kl_free_nats)
    else:
        loss_lhs = torch.clamp(lhs, min=kl_free_nats).mean()
        loss_rhs = torch.clamp(rhs, min=kl_free_nats).mean()
    kl_loss = kl_balancing_alpha * loss_lhs + (1 - kl_balancing_alpha) * loss_rhs
    if pc is not None and continue_targets is not None:
        continue_loss = discount_scale_factor * -pc.log_prob(continue_targets).mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    rec_loss = kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss
    return rec_loss, kl.mean(), kl_loss, reward_loss, observation_loss, continue_loss
