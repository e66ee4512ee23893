"""Dreamer V1 losses (counterpart of ``sheeprl_tpu/algos/dreamer_v1/loss.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.distributions import kl_divergence

__all__ = ["reconstruction_loss", "actor_loss", "critic_loss"]


def actor_loss(discounted_lambda_values: torch.Tensor) -> torch.Tensor:
    """Eq. 7 of arXiv:1912.01603: the negative mean of the discounted
    lambda-returns, learnt by dynamics backpropagation alone."""
    return -torch.mean(discounted_lambda_values)


def critic_loss(qv: Any, lambda_values: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    """Eq. 8 of arXiv:1912.01603: the discount-weighted negative
    log-likelihood of the lambda-returns under the critic's ``qv``."""
    return -torch.mean(discount * qv.log_prob(lambda_values))


def reconstruction_loss(
    qo: Dict[str, Any],
    observations: Dict[str, torch.Tensor],
    qr: Any,
    rewards: torch.Tensor,
    posteriors_dist: Any,
    priors_dist: Any,
    kl_free_nats: float = 3.0,
    kl_regularizer: float = 1.0,
    qc: Optional[Any] = None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eq. 10 of arXiv:1912.01603: the observation and reward negative
    log-likelihoods and the plain Gaussian KL of posterior to prior, its
    batch mean held at least ``kl_free_nats`` (no balancing) and scaled by
    ``kl_regularizer``; with a continue head its negative log-likelihood
    times ``continue_scale_factor``. Returns ``(loss, kl, state_loss,
    reward_loss, observation_loss, continue_loss)``."""
    observation_loss = -sum(qo[k].log_prob(observations[k]).mean() for k in qo.keys())
    reward_loss = -qr.log_prob(rewards).mean()
    kl = kl_divergence(posteriors_dist, priors_dist).mean()
    state_loss = torch.clamp(kl, min=kl_free_nats)
    if qc is not None and continue_targets is not None:
        continue_loss = -continue_scale_factor * qc.log_prob(continue_targets).mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    rec_loss = kl_regularizer * state_loss + observation_loss + reward_loss + continue_loss
    return rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss
