"""SAC losses ("Soft Actor-Critic Algorithms and Applications",
arXiv:1812.05905; counterpart of ``sheeprl_tpu/algos/sac/loss.py``)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["policy_loss", "critic_loss", "entropy_loss"]


def policy_loss(alpha: torch.Tensor, logprobs: torch.Tensor, qf_values: torch.Tensor) -> torch.Tensor:
    # Eq. 7
    return torch.mean(alpha * logprobs - qf_values)


def critic_loss(qf_values: torch.Tensor, next_qf_value: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 5: the sum over the ``(batch, n)`` ensemble's critics of each
    one's mean squared error against the shared TD target; with PER each
    sample's error is weighted by its ``(batch,)`` importance weight first
    (the JAX package's resident step, which equals Eq. 5 at weight 1)."""
    err2 = (qf_values - next_qf_value) ** 2
    if weights is not None:
        err2 = weights[:, None] * err2
    return torch.sum(torch.mean(err2, dim=0))


def entropy_loss(log_alpha: torch.Tensor, logprobs: torch.Tensor, target_entropy: float) -> torch.Tensor:
    # Eq. 17
    return torch.mean(-log_alpha * (logprobs + target_entropy))
