"""PPO losses (counterpart of ``sheeprl_tpu/algos/ppo/loss.py``)."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["policy_loss", "value_loss", "entropy_loss"]

Coef = Union[torch.Tensor, float]


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    reduction = reduction.lower()
    if reduction == "none":
        return x
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    raise ValueError(f"Unrecognized reduction: {reduction}")


def policy_loss(
    new_logprobs: torch.Tensor, logprobs: torch.Tensor, advantages: torch.Tensor, clip_coef: Coef, reduction: str = "mean"
) -> torch.Tensor:
    """Clipped surrogate objective, eq. (7) of the PPO paper."""
    ratio = torch.exp(new_logprobs - logprobs)
    pg_loss1 = advantages * ratio
    pg_loss2 = advantages * torch.clamp(ratio, 1 - clip_coef, 1 + clip_coef)
    return _reduce(-torch.minimum(pg_loss1, pg_loss2), reduction)


def value_loss(
    new_values: torch.Tensor,
    old_values: torch.Tensor,
    returns: torch.Tensor,
    clip_coef: Coef,
    clip_vloss: bool,
    reduction: str = "mean",
) -> torch.Tensor:
    if not clip_vloss:
        values_pred = new_values
    else:
        values_pred = old_values + torch.clamp(new_values - old_values, -clip_coef, clip_coef)
    return _reduce((values_pred - returns) ** 2, reduction)


def entropy_loss(entropy: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _reduce(-entropy, reduction)
