"""Dreamer V1 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v1/utils.py``):
its lambda-returns and metric keys; the obs preparation and the test
episode are Dreamer V2's."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.utils import prepare_obs, test

__all__ = ["AGGREGATOR_KEYS", "compute_lambda_values", "prepare_obs", "test"]

#: the metrics the Dreamer V1 loop aggregates (JAX ``AGGREGATOR_KEYS``)
AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/post_entropy",
    "State/prior_entropy",
    "State/kl",
    "Params/exploration_amount",
}


def compute_lambda_values(rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor,
                          last_values: torch.Tensor, lmbda: float = 0.95) -> torch.Tensor:
    """V1's lambda-returns, a reverse loop in float32 that keeps the
    gradients: H rows of ``(H, B, 1)`` inputs give H - 1 returns; the next
    state's value enters as ``values[t + 1] * (1 - lmbda)``, except at the
    last step, where ``last_values`` (``(B, 1)``) enters whole."""
    rewards, values, continues = (t.to(torch.float32) for t in (rewards, values, continues))
    last_values = last_values.to(torch.float32)
    horizon = rewards.shape[0]
    next_values = torch.cat([values[1:horizon - 1] * (1 - lmbda), last_values[None]], dim=0)
    delta = rewards[:horizon - 1] + next_values * continues[:horizon - 1]
    agg = torch.zeros_like(last_values)
    out = [None] * (horizon - 1)
    for t in reversed(range(horizon - 1)):
        agg = delta[t] + lmbda * continues[t] * agg
        out[t] = agg
    return torch.stack(out, dim=0)
