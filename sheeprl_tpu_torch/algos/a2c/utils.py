"""A2C host-side helpers (counterpart of ``sheeprl_tpu/algos/a2c/utils.py``):
the evaluation episode and the observation preparation are PPO's."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.ppo.utils import action_spec, prepare_obs, test

__all__ = ["AGGREGATOR_KEYS", "action_spec", "prepare_obs", "test"]

#: the metrics the A2C loop aggregates (JAX ``AGGREGATOR_KEYS``)
AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss"}
