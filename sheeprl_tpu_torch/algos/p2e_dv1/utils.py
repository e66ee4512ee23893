"""P2E-DV1 helpers (counterpart of ``sheeprl_tpu/algos/p2e_dv1/utils.py``):
the metric keys both P2E-DV1 loops aggregate; the lambda-returns, obs
preparation and the test episode are Dreamer V1's."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v1.utils import compute_lambda_values, prepare_obs, test  # noqa: F401

#: the metrics the P2E-DV1 loops aggregate (JAX ``AGGREGATOR_KEYS``)
AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/policy_loss_task",
    "Loss/value_loss_task",
    "Loss/policy_loss_exploration",
    "Loss/value_loss_exploration",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "Loss/ensemble_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Params/exploration_amount",
    "Rewards/intrinsic",
}
