"""P2E-DV3 helpers (counterpart of ``sheeprl_tpu/algos/p2e_dv3/utils.py``):
the metric keys both P2E loops aggregate; obs preparation, ``Moments``, the
lambda-returns and the test episode are DreamerV3's."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v3.utils import (  # noqa: F401
    compute_lambda_values,
    init_moments,
    moments_update,
    prepare_obs,
    test,
)

#: the metrics the P2E loops aggregate (JAX ``AGGREGATOR_KEYS``)
AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/policy_loss_task",
    "Loss/value_loss_task",
    "Loss/policy_loss_exploration",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "Loss/ensemble_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Rewards/intrinsic",
    "Values_exploration/predicted_values",
    "Values_exploration/lambda_values",
    "Loss/value_loss_intrinsic",
    "Loss/value_loss_extrinsic",
}
