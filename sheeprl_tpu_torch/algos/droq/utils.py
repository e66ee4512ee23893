"""DroQ host-side helpers (counterpart of ``sheeprl_tpu/algos/droq/utils.py``:
the evaluation protocol and the observation preparation are SAC's)."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test

__all__ = ["AGGREGATOR_KEYS", "prepare_obs", "test"]

#: the metrics the DroQ loop aggregates (JAX ``AGGREGATOR_KEYS``)
AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss"}
