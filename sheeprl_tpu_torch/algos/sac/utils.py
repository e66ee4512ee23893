"""SAC host-side helpers (counterpart of ``sheeprl_tpu/algos/sac/utils.py``)."""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import make_env

__all__ = ["AGGREGATOR_KEYS", "prepare_obs", "test"]

#: the metrics the SAC loop aggregates (JAX ``AGGREGATOR_KEYS``)
AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss"}


def prepare_obs(
    obs: Dict[str, np.ndarray], mlp_keys: Sequence[str], num_envs: int = 1, device: "torch.device | str" = "cpu"
) -> torch.Tensor:
    """Concatenate the vector keys into one float32 ``(num_envs, obs_dim)``
    tensor on ``device``."""
    flat = np.concatenate([np.asarray(obs[k], dtype=np.float32) for k in mlp_keys], axis=-1)
    return torch.from_numpy(flat.reshape(num_envs, -1)).to(device)


def test(player, cfg: Any, device: "torch.device | str") -> Tuple[float, int]:
    """One greedy episode on a fresh env seeded with ``cfg.seed``; prints
    its return and returns it with the episode's step count."""
    env = make_env(cfg, int(cfg.seed))
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    obs = env.reset(seed=int(cfg.seed))[0]
    done, cumulative, steps = False, 0.0, 0
    while not done:
        action = player.get_actions(prepare_obs(obs, mlp_keys, 1, device), greedy=True)
        obs, reward, terminated, truncated, _ = env.step(action.float().cpu().numpy().reshape(-1))
        done = terminated or truncated
        cumulative += float(reward)
        steps += 1
    env.close()
    print("Test - Reward:", cumulative, flush=True)
    return cumulative, steps
