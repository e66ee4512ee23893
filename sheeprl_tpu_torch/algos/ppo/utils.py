"""PPO host-side helpers (counterpart of ``sheeprl_tpu/algos/ppo/utils.py``)."""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import env_actions
from sheeprl_tpu_torch.envs import make_env

__all__ = ["AGGREGATOR_KEYS", "action_spec", "prepare_obs", "test"]

#: the metrics the PPO loop aggregates (JAX ``AGGREGATOR_KEYS``)
AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss", "Loss/entropy_loss"}


def action_spec(spaces: Any) -> Tuple[Tuple[int, ...], bool]:
    """``(actions_dim, is_continuous)`` from a run config's ``spaces``
    block: a Box space's shape, or the sizes of its discrete heads."""
    actions = spaces["actions"]
    if actions.get("continuous"):
        return tuple(int(d) for d in actions["shape"]), True
    return tuple(int(d) for d in actions["n"]), False


def prepare_obs(
    obs: Dict[str, np.ndarray], cnn_keys: Sequence[str] = (), num_envs: int = 1, device: "torch.device | str" = "cpu"
) -> Dict[str, torch.Tensor]:
    """Host observations -> float32 tensors on ``device`` shaped
    ``(num_envs, ...)``: pixel keys (NHWC) to ``x / 255 - 0.5``, vector
    keys flattened."""
    out = {}
    for k, v in obs.items():
        v = np.asarray(v, dtype=np.float32)
        if k in cnn_keys:
            v = v.reshape(num_envs, *v.shape[-3:]) / 255.0 - 0.5
        else:
            v = v.reshape(num_envs, -1)
        out[k] = torch.from_numpy(v).to(device)
    return out


def test(player, cfg: Any, device: "torch.device | str") -> Tuple[float, int]:
    """One greedy episode on a fresh env seeded with ``cfg.seed``; prints
    its return and returns it with the episode's step count. A continuous
    action goes to the env as the mean, a discrete one as each head's
    index."""
    env = make_env(cfg, int(cfg.seed))
    obs_keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    obs = env.reset(seed=int(cfg.seed))[0]
    done, cumulative, steps = False, 0.0, 0
    while not done:
        prepared = prepare_obs({k: obs[k] for k in obs_keys}, cfg.algo.cnn_keys.encoder, 1, device)
        actions = player.get_actions(prepared, greedy=True)
        real = env_actions(actions, player.agent.is_continuous)
        real = (real.float() if real.is_floating_point() else real).cpu().numpy().reshape(-1)
        obs, reward, terminated, truncated, _ = env.step(real[0] if real.size == 1 else real)
        done = terminated or truncated
        cumulative += reward
        steps += 1
    env.close()
    print("Test - Reward:", cumulative, flush=True)
    return float(cumulative), steps
