"""SAC-AE host-side helpers (counterpart of ``sheeprl_tpu/algos/sac_ae/utils.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import make_env

__all__ = ["AGGREGATOR_KEYS", "preprocess_obs", "prepare_obs", "test"]

#: the metrics the SAC-AE loop aggregates (JAX ``AGGREGATOR_KEYS``)
AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
    "Loss/reconstruction_loss",
}


def preprocess_obs(obs: torch.Tensor, bits: int = 8, uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bit reduction of pixel targets (arXiv:1807.03039): ``[0, 255]``
    pixels floored to ``bits`` bits, scaled to ``[0, 1)``, dithered by
    ``uniform / 2**bits`` (uniforms in ``[0, 1)`` of the pixels' shape) and
    centred."""
    bins = 2**bits
    if bits < 8:
        obs = torch.floor(obs / 2 ** (8 - bits))
    obs = obs / bins
    if uniform is not None:
        obs = obs + uniform / bins
    return obs - 0.5


def prepare_obs(obs: Dict[str, np.ndarray], cnn_keys: Sequence[str] = (), mlp_keys: Sequence[str] = (),
                num_envs: int = 1) -> Dict[str, np.ndarray]:
    """Pixels as float32 NHWC in ``[0, 1]``; vectors flattened per row."""
    out = {}
    for k in list(cnn_keys) + list(mlp_keys):
        v = np.asarray(obs[k], dtype=np.float32)
        out[k] = v.reshape(num_envs, *v.shape[-3:]) / 255.0 if k in cnn_keys else v.reshape(num_envs, -1)
    return out


def test(player, cfg: Any, device: "torch.device | str") -> Tuple[float, int]:
    """One greedy episode on a fresh env seeded with ``cfg.seed``; prints
    its return and returns it with the episode's step count."""
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    env = make_env(cfg, int(cfg.seed))
    obs = env.reset(seed=int(cfg.seed))[0]
    done, cumulative, steps = False, 0.0, 0
    while not done:
        prepared = prepare_obs(obs, cnn_keys, mlp_keys)
        action = player.get_actions({k: torch.from_numpy(v).to(device) for k, v in prepared.items()}, greedy=True)
        obs, reward, terminated, truncated, _ = env.step(action.float().cpu().numpy().reshape(-1))
        done = terminated or truncated
        cumulative += float(reward)
        steps += 1
    env.close()
    print("Test - Reward:", cumulative, flush=True)
    return cumulative, steps
