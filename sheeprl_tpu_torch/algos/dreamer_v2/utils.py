"""Dreamer V2 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v2/utils.py``)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs
from sheeprl_tpu_torch.envs import make_env

__all__ = ["AGGREGATOR_KEYS", "compute_lambda_values", "prepare_obs", "test"]

#: the metrics the Dreamer V2 loop aggregates (JAX ``AGGREGATOR_KEYS``)
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
}


def compute_lambda_values(
    rewards: torch.Tensor,
    values: torch.Tensor,
    continues: torch.Tensor,
    bootstrap: Optional[torch.Tensor] = None,
    lmbda: float = 0.95,
) -> torch.Tensor:
    """V2's TD(lambda) returns, a reverse loop over the horizon in float32.
    ``continues`` already carry gamma; ``bootstrap`` (``(1, B, 1)``, zeros
    when None) is the value of the state after the last row. All inputs
    ``(H, B, 1)``."""
    rewards, values, continues = (t.to(torch.float32) for t in (rewards, values, continues))
    bootstrap = torch.zeros_like(values[-1:]) if bootstrap is None else bootstrap.to(torch.float32)
    next_values = torch.cat([values[1:], bootstrap], dim=0)
    inputs = rewards + continues * next_values * (1 - lmbda)
    nxt = bootstrap[0]
    out = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        nxt = inputs[t] + continues[t] * lmbda * nxt
        out[t] = nxt
    return torch.stack(out, dim=0)


@torch.no_grad()
def test(player: Any, cfg: Any, device: "torch.device | str", greedy: bool = True) -> Tuple[float, int]:
    """One episode of ``player`` (a :class:`~sheeprl_tpu_torch.algos.dreamer_v2.agent.PlayerDV2`,
    or Dreamer V1's player) on a fresh env seeded with ``cfg.seed``, batch 1, its draws from a
    generator of its own seeded with ``cfg.seed`` (the training generator is
    left as it is, and an evaluation of the checkpoint on the same device
    replays the episode); prints its return and returns it with the
    episode's step count. Greedy by default, as the JAX package tests a V2
    agent."""
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    env = make_env(cfg, int(cfg.seed))
    obs = env.reset(seed=int(cfg.seed))[0]
    generator = torch.Generator(device=device).manual_seed(int(cfg.seed))
    episode_player = type(player)(player.world_model, player.actor, 1, generator, player.expl_amount)
    episode_player.init_states()
    done, cumulative, steps = False, 0.0, 0
    while not done:
        prepared = prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys=cnn_keys, num_envs=1)
        acts = episode_player.get_actions({k: torch.from_numpy(v).to(device) for k, v in prepared.items()}, greedy)
        if episode_player.actor.is_continuous:
            real = torch.cat(acts, dim=-1).float().cpu().numpy().reshape(-1)
        else:
            real = torch.stack([a.argmax(dim=-1) for a in acts], dim=-1).cpu().numpy().reshape(-1)
        obs, reward, terminated, truncated, _ = env.step(real[0] if real.size == 1 else real)
        done = terminated or truncated or bool(cfg.get("dry_run", False))
        cumulative += float(reward)
        steps += 1
    env.close()
    print("Test - Reward:", cumulative, flush=True)
    return cumulative, steps
