"""A2C agent (counterpart of ``sheeprl_tpu/algos/a2c/agent.py``): the PPO
network restricted to vector observations, so the module, its player and
its functional forwards are PPO's; only the losses and the update schedule
differ (:mod:`sheeprl_tpu_torch.algos.a2c.a2c`)."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, PPOPlayer, forward_with_actions, sample_actions
from sheeprl_tpu_torch.algos.ppo.agent import build_agent as build_ppo_agent

__all__ = ["A2CAgent", "A2CPlayer", "build_agent", "forward_with_actions", "sample_actions"]

A2CAgent = PPOAgent
A2CPlayer = PPOPlayer


def build_agent(
    cfg: Any,
    actions_dim: Sequence[int],
    is_continuous: bool,
    obs_spaces: Mapping[str, Mapping[str, Any]],
    device: "torch.device | str" = "cpu",
    agent_state: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[A2CAgent, A2CPlayer]:
    """PPO's ``build_agent`` over the MLP keys alone (the JAX A2C agent is
    built with ``cnn_keys=()``)."""
    if list(cfg.algo.cnn_keys.encoder):
        raise ValueError(f"the A2C agent takes vector observations only; got cnn keys {list(cfg.algo.cnn_keys.encoder)}")
    return build_ppo_agent(cfg, actions_dim, is_continuous, obs_spaces, device, agent_state, generator)
