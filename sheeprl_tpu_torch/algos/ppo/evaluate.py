"""PPO evaluation and its stateless serving policy builder (counterpart of
``sheeprl_tpu/algos/ppo/evaluate.py``, ``evaluate_ppo`` and
``serve_policy_ppo``). Registered for ``ppo``; the decoupled, Anakin and
Sebulba names wait for their trainers."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import build_agent, env_actions, sample_actions
from sheeprl_tpu_torch.algos.ppo.utils import action_spec, prepare_obs, test
from sheeprl_tpu_torch.ops import counter_normal, counter_uniform
from sheeprl_tpu_torch.serve.policy import ServePolicy
from sheeprl_tpu_torch.utils.registry import register_evaluation, register_policy_builder

__all__ = ["evaluate_ppo", "serve_policy_ppo"]


@register_evaluation(algorithms=["ppo"])
def evaluate_ppo(cfg: Any, state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """One greedy test episode of the checkpoint's agent; its return and
    step count."""
    actions_dim, is_continuous = action_spec(cfg.spaces)
    _, player = build_agent(cfg, actions_dim, is_continuous, cfg.spaces.obs, device, state["agent"])
    reward, steps = test(player, cfg, device)
    return {"reward": reward, "steps": steps}


@register_policy_builder(algorithms=["ppo"])
def serve_policy_ppo(cfg: Any, state: Optional[Dict[str, Any]], device: torch.device) -> ServePolicy:
    """A :class:`ServePolicy` over the PPO agent of ``state`` (None serves
    the seeded init) on ``device``. The programs are ``sample_actions``, the
    math of the offline ``test`` loop, with its host conversion (the argmax
    of each head's one-hot; a continuous action as it is) moved inside.
    Sample mode draws head ``i``'s Gumbel noise from stream ``i`` of each
    row's seed and counter; a continuous head draws ``mean + std * eps``
    with ``eps`` the standard normals of stream 0 (``counter_normal``), so a
    batched row equals the row alone."""
    device = torch.device(device)
    actions_dim, is_continuous = action_spec(cfg.spaces)
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)

    def build(agent_state):
        agent, _ = build_agent(cfg, actions_dim, is_continuous, cfg.spaces.obs, device, agent_state)
        return agent.requires_grad_(False)

    obs_spec = {}
    for k in cnn_keys:
        obs_spec[k] = (tuple(int(d) for d in cfg.spaces.obs[k].shape[-3:]), np.float32)
    for k in cfg.algo.mlp_keys.encoder:
        obs_spec[k] = ((int(np.prod(cfg.spaces.obs[k].shape)),), np.float32)

    def greedy_fn(p, obs):
        return env_actions(sample_actions(p, obs, greedy=True)[0], is_continuous)

    def sample_fn(p, obs, draws):
        if is_continuous:
            return env_actions(sample_actions(p, obs, noise=draws)[0], True)
        return env_actions(sample_actions(p, obs, uniforms=draws)[0], False)

    def draw_fn(seed, counter):
        if is_continuous:
            return counter_normal(seed, counter, 0, int(sum(actions_dim)))
        return [counter_uniform(seed, counter, i, d) for i, d in enumerate(actions_dim)]

    def prepare(obs, n):
        prepared = prepare_obs({k: obs[k] for k in obs_spec}, cnn_keys, n)
        return {k: prepared[k].numpy() for k in obs_spec}

    return ServePolicy(
        name=str(cfg.algo.name),
        params=build(state["agent"] if state is not None else None),
        obs_spec=obs_spec,
        action_dim=int(sum(actions_dim)) if is_continuous else len(actions_dim),
        greedy_fn=greedy_fn,
        sample_fn=sample_fn,
        draw_fn=draw_fn,
        prepare=prepare,
        params_from_state=lambda new_state: build(new_state["agent"]),
        device=device,
    )
