"""Recurrent PPO evaluation and its stateful serving policy builder
(counterpart of ``sheeprl_tpu/algos/ppo_recurrent/evaluate.py``,
``evaluate_ppo_recurrent`` and ``serve_policy_ppo_recurrent``).

Per-session state row: ``hx`` and ``cx`` (the LSTM pair the offline player
threads across env steps), ``prev_actions`` (the previous action the player
feeds back) and ``seed``/``counter`` in place of the JAX package's
per-session key. The step is the offline test episode's
(:func:`~sheeprl_tpu_torch.algos.ppo_recurrent.agent.session_step`), so a
served greedy session replays the evaluation episode's actions, and row
``i`` of a batched step equals stepping that session alone.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.utils import action_spec
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent, initial_state, session_step
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import prepare_obs, test
from sheeprl_tpu_torch.serve.policy import StatefulServePolicy
from sheeprl_tpu_torch.utils.registry import register_evaluation, register_policy_builder

__all__ = ["evaluate_ppo_recurrent", "serve_policy_ppo_recurrent"]


@register_evaluation(algorithms=["ppo_recurrent"])
def evaluate_ppo_recurrent(cfg: Any, state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """One greedy test episode of the checkpoint's agent; its return and
    step count."""
    actions_dim, is_continuous = action_spec(cfg.spaces)
    agent, _ = build_agent(cfg, actions_dim, is_continuous, cfg.spaces.obs, device, state["agent"])
    reward, steps = test(agent.requires_grad_(False), cfg, device)
    return {"reward": reward, "steps": steps}


@register_policy_builder(algorithms=["ppo_recurrent"])
def serve_policy_ppo_recurrent(cfg: Any, state: Optional[Dict[str, Any]], device: torch.device) -> StatefulServePolicy:
    """A :class:`StatefulServePolicy` over the recurrent PPO agent of
    ``state`` (None serves the seeded init) on ``device``."""
    device = torch.device(device)
    actions_dim, is_continuous = action_spec(cfg.spaces)
    seed = int(cfg.get("seed") or 0)
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    obs_spec = {}
    for k in cnn_keys:
        obs_spec[k] = (tuple(int(d) for d in cfg.spaces.obs[k].shape[-3:]), np.float32)
    for k in cfg.algo.mlp_keys.encoder:
        obs_spec[k] = ((int(np.prod(cfg.spaces.obs[k].shape)),), np.float32)

    def build(agent_state):
        agent, _ = build_agent(cfg, actions_dim, is_continuous, cfg.spaces.obs, device, agent_state)
        return agent.requires_grad_(False)

    def prepare(obs, n):
        # the loop's prepare is time-major (1, n, ...); the session rows are batch-major
        prepared = prepare_obs({k: obs[k] for k in obs_spec}, cnn_keys, n)
        return {k: prepared[k].reshape(n, *obs_spec[k][0]).numpy() for k in obs_spec}

    return StatefulServePolicy(
        name=str(cfg.algo.name),
        params=build(state["agent"] if state is not None else None),
        obs_spec=obs_spec,
        action_dim=int(sum(actions_dim)) if is_continuous else len(actions_dim),
        step_fn=session_step,
        init_fn=lambda p, n: initial_state(p, n, seed, device),
        prepare=prepare,
        params_from_state=lambda new_state: build(new_state["agent"]),
        device=device,
    )
