"""SAC evaluation and its stateless serving policy builder (counterpart of
``sheeprl_tpu/algos/sac/evaluate.py``, ``evaluate_sac`` and
``serve_policy_sac``). Registered for ``sac``; the decoupled and Sebulba
names wait for their trainers."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.agent import build_agent
from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test
from sheeprl_tpu_torch.ops import counter_normal
from sheeprl_tpu_torch.serve.policy import ServePolicy
from sheeprl_tpu_torch.utils.registry import register_evaluation, register_policy_builder

__all__ = ["evaluate_sac", "serve_policy_sac", "standard_normal"]


def _obs_dim(cfg: Any) -> int:
    return int(sum(np.prod(cfg.spaces.obs[k].shape) for k in cfg.algo.mlp_keys.encoder))


def standard_normal(seed: torch.Tensor, counter: torch.Tensor, n: int) -> torch.Tensor:
    """``(B, n)`` standard normals from stream 0 of ``counter_normal``."""
    return counter_normal(seed, counter, 0, n)


@register_evaluation(algorithms=["sac", "sac_decoupled", "sac_sebulba"])
def evaluate_sac(cfg: Any, state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """One greedy test episode of the checkpoint's agent; its return and
    step count."""
    _, player = build_agent(cfg, _obs_dim(cfg), cfg.spaces.actions, device, state["agent"])
    reward, steps = test(player, cfg, device)
    return {"reward": reward, "steps": steps}


@register_policy_builder(algorithms=["sac", "sac_decoupled", "sac_sebulba"])
def serve_policy_sac(cfg: Any, state: Optional[Dict[str, Any]], device: torch.device) -> ServePolicy:
    """A :class:`ServePolicy` over the SAC actor of ``state`` (None serves
    the seeded init) on ``device``: greedy is ``agent.greedy_action`` (the
    squashed mean, rescaled), sample is ``agent.sample_action`` on the
    engine's normals, both over the flattened mlp keys as ``prepare_obs``
    builds them."""
    device = torch.device(device)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    act_dim = int(np.prod(cfg.spaces.actions.shape))

    def build(agent_state):
        agent, _ = build_agent(cfg, _obs_dim(cfg), cfg.spaces.actions, device, agent_state)
        return agent.requires_grad_(False)

    def greedy_fn(p, obs):
        return p.greedy_action(obs["obs"])

    def sample_fn(p, obs, noise):
        return p.sample_action(obs["obs"], noise)[0]

    def prepare(obs, n):
        return {"obs": prepare_obs(obs, mlp_keys, n).numpy()}

    return ServePolicy(
        name=str(cfg.algo.name),
        params=build(state["agent"] if state is not None else None),
        obs_spec={"obs": ((_obs_dim(cfg),), np.float32)},
        action_dim=act_dim,
        greedy_fn=greedy_fn,
        sample_fn=sample_fn,
        draw_fn=lambda seed, counter: standard_normal(seed, counter, act_dim),
        prepare=prepare,
        params_from_state=lambda new_state: build(new_state["agent"]),
        device=device,
    )
