"""PPO evaluation and its stateless serving policy builder (counterpart of
``sheeprl_tpu/algos/ppo/evaluate.py``: ``evaluate_ppo`` and
``serve_policy_ppo``, registered for ``ppo`` and ``ppo_anakin``, whose
checkpoints hold one agent; ``evaluate_ppo_population`` and
``serve_policy_ppo_population`` for ``ppo_anakin_population``, whose
checkpoints stack every member's parameters on a leading axis and name the
fittest, ``best_member``). The decoupled and Sebulba names wait for their
trainers."""

from __future__ import annotations

from typing import Any, Dict, Optional

import dataclasses

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import build_agent, env_actions, sample_actions
from sheeprl_tpu_torch.algos.ppo.utils import action_spec, prepare_obs, test
from sheeprl_tpu_torch.ops import counter_normal, counter_uniform
from sheeprl_tpu_torch.serve.policy import ServePolicy
from sheeprl_tpu_torch.utils.registry import register_evaluation, register_policy_builder

__all__ = ["evaluate_ppo", "serve_policy_ppo", "evaluate_ppo_population", "serve_policy_ppo_population"]


@register_evaluation(algorithms=["ppo", "ppo_anakin", "ppo_decoupled", "ppo_sebulba"])
def evaluate_ppo(cfg: Any, state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """One greedy test episode of the checkpoint's agent; its return and
    step count."""
    actions_dim, is_continuous = action_spec(cfg.spaces)
    _, player = build_agent(cfg, actions_dim, is_continuous, cfg.spaces.obs, device, state["agent"])
    reward, steps = test(player, cfg, device)
    return {"reward": reward, "steps": steps}


@register_policy_builder(algorithms=["ppo", "ppo_anakin", "ppo_decoupled", "ppo_sebulba"])
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


def _member_slice(tree: Dict[str, Any], member: int) -> Dict[str, torch.Tensor]:
    """One member of a member-stacked ``{name: (P, ...)}`` tree."""
    return {k: torch.as_tensor(v)[member] for k, v in tree.items()}


def _best_member_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """A population checkpoint with its fittest member's agent (and, where
    the run swept env constants, that member's scenario row)."""
    sliced = dict(state)
    member = int(state.get("best_member", 0))
    sliced["agent"] = _member_slice(state["agent"], member)
    if state.get("env_params") is not None:
        sliced["env_params"] = _member_slice(state["env_params"], member)
    return sliced


def _scenario_desc(env_params: Dict[str, Any]) -> str:
    return ", ".join(f"{k}={float(v):.6g}" for k, v in env_params.items())


@register_evaluation(algorithms=["ppo_anakin_population"])
def evaluate_ppo_population(cfg: Any, state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """The fittest member's greedy test episode, on the host env of the
    training env's id (default dynamics: the member's scenario row is printed,
    so a member trained on other constants is seen to be evaluated off its
    training dynamics)."""
    sliced = _best_member_state(state)
    if sliced.get("env_params") is not None:
        print(f"Best member scenario (training dynamics): {_scenario_desc(sliced['env_params'])}", flush=True)
    return evaluate_ppo(cfg, sliced, device)


@register_policy_builder(algorithms=["ppo_anakin_population"])
def serve_policy_ppo_population(cfg: Any, state: Optional[Dict[str, Any]], device: torch.device) -> ServePolicy:
    """Serve the fittest member of a population checkpoint (``best_member``,
    member 0 without one). A hot swap of a watched population run publishes
    member-stacked agents, so ``params_from_state`` slices the served member
    out of each before rebuilding."""
    best = int(state.get("best_member", 0)) if state is not None else 0
    if state is not None and state.get("env_params") is not None:
        row = _member_slice(state["env_params"], best)
        print(f"Serving member {best} scenario (training dynamics): {_scenario_desc(row)}", flush=True)
    sliced = dict(state, agent=_member_slice(state["agent"], best)) if state is not None else None
    policy = serve_policy_ppo(cfg, sliced, device)
    rebuild = policy.params_from_state
    return dataclasses.replace(
        policy, params_from_state=lambda new_state: rebuild(dict(new_state, agent=_member_slice(new_state["agent"], best)))
    )
