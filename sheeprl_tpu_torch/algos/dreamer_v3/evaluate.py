"""DreamerV3 evaluation and its stateful policy builder (counterpart of
``sheeprl_tpu/algos/dreamer_v3/evaluate.py``, ``evaluate_dreamer_v3`` and
``serve_policy_dreamer_v3``).

Per-session state row: ``actions`` (the action carry: one-hot per discrete
head, or the continuous action vector), ``recurrent``
(the RSSM deterministic state), ``stochastic`` (the flattened posterior
sample), and ``seed``/``counter`` in place of the JAX package's per-session
key: every random draw of a session is a function of its seed, its step
count and the draw's stream, so row ``i`` of a batched step equals stepping
that session alone. The posterior is sampled even in greedy mode, as in the
offline player; greedy mode takes the actor's mode. The offline test
episode (:func:`~sheeprl_tpu_torch.algos.dreamer_v3.utils.test`) steps one
such row with the same :func:`session_step`, so a served session fed the
episode's frames gives the episode's actions.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, WorldModel, actor_sample, build_agent, sample_stochastic
from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test
from sheeprl_tpu_torch.ops import counter_normal, counter_uniform
from sheeprl_tpu_torch.serve.policy import StatefulServePolicy
from sheeprl_tpu_torch.utils.registry import register_evaluation, register_policy_builder

__all__ = [
    "DreamerV3Agent",
    "posterior_step",
    "act",
    "initial_state",
    "session_step",
    "evaluate_dreamer_v3",
    "serve_policy_dreamer_v3",
]

#: counter_uniform stream of the posterior draw; discrete actor head ``i``
#: uses 1 + i, a continuous actor's normals (``counter_normal``) stream 1
POSTERIOR_STREAM = 0


class DreamerV3Agent(nn.Module):
    """What a session step needs: the world model and the actor."""

    def __init__(self, world_model: WorldModel, actor: Actor) -> None:
        super().__init__()
        self.world_model = world_model
        self.actor = actor


def posterior_step(
    agent: DreamerV3Agent,
    obs: Dict[str, torch.Tensor],
    actions: torch.Tensor,
    recurrent: torch.Tensor,
    stochastic: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ``obs``, advance the recurrent state on the previous posterior
    and action, and return ``(recurrent', representation logits)`` (unimixed,
    flat ``(B, S*D)``)."""
    wm = agent.world_model
    embedded = wm.encoder(obs)
    recurrent = wm.recurrent_model(torch.cat([stochastic, actions], dim=-1), recurrent)
    return recurrent, wm.representation(recurrent, embedded)


def act(
    agent: DreamerV3Agent,
    stochastic: torch.Tensor,
    recurrent: torch.Tensor,
    greedy: bool,
    seed: Optional[torch.Tensor] = None,
    counter: Optional[torch.Tensor] = None,
) -> List[torch.Tensor]:
    """One-hot actions per head, or the one continuous action tensor, from
    the latent ``[stochastic, recurrent]``; sampled mode draws discrete head
    ``i`` from stream ``1 + i`` of each row's ``(seed, counter)``, a
    continuous actor's standard normals from stream 1."""
    actor = agent.actor
    noise = None
    if not greedy and actor.is_continuous:
        noise = [counter_normal(seed, counter, 1, sum(actor.actions_dim))]
    elif not greedy:
        noise = [counter_uniform(seed, counter, 1 + i, d) for i, d in enumerate(actor.actions_dim)]
    actions, _ = actor_sample(actor, torch.cat([stochastic, recurrent], dim=-1), noise, greedy)
    return actions


def initial_state(agent: DreamerV3Agent, n: int, seed: int) -> Dict[str, torch.Tensor]:
    """``n`` identical fresh state rows: no action, the initial recurrent
    state and its posterior, ``seed``, step 0."""
    rec, post = agent.world_model.get_initial_states(n)
    return {
        "actions": torch.zeros((n, int(sum(agent.actor.actions_dim))), dtype=torch.float32, device=rec.device),
        "recurrent": rec,
        "stochastic": post,
        "seed": torch.full((n,), int(seed), dtype=torch.int64, device=rec.device),
        "counter": torch.zeros((n,), dtype=torch.int64, device=rec.device),
    }


def session_step(
    agent: DreamerV3Agent, obs: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor], greedy: bool
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step of every row: the posterior drawn from stream
    ``POSTERIOR_STREAM`` of the row's ``(seed, counter)``, then the actions.
    Returns the env actions, ``(B, heads)`` (each head's index) or ``(B,
    sum(actions_dim))`` (the continuous action as it is), and the advanced
    rows."""
    wm = agent.world_model
    rec, logits = posterior_step(agent, obs, state["actions"], state["recurrent"], state["stochastic"])
    uniform = counter_uniform(state["seed"], state["counter"], POSTERIOR_STREAM, logits.shape[-1])
    stoch = sample_stochastic(logits, wm.discrete, uniform)
    acts = act(agent, stoch, rec, greedy, state["seed"], state["counter"])
    new_state = {
        "actions": torch.cat(acts, dim=-1),
        "recurrent": rec,
        "stochastic": stoch,
        "seed": state["seed"],
        "counter": state["counter"] + 1,
    }
    if agent.actor.is_continuous:
        return acts[0], new_state
    return torch.stack([a.argmax(dim=-1) for a in acts], dim=-1), new_state


def _spec(cfg: Any) -> Tuple[Dict[str, Tuple[Tuple[int, ...], Any]], Tuple[str, ...]]:
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    obs_spec = {}
    for k in cnn_keys:
        obs_spec[k] = (tuple(int(d) for d in cfg.spaces.obs[k].shape[-3:]), np.float32)
    for k in cfg.algo.mlp_keys.encoder:
        obs_spec[k] = ((int(np.prod(cfg.spaces.obs[k].shape)),), np.float32)
    return obs_spec, cnn_keys


@register_evaluation(algorithms=["dreamer_v3", "dreamer_sebulba"])
def evaluate_dreamer_v3(cfg: Any, state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """One greedy test episode of the checkpoint's world model and actor;
    its return and step count."""
    world_model, actor = build_agent(cfg, device, state)
    reward, steps = test(DreamerV3Agent(world_model, actor).requires_grad_(False), cfg, device, greedy=True)
    return {"reward": reward, "steps": steps}


@register_policy_builder(algorithms=["dreamer_v3", "dreamer_sebulba"])
def serve_policy_dreamer_v3(cfg: Any, state: Optional[Dict[str, Any]], device: torch.device) -> StatefulServePolicy:
    """A :class:`StatefulServePolicy` over the DreamerV3 world model and actor
    of ``state`` (``{"world_model", "actor"}`` state dicts; None serves the
    seeded random init) on ``device``."""
    device = torch.device(device)
    world_model, actor = build_agent(cfg, device, state)
    params = DreamerV3Agent(world_model, actor).requires_grad_(False)
    seed = int(cfg.get("seed") or 0)
    obs_spec, cnn_keys = _spec(cfg)

    def prepare(obs, n):
        prepared = prepare_obs({k: obs[k] for k in obs_spec}, cnn_keys=cnn_keys, num_envs=n)
        return {k: prepared[k].reshape(n, *obs_spec[k][0]) for k in obs_spec}

    def params_from_state(new_state):
        wm, ac = build_agent(cfg, device, new_state)
        return DreamerV3Agent(wm, ac).requires_grad_(False)

    return StatefulServePolicy(
        name=str(cfg.algo.name),
        params=params,
        obs_spec=obs_spec,
        action_dim=sum(actor.actions_dim) if actor.is_continuous else len(actor.actions_dim),
        step_fn=session_step,
        init_fn=lambda p, n: initial_state(p, n, seed),
        prepare=prepare,
        params_from_state=params_from_state,
        device=device,
    )
