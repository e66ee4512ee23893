"""Plan2Explore on Dreamer V2: the modules (counterpart of
``sheeprl_tpu/algos/p2e_dv2/agent.py``).

The Dreamer V2 world model, task actor, critic and target critic, plus the
exploration actor, ONE exploration critic with its target, and
``algo.ensembles.n`` forward models mapping (latent, action) to the next
stochastic state: the P2E-DV3 :class:`~sheeprl_tpu_torch.algos.p2e_dv3.agent.Ensembles`
with V2's members (no LayerNorm, ``algo.dense_act``), their weights stacked
in flax's layout (``kernel (n, in, out)``), each layer one batched matmul:
its forward is the JAX package's ``ensembles_apply`` (a ``jax.vmap`` over
the stacked tree). Each module is drawn Xavier-normal from a generator of
its own.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2.agent import Actor, Head, WorldModel, _modules, xavier_normal_
from sheeprl_tpu_torch.algos.p2e_dv3.agent import Ensembles
from sheeprl_tpu_torch.models import set_compute_dtype
from sheeprl_tpu_torch.parallel import compute_dtype

__all__ = ["P2EDV2Agent", "STATE_KEYS", "build_agent"]

#: the checkpoint's module entries, as the JAX exploration loop saves them
STATE_KEYS = (
    "world_model",
    "ensembles",
    "actor_task",
    "critic_task",
    "target_critic_task",
    "actor_exploration",
    "critic_exploration",
    "target_critic_exploration",
)


class P2EDV2Agent(nn.Module):
    """Every module of a P2E-DV2 run, under the checkpoint's names
    (:data:`STATE_KEYS`)."""

    def __init__(self, world_model: WorldModel, actor_task: Actor, critic_task: Head, target_critic_task: Head,
                 actor_exploration: Actor, critic_exploration: Head, target_critic_exploration: Head,
                 ensembles: Ensembles) -> None:
        super().__init__()
        self.world_model = world_model
        self.actor_task = actor_task
        self.critic_task = critic_task
        self.target_critic_task = target_critic_task
        self.actor_exploration = actor_exploration
        self.critic_exploration = critic_exploration
        self.target_critic_exploration = target_critic_exploration
        self.ensembles = ensembles

    def state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """One ``state_dict`` per :data:`STATE_KEYS` entry."""
        return {k: getattr(self, k).state_dict() for k in STATE_KEYS}


@torch.no_grad()
def _init_members(ensembles: Ensembles, seed: int) -> None:
    """Each member Xavier-normal from its own generator (``seed + member``):
    kernels of std ``sqrt(2 / (in + out))``, biases zero."""
    layers = [getattr(ensembles.model, f"dense_{i}") for i in range(ensembles.mlp_layers)] + [ensembles.out]
    for m in range(ensembles.n):
        generator = torch.Generator().manual_seed(int(seed) + m)
        for layer in layers:
            fan_in, fan_out = layer.kernel.shape[1:]
            layer.kernel[m].normal_(0.0, float((2.0 / (fan_in + fan_out)) ** 0.5), generator=generator)
            layer.bias[m].zero_()


def build_agent(cfg: Any, device: "torch.device | str" = "cpu", state: Optional[Dict[str, Any]] = None
                ) -> P2EDV2Agent:
    """The P2E-DV2 modules for ``cfg`` (a run config with ``spaces``),
    initialised from ``cfg.seed``: the Dreamer V2 modules as its
    ``build_agent`` draws them, then the exploration actor and critic (its
    target a copy) from a generator of their own and the ensembles a
    generator per member; then loaded from ``state`` (a checkpoint's
    :data:`STATE_KEYS` entries; a finetuning checkpoint lacks the ensembles
    and the exploration critics, which keep their initialisation), and
    moved to ``device``. The targets do not require gradients."""
    seed = int(cfg.get("seed") or 0)
    world_model, actor, critic = _modules(cfg)
    generator = torch.Generator().manual_seed(seed)
    for module in (world_model, actor, critic):
        xavier_normal_(module, generator)
    actor_exploration, critic_exploration = copy.deepcopy(actor), copy.deepcopy(critic)
    generator = torch.Generator().manual_seed(seed + 5)
    xavier_normal_(actor_exploration, generator)
    xavier_normal_(critic_exploration, generator)
    ens_cfg, wm_cfg = cfg.algo.ensembles, cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    latent_dim = stoch + int(wm_cfg.recurrent_model.recurrent_state_size)
    ensembles = Ensembles(int(ens_cfg.n), latent_dim + sum(actor.actions_dim), stoch, int(ens_cfg.mlp_layers),
                          int(ens_cfg.dense_units), layer_norm=bool(cfg.algo.layer_norm),
                          activation=str(cfg.algo.dense_act))
    _init_members(ensembles, seed + 7)
    agent = P2EDV2Agent(world_model, actor, critic, copy.deepcopy(critic), actor_exploration, critic_exploration,
                        copy.deepcopy(critic_exploration), ensembles)
    set_compute_dtype(agent, compute_dtype(cfg))
    if state is not None:
        for key in STATE_KEYS:
            if state.get(key) is not None:
                getattr(agent, key).load_state_dict(state[key])
    agent.target_critic_task.requires_grad_(False)
    agent.target_critic_exploration.requires_grad_(False)
    return agent.to(device).train()
