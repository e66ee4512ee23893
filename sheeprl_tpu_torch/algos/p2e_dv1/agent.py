"""Plan2Explore on Dreamer V1: the modules (counterpart of
``sheeprl_tpu/algos/p2e_dv1/agent.py``).

The Dreamer V1 world model, task actor and critic, plus the exploration
actor, ONE exploration critic (V1 has no target critics), and
``algo.ensembles.n`` forward models mapping (latent, action) to the next
EMBEDDED observation, the original Plan2Explore target: the P2E-DV3
:class:`~sheeprl_tpu_torch.algos.p2e_dv3.agent.Ensembles` with V1's members
(no LayerNorm, ``algo.dense_act``), their weights stacked in flax's layout
(``kernel (n, in, out)``), each layer one batched matmul: its forward is the
JAX package's ``ensembles_apply``. The exploration actor and critic are drawn
from a generator of their own, each member from its own.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v1.agent import WorldModel, _modules, init_weights
from sheeprl_tpu_torch.algos.dreamer_v2.agent import Actor, Head
from sheeprl_tpu_torch.algos.p2e_dv2.agent import _init_members
from sheeprl_tpu_torch.algos.p2e_dv3.agent import Ensembles
from sheeprl_tpu_torch.models import set_compute_dtype
from sheeprl_tpu_torch.parallel import compute_dtype

__all__ = ["P2EDV1Agent", "STATE_KEYS", "build_agent"]

#: the checkpoint's module entries, as the JAX exploration loop saves them
STATE_KEYS = ("world_model", "ensembles", "actor_task", "critic_task", "actor_exploration", "critic_exploration")


class P2EDV1Agent(nn.Module):
    """Every module of a P2E-DV1 run, under the checkpoint's names
    (:data:`STATE_KEYS`)."""

    def __init__(self, world_model: WorldModel, actor_task: Actor, critic_task: Head, actor_exploration: Actor,
                 critic_exploration: Head, ensembles: Ensembles) -> None:
        super().__init__()
        self.world_model = world_model
        self.actor_task = actor_task
        self.critic_task = critic_task
        self.actor_exploration = actor_exploration
        self.critic_exploration = critic_exploration
        self.ensembles = ensembles

    def state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """One ``state_dict`` per :data:`STATE_KEYS` entry."""
        return {k: getattr(self, k).state_dict() for k in STATE_KEYS}


def build_agent(cfg: Any, device: "torch.device | str" = "cpu", state: Optional[Dict[str, Any]] = None
                ) -> P2EDV1Agent:
    """The P2E-DV1 modules for ``cfg`` (a run config with ``spaces``),
    initialised from ``cfg.seed``: the Dreamer V1 modules as its
    ``build_agent`` draws them, then the exploration actor and critic from a
    generator of their own and the ensembles a generator per member; then
    loaded from ``state`` (a checkpoint's :data:`STATE_KEYS` entries; a
    finetuning checkpoint lacks the ensembles and the exploration critic,
    which keep their initialisation), and moved to ``device``."""
    seed = int(cfg.get("seed") or 0)
    world_model, actor, critic = _modules(cfg)
    generator = torch.Generator().manual_seed(seed)
    for module in (world_model, actor, critic):
        init_weights(module, generator)
    actor_exploration, critic_exploration = copy.deepcopy(actor), copy.deepcopy(critic)
    generator = torch.Generator().manual_seed(seed + 5)
    init_weights(actor_exploration, generator)
    init_weights(critic_exploration, generator)
    ens_cfg, wm_cfg = cfg.algo.ensembles, cfg.algo.world_model
    latent_dim = int(wm_cfg.stochastic_size) + int(wm_cfg.recurrent_model.recurrent_state_size)
    # the encoder's output: 2 x 2 x (8 multiplier) pixel features and the vector features
    embedded_dim = (8 * int(wm_cfg.encoder.cnn_channels_multiplier) * 2 * 2 if cfg.algo.cnn_keys.encoder else 0) + (
        int(wm_cfg.encoder.dense_units) if cfg.algo.mlp_keys.encoder else 0)
    ensembles = Ensembles(int(ens_cfg.n), latent_dim + sum(actor.actions_dim), embedded_dim, int(ens_cfg.mlp_layers),
                          int(ens_cfg.dense_units), layer_norm=False, activation=str(cfg.algo.dense_act))
    _init_members(ensembles, seed + 7)
    agent = P2EDV1Agent(world_model, actor, critic, actor_exploration, critic_exploration, ensembles)
    set_compute_dtype(agent, compute_dtype(cfg))
    if state is not None:
        for key in STATE_KEYS:
            if state.get(key) is not None:
                getattr(agent, key).load_state_dict(state[key])
    return agent.to(device).train()
