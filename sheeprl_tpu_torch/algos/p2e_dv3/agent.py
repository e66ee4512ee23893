"""Plan2Explore on DreamerV3: the modules (counterpart of
``sheeprl_tpu/algos/p2e_dv3/agent.py``).

The DreamerV3 world model, task actor, critic and target critic, plus:

- ``actor_exploration``, the actor's twin, initialised on its own;
- ``critics_exploration``, one ``{module, target}`` pair of critics per
  entry of ``algo.critics_exploration`` (``extrinsic`` and ``intrinsic`` by
  default), kept in ``sorted`` name order as the JAX package orders them;
- ``ensembles``, ``algo.ensembles.n`` forward models mapping (latent,
  action) to the next stochastic state. Their weights are stacked along a
  leading member axis in flax's layout (``kernel (n, in, out)``), and each
  layer is one batched matmul (``torch.baddbmm``) over all members: the
  twin of the JAX package's ``jax.vmap`` over the stacked tree. Each member
  is initialised from its own generator.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    Actor,
    WorldModel,
    _hafner_init,
    _init_weights,
    _modules,
    _PredictionHead,
    _uniform_output_init,
)
from sheeprl_tpu_torch.algos.droq.agent import _StackedLayerNorm
from sheeprl_tpu_torch.algos.sac.agent import _StackedDense
from sheeprl_tpu_torch.models import get_activation, set_compute_dtype
from sheeprl_tpu_torch.parallel import compute_dtype

__all__ = ["Ensembles", "P2EAgent", "build_agent", "STATE_KEYS"]

#: the checkpoint's module entries, as the JAX exploration loop saves them
STATE_KEYS = (
    "world_model",
    "ensembles",
    "actor_task",
    "critic_task",
    "target_critic_task",
    "actor_exploration",
    "critics_exploration",
)


class Ensembles(nn.Module):
    """``n`` :class:`_PredictionHead`-shaped MLPs (Linear, LayerNorm eps
    1e-3, SiLU per hidden layer, then a Linear ``out``) side by side, their
    weights stacked: ``x (..., in) -> (n, ..., out)``, every member applied
    to the same input. Dreamer V2's members (``layer_norm=False``,
    ``activation="elu"``) have no LayerNorm and ELU."""

    def __init__(self, n: int, input_dim: int, output_dim: int, mlp_layers: int, dense_units: int,
                 layer_norm: bool = True, activation: str = "silu") -> None:
        super().__init__()
        self.n = int(n)
        self.model = nn.Module()
        self.layer_norm = bool(layer_norm)
        self._act = get_activation(activation)
        last = int(input_dim)
        for i in range(int(mlp_layers)):
            self.model.add_module(f"dense_{i}", _StackedDense(self.n, last, int(dense_units)))
            if self.layer_norm:
                self.model.add_module(f"ln_{i}", _StackedLayerNorm(self.n, int(dense_units), eps=1e-3))
            last = int(dense_units)
        self.out = _StackedDense(self.n, last, int(output_dim))
        self.mlp_layers = int(mlp_layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        h = x.reshape(1, -1, x.shape[-1]).expand(self.n, -1, -1)
        for i in range(self.mlp_layers):
            h = getattr(self.model, f"dense_{i}")(h)
            h = self._act(getattr(self.model, f"ln_{i}")(h) if self.layer_norm else h)
        out = self.out(h)
        return out.reshape(self.n, *lead, out.shape[-1])

    @torch.no_grad()
    def init_members(self, seed: int) -> None:
        """Each member from its own generator (``seed + member``): Hafner's
        truncated normal for the hidden layers and the scaled uniform (scale
        1) for the output, as the port initialises ``_PredictionHead``."""
        for m in range(self.n):
            generator = torch.Generator().manual_seed(int(seed) + m)
            head = _PredictionHead(self.model.dense_0.kernel.shape[1], self.out.kernel.shape[2], self.mlp_layers,
                                   self.out.kernel.shape[1])
            _hafner_init(head, generator)
            _uniform_output_init(head.out, generator, 1.0)
            for i in range(self.mlp_layers):
                dense = getattr(head.model, f"dense_{i}")
                getattr(self.model, f"dense_{i}").kernel[m] = dense.weight.T
                getattr(self.model, f"dense_{i}").bias[m] = dense.bias
            self.out.kernel[m] = head.out.weight.T
            self.out.bias[m] = head.out.bias


class P2EAgent(nn.Module):
    """Every module of a P2E-DV3 run, under the checkpoint's names
    (:data:`STATE_KEYS`)."""

    def __init__(self, world_model: WorldModel, actor_task: Actor, critic_task: _PredictionHead,
                 target_critic_task: _PredictionHead, actor_exploration: Actor, critics_exploration: nn.ModuleDict,
                 ensembles: Ensembles) -> None:
        super().__init__()
        self.world_model = world_model
        self.actor_task = actor_task
        self.critic_task = critic_task
        self.target_critic_task = target_critic_task
        self.actor_exploration = actor_exploration
        self.critics_exploration = critics_exploration
        self.ensembles = ensembles

    @property
    def critic_names(self) -> Tuple[str, ...]:
        return tuple(self.critics_exploration.keys())

    def state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """One ``state_dict`` per :data:`STATE_KEYS` entry."""
        return {k: getattr(self, k).state_dict() for k in STATE_KEYS}


def build_agent(cfg: Any, device: "torch.device | str" = "cpu", state: Optional[Dict[str, Any]] = None) -> P2EAgent:
    """The P2E-DV3 modules for ``cfg`` (a run config with ``spaces``),
    initialised from ``cfg.seed``: the DreamerV3 modules as
    ``build_training_agent`` draws them, then the exploration actor, each
    exploration critic (its output layer zeros, its target a copy) and the
    ensembles, each from a generator of its own; then loaded from ``state``
    (a checkpoint's :data:`STATE_KEYS` entries; a finetuning checkpoint
    lacks ``ensembles`` and ``critics_exploration``, which keep their
    initialisation), and moved to ``device``. The targets do not require
    gradients."""
    seed = int(cfg.get("seed") or 0)
    world_model, actor, critic = _modules(cfg, training=True)
    _init_weights(world_model, actor, critic, seed)
    actor_exploration = copy.deepcopy(actor)
    generator = torch.Generator().manual_seed(seed + 5)
    with torch.no_grad():
        _hafner_init(actor_exploration, generator)
        for i in range(actor_exploration.n_heads):
            _uniform_output_init(getattr(actor_exploration, f"head_{i}"), generator, 1.0)
        critics = nn.ModuleDict()
        for name in sorted(cfg.algo.critics_exploration):
            module = copy.deepcopy(critic)
            _hafner_init(module, generator)
            _uniform_output_init(module.out, generator, 0.0)
            critics[name] = nn.ModuleDict({"module": module, "target": copy.deepcopy(module)})
    ens_cfg, wm_cfg = cfg.algo.ensembles, cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    latent_dim = stoch + int(wm_cfg.recurrent_model.recurrent_state_size)
    ensembles = Ensembles(int(ens_cfg.n), latent_dim + sum(actor.actions_dim), stoch, int(ens_cfg.mlp_layers),
                          int(ens_cfg.dense_units))
    ensembles.init_members(seed + 7)
    agent = P2EAgent(world_model, actor, critic, copy.deepcopy(critic), actor_exploration, critics, ensembles)
    set_compute_dtype(agent, compute_dtype(cfg))
    if state is not None:
        for key in STATE_KEYS:
            if state.get(key) is not None:
                getattr(agent, key).load_state_dict(state[key])
    agent.target_critic_task.requires_grad_(False)
    for pair in agent.critics_exploration.values():
        pair["target"].requires_grad_(False)
    return agent.to(device).train()
