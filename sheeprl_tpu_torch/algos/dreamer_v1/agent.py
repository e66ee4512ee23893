"""Dreamer V1 agent (counterpart of ``sheeprl_tpu/algos/dreamer_v1/agent.py``).

V1 reuses Dreamer V2's VALID-padded encoder and decoder, heads and actor
(without LayerNorm), as the JAX V1 agent does. What is its own:

- :class:`GRUCell`, flax ``nn.GRUCell``'s gate math in plain ops: biases on
  the input projections of the r, z and n gates and on the hidden
  projection of the n gate only, so the r and z hidden biases that
  ``torch.nn.GRUCell`` would add do not exist here (they read as zeros in
  :attr:`GRUCell.bias_hh`) and no optimizer sees them;
- the recurrent model ``Linear -> activation -> GRUCell``; there is no
  LayerNorm and no kernel on V1's path;
- a Gaussian stochastic state: the transition and representation heads give
  ``(mean, raw std)``, std = ``softplus(raw) + min_std``, and a sample is
  ``mean + std * noise`` on injected standard normals
  (:func:`compute_stochastic_state`);
- ``dynamic`` without ``is_first`` zeroing (V1 predates it);
- the actor's continuous default ``tanh_normal`` (``init_std`` 5) and its
  epsilon exploration on the player (``expl_amount`` 0.3 in the recipe).

A fresh run initialises every kernel Xavier-normal (each GRU gate's kernel
on its own fans, as flax keeps them) and every bias to zero. Submodules keep
the flax names, so ``utils/convert.py:dreamer_v1_state_from_jax`` carries a
JAX tree across.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    Actor,
    CNNDecoder,
    CNNEncoder,
    Head,
    MLPDecoder,
    MLPEncoder,
    PlayerModules,
    actor_dists,
    actor_sample,
    add_exploration_noise,
    draw_actor_noise,
    xavier_normal_,
)
from sheeprl_tpu_torch.algos.dreamer_v3.agent import Encoder, action_dims
from sheeprl_tpu_torch.models import Dense, get_activation, set_compute_dtype
from sheeprl_tpu_torch.parallel import compute_dtype

__all__ = [
    "GRUCell",
    "RecurrentModel",
    "WorldModel",
    "PlayerDV1",
    "player_subset",
    "compute_stochastic_state",
    "actor_dists",
    "actor_sample",
    "add_exploration_noise",
    "init_weights",
    "build_agent",
]


class GRUCell(nn.Module):
    """flax ``nn.GRUCell`` over a carry ``h`` and an input ``x``::

        r = sigmoid(W_ir x + b_ir + W_hr h)
        z = sigmoid(W_iz x + b_iz + W_hz h)
        n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
        h' = (1 - z) * n + z * h

    The weights are packed in torch's r, z, n order (``weight_ih``
    ``(3H, in)``, ``weight_hh`` ``(3H, H)``, ``bias_ih`` ``(3H,)``); the one
    hidden bias is ``bias_hn`` ``(H,)``. Below float32 each projection is
    computed as flax's ``Dense(dtype=...)`` and the gates in that dtype, as
    flax's ``GRUCell(dtype=...)`` computes."""

    dtype: torch.dtype = torch.float32

    def __init__(self, input_size: int, hidden_size: int) -> None:
        super().__init__()
        self.input_size, self.hidden_size = int(input_size), int(hidden_size)
        H = self.hidden_size
        self.weight_ih = nn.Parameter(torch.empty(3 * H, self.input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * H, H))
        self.bias_ih = nn.Parameter(torch.zeros(3 * H))
        self.bias_hn = nn.Parameter(torch.zeros(H))
        self.xavier_()

    @property
    def bias_hh(self) -> torch.Tensor:
        """``torch.nn.GRUCell``'s hidden bias of this cell: zeros for the r
        and z gates, then ``bias_hn``."""
        return torch.cat([torch.zeros_like(self.bias_hn).repeat(2), self.bias_hn])

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            i_r, i_z, i_n = F.linear(x, self.weight_ih, self.bias_ih).chunk(3, dim=-1)
            h_r, h_z, h_n = F.linear(h, self.weight_hh).chunk(3, dim=-1)
            h_n = h_n + self.bias_hn
        else:
            dt = self.dtype
            i_r, i_z, i_n = (F.linear(x.to(dt), self.weight_ih.to(dt)) + self.bias_ih.to(dt)).chunk(3, dim=-1)
            h_r, h_z, h_n = F.linear(h.to(dt), self.weight_hh.to(dt)).chunk(3, dim=-1)
            h_n = h_n + self.bias_hn.to(dt)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h

    @torch.no_grad()
    def xavier_(self, generator: Optional[torch.Generator] = None) -> None:
        """Each gate's kernel Xavier-normal on its own fans (``in + H`` for
        the input kernels, ``2H`` for the hidden ones), the biases zero;
        drawn from ``generator`` (the global one when None)."""
        H = self.hidden_size
        for weight, fan_in in ((self.weight_ih, self.input_size), (self.weight_hh, H)):
            for gate in range(3):
                weight[gate * H:(gate + 1) * H].normal_(0.0, float(np.sqrt(2.0 / (fan_in + H))), generator=generator)
        self.bias_ih.zero_()
        self.bias_hn.zero_()


class RecurrentModel(nn.Module):
    """``fc`` (a Linear to the recurrent width), the activation, then the
    flax-form :class:`GRUCell` ``rnn``."""

    def __init__(self, input_dim: int, recurrent_state_size: int, activation: str = "elu") -> None:
        super().__init__()
        self.fc = Dense(int(input_dim), int(recurrent_state_size))
        self._act = get_activation(activation)
        self.rnn = GRUCell(int(recurrent_state_size), int(recurrent_state_size))

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.rnn(recurrent_state, self._act(self.fc(x)))


def compute_stochastic_state(mean_std: torch.Tensor, noise: Optional[torch.Tensor], min_std: float = 0.1
                             ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Split ``(mean, raw std)``, take std = ``softplus(raw) + min_std``;
    the state is ``mean + std * noise`` (``noise`` standard normals of the
    mean's shape), or the mean when ``noise`` is None."""
    mean, std = torch.chunk(mean_std, 2, dim=-1)
    std = F.softplus(std) + min_std
    return (mean, std), (mean if noise is None else mean + std * noise)


class WorldModel(nn.Module):
    """Encoder, the Gaussian RSSM (recurrent, representation and transition
    models), decoders, reward and (with ``use_continues``) continue heads,
    under the JAX package's world-model keys."""

    def __init__(self, encoder: Encoder, recurrent_model: RecurrentModel, representation_model: Head,
                 transition_model: Head, min_std: float = 0.1, cnn_decoder: Optional[CNNDecoder] = None,
                 mlp_decoder: Optional[MLPDecoder] = None, reward_model: Optional[Head] = None,
                 continue_model: Optional[Head] = None) -> None:
        super().__init__()
        self.encoder = encoder
        self.recurrent_model = recurrent_model
        self.representation_model = representation_model
        self.transition_model = transition_model
        self.min_std = float(min_std)
        self.cnn_decoder = cnn_decoder
        self.mlp_decoder = mlp_decoder
        self.reward_model = reward_model
        self.continue_model = continue_model

    @property
    def stochastic_size(self) -> int:
        # the representation head gives the posterior's mean and std, as the transition the prior's
        return self.representation_model.out.out_features // 2

    def representation(self, recurrent_state: torch.Tensor, embedded_obs: torch.Tensor,
                       noise: Optional[torch.Tensor]):
        """``((mean, std), sample)`` of the posterior."""
        mean_std = self.representation_model(torch.cat([recurrent_state, embedded_obs], dim=-1))
        return compute_stochastic_state(mean_std, noise, self.min_std)

    def transition(self, recurrent_out: torch.Tensor, noise: Optional[torch.Tensor]):
        """``((mean, std), sample)`` of the prior."""
        return compute_stochastic_state(self.transition_model(recurrent_out), noise, self.min_std)

    def dynamic(self, posterior: torch.Tensor, recurrent_state: torch.Tensor, action: torch.Tensor,
                embedded_obs: torch.Tensor, noise: Optional[torch.Tensor]):
        """One dynamic-learning step over ``(B, ...)`` rows (no ``is_first``
        resets): ``(recurrent', posterior sample, (posterior mean, std),
        (prior mean, std))``; ``noise`` is the posterior draw's (the prior's
        draw is not used, as in the JAX step)."""
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], dim=-1), recurrent_state)
        prior_ms, _ = self.transition(recurrent_state, None)
        posterior_ms, posterior = self.representation(recurrent_state, embedded_obs, noise)
        return recurrent_state, posterior, posterior_ms, prior_ms

    def imagination(self, prior: torch.Tensor, recurrent_state: torch.Tensor, actions: torch.Tensor,
                    noise: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """One latent imagination step: ``(prior sample', recurrent')``."""
        recurrent_state = self.recurrent_model(torch.cat([prior, actions], dim=-1), recurrent_state)
        return self.transition(recurrent_state, noise)[1], recurrent_state

    def decode(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for decoder in (self.cnn_decoder, self.mlp_decoder):
            if decoder is not None:
                out.update(decoder(latent))
        return out


class PlayerDV1:
    """The env-side policy: per env the action carry, the recurrent state
    and the posterior sample, zero at the start of each episode; every draw
    (the posterior, the actions, the exploration noise) from ``generator``.
    The posterior is sampled in greedy mode too, as the JAX player does."""

    def __init__(self, world_model: WorldModel, actor: Actor, num_envs: int, generator: torch.Generator,
                 expl_amount: float = 0.0) -> None:
        self.world_model = world_model
        self.actor = actor
        self.num_envs = int(num_envs)
        self.generator = generator
        self.expl_amount = float(expl_amount)
        self.actions = self.recurrent_state = self.stochastic_state = None

    @torch.no_grad()
    def init_states(self, reset_envs: Optional[Sequence[int]] = None) -> None:
        wm = self.world_model
        if reset_envs is None or len(reset_envs) == 0:
            device = wm.representation_model.out.weight.device
            self.actions = torch.zeros((self.num_envs, sum(self.actor.actions_dim)), device=device)
            self.recurrent_state = torch.zeros((self.num_envs, wm.recurrent_model.rnn.hidden_size), device=device)
            self.stochastic_state = torch.zeros((self.num_envs, wm.stochastic_size), device=device)
            return
        idx = torch.as_tensor(list(reset_envs), device=self.actions.device)
        for t in (self.actions, self.recurrent_state, self.stochastic_state):
            t[idx] = 0.0

    @torch.no_grad()
    def get_actions(self, obs: Dict[str, torch.Tensor], greedy: bool = False) -> List[torch.Tensor]:
        """One-hot actions per head, or the one continuous action tensor."""
        wm, actor = self.world_model, self.actor
        device = self.actions.device
        embedded = wm.encoder(obs)
        rec = wm.recurrent_model(torch.cat([self.stochastic_state, self.actions], dim=-1), self.recurrent_state)
        noise = torch.randn((self.num_envs, wm.stochastic_size), generator=self.generator, device=device)
        _, stoch = wm.representation(rec, embedded, noise)
        acts, _ = actor_sample(actor, torch.cat([stoch, rec], dim=-1),
                               draw_actor_noise(actor, self.num_envs, self.generator, device, greedy), greedy)
        if not greedy and self.expl_amount > 0.0:
            acts = add_exploration_noise(acts, self.expl_amount, actor.is_continuous, self.generator)
        self.actions = torch.cat(acts, dim=-1)
        self.recurrent_state, self.stochastic_state = rec, stoch
        return acts


def player_subset(world_model: WorldModel, actor: nn.Module) -> PlayerModules:
    """What the hybrid host player needs of a Dreamer V1 agent (the JAX
    loop's ``_player_subset``): the encoder, the recurrent and
    representation models and the acting actor, sharing the trainer's
    tensors."""
    sub = WorldModel(world_model.encoder, world_model.recurrent_model, world_model.representation_model, None,
                     world_model.min_std)
    return PlayerModules(sub, actor)


# -- initialization from a seed (JAX: agent.py:329-534) ------------------------


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """:func:`~sheeprl_tpu_torch.algos.dreamer_v2.agent.xavier_normal_`, and
    every :class:`GRUCell` gate by gate."""
    xavier_normal_(module, generator)
    for m in module.modules():
        if isinstance(m, GRUCell):
            m.xavier_(generator)


def distribution_type(cfg: Any, is_continuous: bool) -> str:
    """``distribution.type``, its ``auto`` resolved as the JAX V1 agent does:
    ``tanh_normal`` for a Box, ``discrete`` otherwise."""
    kind = str((cfg.get("distribution") or {}).get("type", "auto")).lower()
    if kind == "auto":
        return "tanh_normal" if is_continuous else "discrete"
    return kind


def _modules(cfg: Any) -> Tuple[WorldModel, Actor, Head]:
    """The modules for ``cfg`` (a run config with ``spaces``), not yet
    initialised. The CNN encoder and decoder use ``algo.cnn_act``, the rest
    ``algo.dense_act``; no module has a LayerNorm."""
    wm_cfg = cfg.algo.world_model
    is_continuous, actions_dim = action_dims(cfg.spaces)
    recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    stochastic_size = int(wm_cfg.stochastic_size)
    latent_dim = stochastic_size + recurrent_state_size
    act, cnn_act = str(cfg.algo.dense_act), str(cfg.algo.cnn_act)

    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    obs = cfg.spaces.obs
    cm = int(wm_cfg.encoder.cnn_channels_multiplier)
    cnn_encoder_output_dim = 8 * cm * 2 * 2 if cnn_keys else 0  # 64 -> 31 -> 14 -> 6 -> 2
    cnn_encoder = mlp_encoder = None
    if cnn_keys:
        channels = sum(int(np.prod(obs[k].shape[2:] or (1,))) for k in cnn_keys)
        cnn_encoder = CNNEncoder(cnn_keys, channels, cm, False, cnn_act)
    if mlp_keys:
        mlp_in = sum(int(np.prod(obs[k].shape)) for k in mlp_keys)
        mlp_encoder = MLPEncoder(mlp_keys, mlp_in, int(wm_cfg.encoder.mlp_layers), int(wm_cfg.encoder.dense_units),
                                 False, act)
    encoder_output_dim = cnn_encoder_output_dim + (int(wm_cfg.encoder.dense_units) if mlp_keys else 0)

    obs_cfg = wm_cfg.observation_model
    cnn_dec = list(cfg.algo.cnn_keys.get("decoder", cnn_keys))
    mlp_dec = list(cfg.algo.mlp_keys.get("decoder", mlp_keys))
    cnn_decoder = mlp_decoder = None
    if cnn_dec:
        cnn_decoder = CNNDecoder(cnn_dec, [int(np.prod(obs[k].shape[2:] or (1,))) for k in cnn_dec],
                                 int(obs_cfg.cnn_channels_multiplier), latent_dim, cnn_encoder_output_dim, False,
                                 cnn_act)
    if mlp_dec:
        mlp_decoder = MLPDecoder(mlp_dec, [int(np.prod(obs[k].shape)) for k in mlp_dec], latent_dim,
                                 int(obs_cfg.mlp_layers), int(obs_cfg.dense_units), False, act)
    rew, cont = wm_cfg.reward_model, wm_cfg.discount_model
    world_model = WorldModel(
        Encoder(cnn_encoder, mlp_encoder),
        RecurrentModel(stochastic_size + sum(actions_dim), recurrent_state_size, act),
        Head(encoder_output_dim + recurrent_state_size, 2 * stochastic_size, 1,
             int(wm_cfg.representation_model.hidden_size), False, act),
        Head(recurrent_state_size, 2 * stochastic_size, 1, int(wm_cfg.transition_model.hidden_size), False, act),
        float(wm_cfg.get("min_std", 0.1)),
        cnn_decoder=cnn_decoder,
        mlp_decoder=mlp_decoder,
        reward_model=Head(latent_dim, 1, int(rew.mlp_layers), int(rew.dense_units), False, act),
        continue_model=(Head(latent_dim, 1, int(cont.mlp_layers), int(cont.dense_units), False, act)
                        if bool(wm_cfg.use_continues) else None),
    )
    actor_cfg, critic_cfg = cfg.algo.actor, cfg.algo.critic
    actor = Actor(latent_dim, actions_dim, int(actor_cfg.dense_units), int(actor_cfg.mlp_layers),
                  is_continuous=is_continuous, distribution=distribution_type(cfg, is_continuous),
                  init_std=float(actor_cfg.get("init_std", 0.0)), min_std=float(actor_cfg.get("min_std", 0.1)),
                  layer_norm=False, activation=act)
    critic = Head(latent_dim, 1, int(critic_cfg.mlp_layers), int(critic_cfg.dense_units), False, act)
    dtype = compute_dtype(cfg)
    for m in (world_model, actor, critic):
        set_compute_dtype(m, dtype)
    return world_model, actor, critic


def build_agent(cfg: Any, device: "torch.device | str" = "cpu", state: Optional[Dict[str, Any]] = None
                ) -> Tuple[WorldModel, Actor, Head]:
    """World model, actor and critic for ``cfg`` (a run config with
    ``algo``, ``seed`` and ``spaces``; V1 has no target critic),
    initialised from ``cfg.seed`` (:func:`init_weights`), loaded from
    ``state`` (``{"world_model", "actor", "critic"}`` state dicts; a missing
    entry keeps its initialisation) where given, and moved to ``device``."""
    world_model, actor, critic = _modules(cfg)
    generator = torch.Generator().manual_seed(int(cfg.get("seed") or 0))
    for module in (world_model, actor, critic):
        init_weights(module, generator)
    for module, key in ((world_model, "world_model"), (actor, "actor"), (critic, "critic")):
        if state is not None and state.get(key) is not None:
            module.load_state_dict(state[key])
    return tuple(m.to(device).train() for m in (world_model, actor, critic))
