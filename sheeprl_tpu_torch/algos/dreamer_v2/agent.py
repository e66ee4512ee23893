"""Dreamer V2 agent (counterpart of ``sheeprl_tpu/algos/dreamer_v2/agent.py``):
the VALID-padded encoder and decoder, the RSSM (an MLP, then the
LayerNorm-GRU cell, whose LayerNorm and gates are one ``gru_gates_ln`` launch
on the card), the reward, continue and critic heads, and the actor:
discrete (one-hot heads) or continuous (``trunc_normal``, the default for a
Box, ``normal`` or ``tanh_normal``).

The V2 architecture, where it differs from DreamerV3's: ELU activations and
LayerNorm only where ``algo.layer_norm`` (and, for the recurrent model's MLP,
``recurrent_model.layer_norm``) asks; the encoder is four 4x4 stride-2 VALID
convolutions (64 -> 31 -> 14 -> 6 -> 2) and the decoder a Linear to a 1x1
map, then VALID transposed convolutions with kernels (5, 5, 6, 6) (1 -> 5 ->
13 -> 30 -> 64); the stochastic state has no unimix; ``is_first`` zeroes
the carried state, action and posterior (no learnable initial state); a
fresh run initialises every kernel Xavier-normal and every bias to zero.

Pixels stay NHWC at every public function; the convolutions run NCHW
inside, and the encoder flattens in (H, W, C) order as flax does, so
converted weights (``utils/convert.py:dreamer_v2_state_from_jax``) see
their features in the order they were trained on. Submodules keep the flax
names.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import Encoder, action_dims, sample_stochastic
from sheeprl_tpu_torch.distributions import (
    Independent,
    Normal,
    OneHotCategoricalStraightThrough,
    TanhNormal,
    TruncatedNormal,
)
from sheeprl_tpu_torch.models import (
    MLP, Conv2d, ConvTranspose, Dense, LayerNorm, LayerNormGRUCell, get_activation, set_compute_dtype,
)
from sheeprl_tpu_torch.parallel import compute_dtype

__all__ = [
    "CNNEncoder",
    "MLPEncoder",
    "CNNDecoder",
    "MLPDecoder",
    "RecurrentModel",
    "WorldModel",
    "Actor",
    "actor_dists",
    "actor_sample",
    "add_exploration_noise",
    "PlayerDV2",
    "PlayerModules",
    "player_subset",
    "build_agent",
    "xavier_normal_",
    "GREEDY_SAMPLES",
]

#: draws of the continuous actor's greedy action (the reference's argmax of
#: the log-prob over 100 samples)
GREEDY_SAMPLES = 100
#: flax ``nn.LayerNorm``'s default epsilon, the conv stacks' norms
_FLAX_LN_EPS = 1e-6


class CNNEncoder(nn.Module):
    """Four 4x4 stride-2 VALID convolutions (``mult`` x 1, 2, 4, 8 channels),
    each with ``[LayerNorm over channels]`` and the activation; NHWC in,
    flat (H, W, C) features out (2 x 2 x 8 ``mult`` at 64 x 64)."""

    def __init__(self, keys: Sequence[str], input_channels: int, channels_multiplier: int, layer_norm: bool = False,
                 activation: str = "elu") -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.layer_norm = bool(layer_norm)
        self._act = get_activation(activation)
        last = int(input_channels)
        for i, mult in enumerate((1, 2, 4, 8)):
            ch = mult * int(channels_multiplier)
            self.add_module(f"conv_{i}", Conv2d(last, ch, 4, stride=2, padding=0, bias=not self.layer_norm))
            if self.layer_norm:
                self.add_module(f"ln_{i}", LayerNorm(ch, eps=_FLAX_LN_EPS))
            last = ch

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-1)
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
        for i in range(4):
            x = getattr(self, f"conv_{i}")(x)
            if self.layer_norm:
                x = getattr(self, f"ln_{i}")(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            x = self._act(x)
        return x.permute(0, 2, 3, 1).reshape(*lead, -1)  # flattened in (H, W, C) order


class MLPEncoder(nn.Module):
    """The vector encoder: an MLP over the concatenated keys (no symlog in V2)."""

    def __init__(self, keys: Sequence[str], input_dim: int, mlp_layers: int, dense_units: int,
                 layer_norm: bool = False, activation: str = "elu") -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.model = MLP(input_dim, (int(dense_units),) * int(mlp_layers), activation=activation, layer_norm=layer_norm)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.model(torch.cat([obs[k] for k in self.keys], dim=-1))


class CNNDecoder(nn.Module):
    """A Linear to a 1x1 map of ``cnn_encoder_output_dim`` channels, then
    VALID stride-2 transposed convolutions with kernels 5, 5, 6 (4, 2, 1
    ``mult`` channels, ``[LayerNorm]`` and the activation after each) and a
    last one of kernel 6 to the keys' channels: 64 x 64 NHWC per key."""

    KERNELS = (5, 5, 6, 6)

    def __init__(self, keys: Sequence[str], output_channels: Sequence[int], channels_multiplier: int,
                 latent_dim: int, cnn_encoder_output_dim: int, layer_norm: bool = False,
                 activation: str = "elu") -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = tuple(int(c) for c in output_channels)
        self.layer_norm = bool(layer_norm)
        self._act = get_activation(activation)
        self.fc = Dense(int(latent_dim), int(cnn_encoder_output_dim))
        self.hidden = [4 * int(channels_multiplier), 2 * int(channels_multiplier), int(channels_multiplier)]
        last = int(cnn_encoder_output_dim)
        for i, ch in enumerate(self.hidden):
            self.add_module(f"deconv_{i}", ConvTranspose(last, ch, self.KERNELS[i], 2, padding=0, bias=not layer_norm))
            if self.layer_norm:
                self.add_module(f"ln_{i}", LayerNorm(ch, eps=_FLAX_LN_EPS))
            last = ch
        self.out = ConvTranspose(last, sum(self.output_channels), self.KERNELS[-1], 2, padding=0)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        lead = latent.shape[:-1]
        x = self.fc(latent).reshape(-1, self.fc.out_features, 1, 1)
        for i in range(len(self.hidden)):
            x = getattr(self, f"deconv_{i}")(x)
            if self.layer_norm:
                x = getattr(self, f"ln_{i}")(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            x = self._act(x)
        x = self.out(x).permute(0, 2, 3, 1)  # NHWC
        x = x.reshape(*lead, *x.shape[1:])
        return dict(zip(self.keys, torch.split(x, list(self.output_channels), dim=-1)))


class MLPDecoder(nn.Module):
    """An MLP and one linear head per key."""

    def __init__(self, keys: Sequence[str], output_dims: Sequence[int], latent_dim: int, mlp_layers: int,
                 dense_units: int, layer_norm: bool = False, activation: str = "elu") -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.model = MLP(latent_dim, (int(dense_units),) * int(mlp_layers), activation=activation,
                         layer_norm=layer_norm)
        for i, d in enumerate(output_dims):
            self.add_module(f"head_{i}", Dense(int(dense_units), int(d)))

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.model(latent)
        return {k: getattr(self, f"head_{i}")(x) for i, k in enumerate(self.keys)}


class RecurrentModel(nn.Module):
    """An MLP (its LayerNorm as ``recurrent_model.layer_norm`` says), then the
    LayerNorm-GRU cell with bias, its LayerNorm always on."""

    def __init__(self, input_dim: int, recurrent_state_size: int, dense_units: int, layer_norm: bool = True,
                 activation: str = "elu") -> None:
        super().__init__()
        self.mlp = MLP(input_dim, (int(dense_units),), activation=activation, layer_norm=layer_norm)
        self.rnn = LayerNormGRUCell(int(dense_units), int(recurrent_state_size), use_bias=True, layer_norm=True)

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.rnn(recurrent_state, self.mlp(x))


class Head(nn.Module):
    """An MLP and a linear ``out``: the transition and representation models
    (one hidden layer), the reward, continue and critic heads and each
    ensemble member."""

    def __init__(self, input_dim: int, output_dim: int, mlp_layers: int, dense_units: int, layer_norm: bool = False,
                 activation: str = "elu") -> None:
        super().__init__()
        self.model = MLP(input_dim, (int(dense_units),) * int(mlp_layers), activation=activation,
                         layer_norm=layer_norm)
        self.out = Dense(int(dense_units), int(output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.model(x))


class WorldModel(nn.Module):
    """Encoder, RSSM (recurrent, representation and transition models),
    decoders, reward and (with ``use_continues``) continue heads, under the
    JAX package's world-model keys."""

    def __init__(self, encoder: Encoder, recurrent_model: RecurrentModel, representation_model: Head,
                 transition_model: Head, discrete: int, cnn_decoder: Optional[CNNDecoder] = None,
                 mlp_decoder: Optional[MLPDecoder] = None, reward_model: Optional[Head] = None,
                 continue_model: Optional[Head] = None) -> None:
        super().__init__()
        self.encoder = encoder
        self.recurrent_model = recurrent_model
        self.representation_model = representation_model
        self.transition_model = transition_model
        self.discrete = int(discrete)
        self.cnn_decoder = cnn_decoder
        self.mlp_decoder = mlp_decoder
        self.reward_model = reward_model
        self.continue_model = continue_model

    def representation(self, recurrent_state: torch.Tensor, embedded_obs: torch.Tensor) -> torch.Tensor:
        return self.representation_model(torch.cat([recurrent_state, embedded_obs], dim=-1))

    def transition(self, recurrent_out: torch.Tensor) -> torch.Tensor:
        return self.transition_model(recurrent_out)

    def dynamic(self, posterior: torch.Tensor, recurrent_state: torch.Tensor, action: torch.Tensor,
                embedded_obs: torch.Tensor, is_first: torch.Tensor, uniform: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """One dynamic-learning step over ``(B, ...)`` rows: where ``is_first``
        is 1 the action, the posterior and the recurrent state are zeroed.
        Returns ``(recurrent', posterior sample, posterior logits, prior
        logits)``; ``uniform`` is the posterior draw's noise (the prior's
        draw is not used, as in the JAX step)."""
        keep = 1 - is_first
        recurrent_state = self.recurrent_model(torch.cat([keep * posterior, keep * action], dim=-1),
                                               keep * recurrent_state)
        prior_logits = self.transition(recurrent_state)
        posterior_logits = self.representation(recurrent_state, embedded_obs)
        return recurrent_state, sample_stochastic(posterior_logits, self.discrete, uniform), posterior_logits, prior_logits

    def imagination(self, prior: torch.Tensor, recurrent_state: torch.Tensor, actions: torch.Tensor,
                    uniform: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """One latent imagination step: ``(prior sample', recurrent')``."""
        recurrent_state = self.recurrent_model(torch.cat([prior, actions], dim=-1), recurrent_state)
        return sample_stochastic(self.transition(recurrent_state), self.discrete, uniform), recurrent_state

    def decode(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for decoder in (self.cnn_decoder, self.mlp_decoder):
            if decoder is not None:
                out.update(decoder(latent))
        return out


class Actor(nn.Module):
    """Task actor: an MLP, then one logits head per action dimension
    (discrete), or one ``head_0`` of width ``2 * sum(actions_dim)``, the
    mean and the std parameter of every action (continuous)."""

    def __init__(self, input_dim: int, actions_dim: Sequence[int], dense_units: int, mlp_layers: int,
                 is_continuous: bool = False, distribution: str = "auto", init_std: float = 0.0,
                 min_std: float = 0.1, layer_norm: bool = False, activation: str = "elu") -> None:
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = bool(is_continuous)
        distribution = str(distribution).lower()
        if distribution == "auto":
            distribution = "trunc_normal" if self.is_continuous else "discrete"
        allowed = ("trunc_normal", "normal", "tanh_normal") if self.is_continuous else ("discrete",)
        if distribution not in allowed:
            raise ValueError(f"distribution.type '{distribution}' does not fit this action space; one of {allowed}")
        self.distribution = distribution
        self.init_std, self.min_std = float(init_std), float(min_std)
        self.model = MLP(input_dim, (int(dense_units),) * int(mlp_layers), activation=activation,
                         layer_norm=layer_norm)
        widths = [2 * sum(self.actions_dim)] if self.is_continuous else list(self.actions_dim)
        for i, d in enumerate(widths):
            self.add_module(f"head_{i}", Dense(int(dense_units), d))
        self.n_heads = len(widths)

    @property
    def noise_kind(self) -> str:
        """What a sampled action draws: ``uniform`` (a one-hot head's Gumbel
        noise, or the truncated normal's CDF inversion) or ``normal``."""
        return "normal" if self.distribution in ("normal", "tanh_normal") else "uniform"

    def forward(self, state: torch.Tensor) -> List[torch.Tensor]:
        x = self.model(state)
        return [getattr(self, f"head_{i}")(x) for i in range(self.n_heads)]


def actor_dists(actor: Actor, pre_dist: List[torch.Tensor]) -> list:
    """The action distributions of the actor's outputs: one one-hot
    categorical per head (no unimix), or for a continuous actor one
    ``Independent`` over the actions: ``trunc_normal``
    ``TruncatedNormal(tanh(mean), 2 sigmoid((std + init_std) / 2) + min_std,
    -1, 1)``, ``normal`` ``Normal(mean, std)``, ``tanh_normal``
    ``TanhNormal(5 tanh(mean / 5), softplus(std + init_std) + min_std)``."""
    if not actor.is_continuous:
        return [OneHotCategoricalStraightThrough(logits) for logits in pre_dist]
    mean, std = torch.chunk(pre_dist[0], 2, dim=-1)
    if actor.distribution == "tanh_normal":
        mean = 5 * torch.tanh(mean / 5)
        std = torch.nn.functional.softplus(std + actor.init_std) + actor.min_std
        return [Independent(TanhNormal(mean, std), 1)]
    if actor.distribution == "normal":
        return [Independent(Normal(mean, std), 1)]
    std = 2 * torch.sigmoid((std + actor.init_std) / 2) + actor.min_std
    return [Independent(TruncatedNormal(torch.tanh(mean), std, -1.0, 1.0), 1)]


def actor_sample(actor: Actor, state: torch.Tensor, noise: Optional[Sequence[torch.Tensor]] = None,
                 greedy: bool = False) -> Tuple[List[torch.Tensor], list]:
    """Actions from the actor at ``state``, one tensor per head. A discrete
    head: its mode when ``greedy``, else a straight-through one-hot from the
    uniforms ``noise[i]`` (``(..., A_i)``). A continuous actor: a
    reparameterised draw from ``noise[0]`` (``(..., sum(actions_dim))``,
    uniforms for ``trunc_normal``, standard normals otherwise); greedy, the
    draw of highest log-prob among ``GREEDY_SAMPLES``, whose noise
    ``noise[0]`` then holds (``(GREEDY_SAMPLES, ..., sum(actions_dim))``)."""
    dists = actor_dists(actor, actor(state))
    if actor.is_continuous:
        if noise is None or len(noise) != 1:
            raise ValueError("a continuous actor's action needs one noise tensor")
        d = dists[0]
        if not greedy:
            return [_rsample(actor, d, noise[0])], dists
        samples = _rsample(actor, d, noise[0])
        idx = torch.argmax(d.log_prob(samples), dim=0)
        act = torch.take_along_dim(samples, idx[None, ..., None], dim=0)[0]
        return [act], dists
    if greedy:
        return [d.mode for d in dists], dists
    if noise is None or len(noise) != len(dists):
        raise ValueError("sampled actions need one noise tensor per action head")
    return [d.rsample(uniform=u) for d, u in zip(dists, noise)], dists


def _rsample(actor: Actor, dist: Independent, noise: torch.Tensor) -> torch.Tensor:
    if actor.distribution == "trunc_normal":
        return dist.rsample(uniform=noise)
    return dist.rsample(noise=noise)


def add_exploration_noise(actions: Sequence[torch.Tensor], expl_amount: float, is_continuous: bool,
                          generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
    """Epsilon-style exploration (the JAX package's, without MineDojo
    masks): a continuous action plus ``expl_amount`` standard normals,
    clipped to [-1, 1]; each discrete head resampled uniformly with
    probability ``expl_amount``. An amount of 0 returns the actions."""
    if expl_amount <= 0.0:
        return list(actions)
    device = actions[0].device
    if is_continuous:
        cat = torch.cat(list(actions), dim=-1)
        noise = torch.randn(cat.shape, generator=generator, device=device) * expl_amount
        return [torch.clamp(cat + noise, -1, 1)]
    out = []
    for act in actions:
        pick = torch.randint(0, act.shape[-1], act.shape[:-1], generator=generator, device=device)
        sample = torch.nn.functional.one_hot(pick, act.shape[-1]).to(act.dtype)
        replace = torch.rand(act.shape[:1], generator=generator, device=device) < expl_amount
        out.append(torch.where(replace[..., None], sample, act))
    return out


def draw_actor_noise(actor: Actor, rows: int, generator: Optional[torch.Generator], device,
                     greedy: bool = False) -> Optional[List[torch.Tensor]]:
    """The noise :func:`actor_sample` takes for ``rows`` states: per discrete
    head uniforms (none when ``greedy``); for a continuous actor its
    uniforms or normals, ``GREEDY_SAMPLES`` draws of them when ``greedy``."""
    if not actor.is_continuous:
        if greedy:
            return None
        return [_uniform((rows, d), generator, device) for d in actor.actions_dim]
    shape = ((GREEDY_SAMPLES,) if greedy else ()) + (rows, sum(actor.actions_dim))
    if actor.noise_kind == "normal":
        return [torch.randn(shape, generator=generator, device=device)]
    return [torch.rand(shape, generator=generator, device=device)]


def _uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniforms in ``[tiny, 1)``, the interval ``jax.random.categorical``'s
    Gumbel noise is drawn from."""
    return torch.rand(shape, generator=generator, device=device).clamp_(min=float(np.finfo(np.float32).tiny))


class PlayerDV2:
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
            # the representation head's width is the stochastic state's (S*D), as the transition's
            device = wm.representation_model.out.weight.device
            self.actions = torch.zeros((self.num_envs, sum(self.actor.actions_dim)), device=device)
            self.recurrent_state = torch.zeros((self.num_envs, wm.recurrent_model.rnn.hidden_size), device=device)
            self.stochastic_state = torch.zeros((self.num_envs, wm.representation_model.out.out_features),
                                                device=device)
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
        logits = wm.representation(rec, embedded)
        stoch = sample_stochastic(logits, wm.discrete, _uniform(logits.shape, self.generator, device))
        noise = draw_actor_noise(actor, self.num_envs, self.generator, device, greedy)
        acts, _ = actor_sample(actor, torch.cat([stoch, rec], dim=-1), noise, greedy)
        if not greedy and self.expl_amount > 0.0:
            acts = add_exploration_noise(acts, self.expl_amount, actor.is_continuous, self.generator)
        self.actions = torch.cat(acts, dim=-1)
        self.recurrent_state, self.stochastic_state = rec, stoch
        return acts


class PlayerModules(nn.Module):
    """The modules a player acts with: ``world_model`` (the subset of
    :func:`player_subset`) and ``actor``."""

    def __init__(self, world_model: nn.Module, actor: nn.Module) -> None:
        super().__init__()
        self.world_model = world_model
        self.actor = actor


def player_subset(world_model: WorldModel, actor: Actor) -> PlayerModules:
    """What the hybrid host player needs of a Dreamer V2 agent (the JAX
    loop's ``_player_subset``): the encoder, the recurrent and
    representation models and the acting actor, sharing the trainer's
    tensors. The transition model, decoders, heads, critics and optimizer
    state stay on the card."""
    sub = WorldModel(world_model.encoder, world_model.recurrent_model, world_model.representation_model, None,
                     world_model.discrete)
    return PlayerModules(sub, actor)


# -- initialization from a seed (JAX: agent.py:646-671) ----------------------


@torch.no_grad()
def xavier_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """Every Linear, Conv and transposed-Conv weight from a normal of std
    ``sqrt(2 / (fan_in + fan_out))``, every such bias zero (LayerNorms keep
    their ones and zeros), as the JAX package's ``xavier_normal_init``."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            receptive = float(np.prod(m.weight.shape[2:])) if m.weight.ndim > 2 else 1.0
            fans = (m.weight.shape[0] + m.weight.shape[1]) * receptive
            m.weight.normal_(0.0, float(np.sqrt(2.0 / fans)), generator=generator)
            if m.bias is not None:
                m.bias.zero_()


def _modules(cfg: Any) -> Tuple[WorldModel, Actor, Head]:
    """The modules for ``cfg`` (a run config with ``spaces``), not yet
    initialised."""
    wm_cfg = cfg.algo.world_model
    is_continuous, actions_dim = action_dims(cfg.spaces)
    recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    discrete = int(wm_cfg.discrete_size)
    stoch_state_size = int(wm_cfg.stochastic_size) * discrete
    latent_dim = stoch_state_size + recurrent_state_size
    layer_norm = bool(cfg.algo.layer_norm)
    act = str(cfg.algo.dense_act)

    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    obs = cfg.spaces.obs
    cm = int(wm_cfg.encoder.cnn_channels_multiplier)
    cnn_encoder_output_dim = 8 * cm * 2 * 2 if cnn_keys else 0  # 64 -> 31 -> 14 -> 6 -> 2
    cnn_encoder = mlp_encoder = None
    if cnn_keys:
        channels = sum(int(np.prod(obs[k].shape[2:] or (1,))) for k in cnn_keys)
        cnn_encoder = CNNEncoder(cnn_keys, channels, cm, layer_norm, act)
    if mlp_keys:
        mlp_in = sum(int(np.prod(obs[k].shape)) for k in mlp_keys)
        mlp_encoder = MLPEncoder(mlp_keys, mlp_in, int(wm_cfg.encoder.mlp_layers), int(wm_cfg.encoder.dense_units),
                                 layer_norm, act)
    encoder_output_dim = cnn_encoder_output_dim + (int(wm_cfg.encoder.dense_units) if mlp_keys else 0)

    obs_cfg = wm_cfg.observation_model
    cnn_dec = list(cfg.algo.cnn_keys.get("decoder", cnn_keys))
    mlp_dec = list(cfg.algo.mlp_keys.get("decoder", mlp_keys))
    cnn_decoder = mlp_decoder = None
    if cnn_dec:
        cnn_decoder = CNNDecoder(cnn_dec, [int(np.prod(obs[k].shape[2:] or (1,))) for k in cnn_dec],
                                 int(obs_cfg.cnn_channels_multiplier), latent_dim, cnn_encoder_output_dim,
                                 layer_norm, act)
    if mlp_dec:
        mlp_decoder = MLPDecoder(mlp_dec, [int(np.prod(obs[k].shape)) for k in mlp_dec], latent_dim,
                                 int(obs_cfg.mlp_layers), int(obs_cfg.dense_units), layer_norm, act)
    rew, cont = wm_cfg.reward_model, wm_cfg.discount_model
    world_model = WorldModel(
        Encoder(cnn_encoder, mlp_encoder),
        RecurrentModel(stoch_state_size + sum(actions_dim), recurrent_state_size,
                       int(wm_cfg.recurrent_model.dense_units), bool(wm_cfg.recurrent_model.layer_norm), act),
        Head(encoder_output_dim + recurrent_state_size, stoch_state_size, 1,
             int(wm_cfg.representation_model.hidden_size), layer_norm, act),
        Head(recurrent_state_size, stoch_state_size, 1, int(wm_cfg.transition_model.hidden_size), layer_norm, act),
        discrete,
        cnn_decoder=cnn_decoder,
        mlp_decoder=mlp_decoder,
        reward_model=Head(latent_dim, 1, int(rew.mlp_layers), int(rew.dense_units), layer_norm, act),
        continue_model=(Head(latent_dim, 1, int(cont.mlp_layers), int(cont.dense_units), layer_norm, act)
                        if bool(wm_cfg.use_continues) else None),
    )
    actor_cfg, critic_cfg = cfg.algo.actor, cfg.algo.critic
    actor = Actor(latent_dim, actions_dim, int(actor_cfg.dense_units), int(actor_cfg.mlp_layers),
                  is_continuous=is_continuous, distribution=(cfg.get("distribution") or {}).get("type", "auto"),
                  init_std=float(actor_cfg.get("init_std", 0.0)), min_std=float(actor_cfg.get("min_std", 0.1)),
                  layer_norm=layer_norm, activation=act)
    critic = Head(latent_dim, 1, int(critic_cfg.mlp_layers), int(critic_cfg.dense_units), layer_norm, act)
    dtype = compute_dtype(cfg)
    for m in (world_model, actor, critic):
        set_compute_dtype(m, dtype)
    return world_model, actor, critic


def build_agent(cfg: Any, device: "torch.device | str" = "cpu", state: Optional[Dict[str, Any]] = None
                ) -> Tuple[WorldModel, Actor, Head, Head]:
    """World model, actor, critic and target critic for ``cfg`` (a run
    config with ``algo``, ``seed`` and ``spaces``), Xavier-normal from
    ``cfg.seed`` (the target critic a copy of the critic), loaded from
    ``state`` (``{"world_model", "actor", "critic", "target_critic"}`` state
    dicts; a missing entry keeps its initialisation) where given, and moved
    to ``device``. The target critic does not require gradients."""
    world_model, actor, critic = _modules(cfg)
    generator = torch.Generator().manual_seed(int(cfg.get("seed") or 0))
    for module in (world_model, actor, critic):
        xavier_normal_(module, generator)
    target_critic = copy.deepcopy(critic)
    for module, key in ((world_model, "world_model"), (actor, "actor"), (critic, "critic"),
                        (target_critic, "target_critic")):
        if state is not None and state.get(key) is not None:
            module.load_state_dict(state[key])
    target_critic.requires_grad_(False)
    return tuple(m.to(device).train() for m in (world_model, actor, critic, target_critic))
