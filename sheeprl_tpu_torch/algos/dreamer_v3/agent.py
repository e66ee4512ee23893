"""DreamerV3 agent (counterpart of ``sheeprl_tpu/algos/dreamer_v3/agent.py``):
the encoders, the RSSM's recurrent, representation and transition models and
its training steps, the decoders, the reward, continue and critic heads, and
the actor: discrete (one-hot heads) or continuous (``scaled_normal``,
``normal`` or ``tanh_normal``). With ``algo.world_model.decoupled_rssm`` the
representation model reads the embedded observation alone (the JAX
package's ``DecoupledRSSM``). Serving builds the subset it runs
(:func:`build_agent`); training builds all of it
(:func:`build_training_agent`).

Pixels stay NHWC at every public function, as in the JAX package; the
convolutions run NCHW inside, LayerNorm runs over channels, and the encoder
flattens in (H, W, C) order so converted weights see the features in the
order they were trained on.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.distributions import Independent, Normal, OneHotCategoricalStraightThrough, TanhNormal
from sheeprl_tpu_torch.models import MLP, Conv2d, ConvTranspose, Dense, LayerNorm, LayerNormGRUCell, set_compute_dtype
from sheeprl_tpu_torch.ops import symlog
from sheeprl_tpu_torch.parallel import compute_dtype

__all__ = [
    "CNNEncoder",
    "MLPEncoder",
    "Encoder",
    "CNNDecoder",
    "MLPDecoder",
    "RecurrentModel",
    "WorldModel",
    "Actor",
    "actor_dists",
    "actor_sample",
    "action_dims",
    "sample_stochastic",
    "build_agent",
    "build_training_agent",
]


class CNNEncoder(nn.Module):
    """``stages`` stride-2 4x4 convolutions (no bias), each followed by
    LayerNorm over channels and SiLU; NHWC in, flat (H, W, C) features out."""

    def __init__(self, keys: Sequence[str], input_channels: int, channels_multiplier: int, stages: int = 4) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.stages = int(stages)
        last = int(input_channels)
        for i in range(self.stages):
            ch = (2**i) * int(channels_multiplier)
            # flax padding ((1, 1), (1, 1)) with stride 2 and kernel 4
            self.add_module(f"conv_{i}", Conv2d(last, ch, kernel_size=4, stride=2, padding=1, bias=False))
            self.add_module(f"ln_{i}", LayerNorm(ch, eps=1e-3))
            last = ch

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-1)  # (..., H, W, C)
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
        for i in range(self.stages):
            x = getattr(self, f"conv_{i}")(x)
            x = F.silu(getattr(self, f"ln_{i}")(x.permute(0, 2, 3, 1)))  # NHWC
            if i + 1 < self.stages:
                x = x.permute(0, 3, 1, 2)
        return x.reshape(*lead, -1)  # flattened in (H, W, C) order


class MLPEncoder(nn.Module):
    """Symlog-squashed vector encoder."""

    def __init__(self, keys: Sequence[str], input_dim: int, mlp_layers: int, dense_units: int) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.model = MLP(input_dim, (int(dense_units),) * int(mlp_layers), activation="silu", layer_norm=True)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([symlog(obs[k]) for k in self.keys], dim=-1)
        return self.model(x)


class Encoder(nn.Module):
    def __init__(self, cnn_encoder: Optional[CNNEncoder], mlp_encoder: Optional[MLPEncoder]) -> None:
        super().__init__()
        if cnn_encoder is None and mlp_encoder is None:
            raise ValueError("There must be at least one encoder")
        self.cnn_encoder = cnn_encoder
        self.mlp_encoder = mlp_encoder

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        parts = [m(obs) for m in (self.cnn_encoder, self.mlp_encoder) if m is not None]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


class CNNDecoder(nn.Module):
    """Inverse of :class:`CNNEncoder`: a linear map to a 4x4 feature map in
    (H, W, C) order, then ``stages`` stride-2 4x4 transposed convolutions
    (LayerNorm over channels and SiLU after all but the last). Flat latent
    in, one NHWC tensor per key out, split on channels."""

    def __init__(
        self,
        keys: Sequence[str],
        output_channels: Sequence[int],
        channels_multiplier: int,
        latent_dim: int,
        cnn_encoder_output_dim: int,
        stages: int = 4,
    ) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = tuple(int(c) for c in output_channels)
        self.fc = Dense(int(latent_dim), int(cnn_encoder_output_dim))
        self.hidden = [(2**i) * int(channels_multiplier) for i in reversed(range(int(stages) - 1))]
        last = int(cnn_encoder_output_dim) // 16
        for i, ch in enumerate(self.hidden):
            self.add_module(f"deconv_{i}", ConvTranspose(last, ch, 4, 2, padding=1, bias=False))
            self.add_module(f"ln_{i}", LayerNorm(ch, eps=1e-3))
            last = ch
        self.out = ConvTranspose(last, sum(self.output_channels), 4, 2, padding=1)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        lead = latent.shape[:-1]
        x = self.fc(latent).reshape(-1, 4, 4, self.fc.out_features // 16).permute(0, 3, 1, 2)
        for i in range(len(self.hidden)):
            x = getattr(self, f"deconv_{i}")(x)
            x = F.silu(getattr(self, f"ln_{i}")(x.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)
        x = self.out(x).permute(0, 2, 3, 1)  # NHWC
        x = x.reshape(*lead, *x.shape[1:])
        return dict(zip(self.keys, torch.split(x, list(self.output_channels), dim=-1)))


class MLPDecoder(nn.Module):
    """Inverse of :class:`MLPEncoder`: an MLP and one linear head per key."""

    def __init__(
        self, keys: Sequence[str], output_dims: Sequence[int], latent_dim: int, mlp_layers: int, dense_units: int
    ) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.model = MLP(latent_dim, (int(dense_units),) * int(mlp_layers), activation="silu", layer_norm=True)
        for i, d in enumerate(output_dims):
            self.add_module(f"head_{i}", Dense(int(dense_units), int(d)))

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.model(latent)
        return {k: getattr(self, f"head_{i}")(x) for i, k in enumerate(self.keys)}


class RecurrentModel(nn.Module):
    """MLP, then the LayerNorm-GRU cell."""

    def __init__(self, input_dim: int, recurrent_state_size: int, dense_units: int) -> None:
        super().__init__()
        self.mlp = MLP(input_dim, (int(dense_units),), activation="silu", layer_norm=True)
        self.rnn = LayerNormGRUCell(int(dense_units), int(recurrent_state_size), use_bias=False, layer_norm=True)

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.rnn(recurrent_state, self.mlp(x))


class _StochHead(nn.Module):
    """One hidden layer, then the stochastic-state logits."""

    def __init__(self, input_dim: int, hidden_size: int, stoch_state_size: int) -> None:
        super().__init__()
        self.model = MLP(input_dim, (int(hidden_size),), activation="silu", layer_norm=True)
        self.out = Dense(int(hidden_size), int(stoch_state_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.model(x))


class _PredictionHead(nn.Module):
    """An MLP and a linear output: the reward, continue and critic heads."""

    def __init__(self, input_dim: int, output_dim: int, mlp_layers: int, dense_units: int) -> None:
        super().__init__()
        self.model = MLP(input_dim, (int(dense_units),) * int(mlp_layers), activation="silu", layer_norm=True)
        self.out = Dense(int(dense_units), int(output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.model(x))


def _unimix(logits: torch.Tensor, unimix: float) -> torch.Tensor:
    """Mix the categorical over the last axis with ``unimix`` of uniform."""
    if unimix <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    probs = (1 - unimix) * probs + unimix * (torch.ones_like(probs) / probs.shape[-1])
    return torch.log(probs)


def sample_stochastic(
    logits: torch.Tensor, discrete: int, uniform: Optional[torch.Tensor] = None, sample: bool = True
) -> torch.Tensor:
    """Straight-through sample (or mode) of the grouped categoricals; flat
    ``(..., S*D)`` logits and ``uniform`` in, flat state out."""
    grouped = logits.reshape(*logits.shape[:-1], -1, discrete)
    dist = OneHotCategoricalStraightThrough(grouped)
    if sample:
        out = dist.rsample(uniform=None if uniform is None else uniform.reshape(grouped.shape))
    else:
        out = dist.mode
    return out.reshape(*out.shape[:-2], -1)


#: world-model submodules that only training runs; serving drops their weights
TRAINING_ONLY_MODULES = ("cnn_decoder", "mlp_decoder", "reward_model", "continue_model")


class WorldModel(nn.Module):
    """Encoder, RSSM heads and the learnable initial recurrent state; for
    training also the decoders and the reward and continue heads (None when
    serving). Submodule names are the JAX package's world-model keys."""

    def __init__(
        self,
        encoder: Encoder,
        recurrent_model: RecurrentModel,
        representation_model: _StochHead,
        transition_model: _StochHead,
        recurrent_state_size: int,
        discrete: int = 32,
        unimix: float = 0.01,
        cnn_decoder: Optional[CNNDecoder] = None,
        mlp_decoder: Optional[MLPDecoder] = None,
        reward_model: Optional[_PredictionHead] = None,
        continue_model: Optional[_PredictionHead] = None,
        decoupled: bool = False,
    ) -> None:
        super().__init__()
        self.decoupled = bool(decoupled)
        self.encoder = encoder
        self.recurrent_model = recurrent_model
        self.representation_model = representation_model
        self.transition_model = transition_model
        self.initial_recurrent_state = nn.Parameter(torch.zeros(int(recurrent_state_size)))
        self.discrete = int(discrete)
        self.unimix = float(unimix)
        self.cnn_decoder = cnn_decoder
        self.mlp_decoder = mlp_decoder
        self.reward_model = reward_model
        self.continue_model = continue_model

    def _mix(self, logits: torch.Tensor) -> torch.Tensor:
        grouped = logits.reshape(*logits.shape[:-1], -1, self.discrete)
        return _unimix(grouped, self.unimix).reshape(logits.shape)

    def get_initial_states(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``tanh(initial_recurrent_state)`` for ``n`` rows and the transition
        head's mode there (no sampling)."""
        rec = torch.tanh(self.initial_recurrent_state).expand(int(n), -1)
        post = sample_stochastic(self.transition(rec), self.discrete, sample=False)
        return rec, post

    def representation(self, recurrent_state: Optional[torch.Tensor], embedded_obs: torch.Tensor) -> torch.Tensor:
        """The unimixed posterior logits; decoupled, from the embedded
        observation alone (``recurrent_state`` is then ignored)."""
        inputs = embedded_obs if self.decoupled else torch.cat([recurrent_state, embedded_obs], dim=-1)
        return self._mix(self.representation_model(inputs))

    def transition(self, recurrent_out: torch.Tensor) -> torch.Tensor:
        return self._mix(self.transition_model(recurrent_out))

    def dynamic(
        self,
        posterior: torch.Tensor,
        recurrent_state: torch.Tensor,
        action: torch.Tensor,
        embedded_obs: torch.Tensor,
        is_first: torch.Tensor,
        uniform: Optional[torch.Tensor] = None,
        initial: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """One dynamic-learning step over ``(B, ...)`` rows: where
        ``is_first`` is 1 the action is zeroed and the state restarts from
        ``tanh(initial_recurrent_state)`` and the transition's mode there
        (``initial``, if the caller computed them once for the rollout).
        Returns ``(recurrent', posterior sample, posterior logits, prior
        logits)``; ``uniform`` is the posterior draw's noise."""
        recurrent_state, prior_logits = self.dynamic_decoupled(posterior, recurrent_state, action, is_first, initial)
        posterior_logits = self.representation(recurrent_state, embedded_obs)
        posterior = sample_stochastic(posterior_logits, self.discrete, uniform)
        return recurrent_state, posterior, posterior_logits, prior_logits

    def dynamic_decoupled(
        self,
        posterior: torch.Tensor,
        recurrent_state: torch.Tensor,
        action: torch.Tensor,
        is_first: torch.Tensor,
        initial: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The recurrent half of :meth:`dynamic`, which is the whole step of
        the decoupled RSSM's rollout (its posterior, the previous step's, comes
        from the observations alone): the ``is_first`` restart, then the
        recurrent state and the prior advance. Returns ``(recurrent', prior
        logits)``."""
        if initial is None:
            initial = self.get_initial_states(recurrent_state.shape[0])
        init_rec, init_post = initial
        # every mixed term in the carried state's dtype, as the JAX RSSM casts
        dtype = recurrent_state.dtype
        is_first = is_first.to(dtype)
        action = (1 - is_first) * action.to(dtype)
        recurrent_state = (1 - is_first) * recurrent_state + is_first * init_rec.to(dtype)
        posterior = (1 - is_first) * posterior + is_first * init_post.to(posterior.dtype)
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], dim=-1), recurrent_state)
        return recurrent_state, self.transition(recurrent_state)

    def imagination(
        self, prior: torch.Tensor, recurrent_state: torch.Tensor, actions: torch.Tensor, uniform: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
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
    (discrete), or one ``head_0`` of width ``2 * sum(actions_dim)`` giving
    the mean and the std parameter of every action (continuous)."""

    def __init__(
        self,
        input_dim: int,
        actions_dim: Sequence[int],
        dense_units: int,
        mlp_layers: int,
        unimix: float,
        is_continuous: bool = False,
        distribution: str = "auto",
        init_std: float = 2.0,
        min_std: float = 0.1,
        max_std: float = 1.0,
        action_clip: float = 1.0,
    ):
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.unimix = float(unimix)
        self.is_continuous = bool(is_continuous)
        distribution = str(distribution).lower()
        if distribution == "auto":
            distribution = "scaled_normal" if self.is_continuous else "discrete"
        allowed = ("scaled_normal", "normal", "tanh_normal") if self.is_continuous else ("discrete",)
        if distribution not in allowed:
            raise ValueError(f"distribution.type '{distribution}' does not fit this action space; one of {allowed}")
        self.distribution = distribution
        self.init_std, self.min_std, self.max_std = float(init_std), float(min_std), float(max_std)
        self.action_clip = float(action_clip)
        self.model = MLP(input_dim, (int(dense_units),) * int(mlp_layers), activation="silu", layer_norm=True)
        widths = [2 * sum(self.actions_dim)] if self.is_continuous else list(self.actions_dim)
        for i, d in enumerate(widths):
            self.add_module(f"head_{i}", Dense(int(dense_units), d))
        self.n_heads = len(widths)

    def forward(self, state: torch.Tensor) -> List[torch.Tensor]:
        x = self.model(state)
        return [getattr(self, f"head_{i}")(x) for i in range(self.n_heads)]


def actor_dists(actor: Actor, pre_dist: List[torch.Tensor]) -> list:
    """The action distributions of the actor's outputs: one one-hot
    categorical per head (unimixed), or for a continuous actor one
    ``Independent`` over the actions: ``scaled_normal`` ``Normal(tanh(mean),
    (max_std - min_std) * sigmoid(std + init_std) + min_std)``, ``normal``
    ``Normal(mean, std)``, ``tanh_normal`` ``TanhNormal(5 tanh(mean / 5),
    softplus(std + init_std) + min_std)``."""
    if not actor.is_continuous:
        return [OneHotCategoricalStraightThrough(_unimix(logits, actor.unimix)) for logits in pre_dist]
    mean, std = torch.chunk(pre_dist[0], 2, dim=-1)
    if actor.distribution == "scaled_normal":
        std = (actor.max_std - actor.min_std) * torch.sigmoid(std + actor.init_std) + actor.min_std
        return [Independent(Normal(torch.tanh(mean), std), 1)]
    if actor.distribution == "normal":
        return [Independent(Normal(mean, std), 1)]
    mean = 5 * torch.tanh(mean / 5)
    std = F.softplus(std + actor.init_std) + actor.min_std
    return [Independent(TanhNormal(mean, std), 1)]


def actor_sample(
    actor: Actor, state: torch.Tensor, noise: Optional[Sequence[torch.Tensor]] = None, greedy: bool = False
) -> Tuple[List[torch.Tensor], list]:
    """Actions from the actor at ``state``: the mode when ``greedy``, else a
    draw with ``noise``, one tensor per head: uniforms for a discrete head
    (a straight-through one-hot), standard normals ``(..., sum(actions_dim))``
    for the continuous head (a reparameterised draw). A continuous action is
    then clipped as the JAX package clips it, ``act * stopgrad(clip /
    max(clip, |act|))``."""
    dists = actor_dists(actor, actor(state))
    if not greedy and (noise is None or len(noise) != len(dists)):
        raise ValueError("sampled actions need one noise tensor per action head")
    if not actor.is_continuous:
        if greedy:
            return [d.mode for d in dists], dists
        return [d.rsample(uniform=u) for d, u in zip(dists, noise)], dists
    act = dists[0].mode if greedy else dists[0].rsample(noise=noise[0])
    if actor.action_clip > 0.0:
        act = act * (actor.action_clip / torch.clamp(act.abs(), min=actor.action_clip)).detach()
    return [act], dists


# -- initialization from a seed (JAX: agent.py:657-711) ----------------------


def _fans(weight: torch.Tensor) -> Tuple[float, float]:
    receptive = float(np.prod(weight.shape[2:])) if weight.ndim > 2 else 1.0
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def _hafner_init(module: nn.Module, generator: torch.Generator) -> None:
    """Every Linear/Conv weight from a truncated normal (cut at 2 std) with
    variance ``2 / (fan_in + fan_out)``, every bias zero."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in, fan_out = _fans(m.weight)
            std = np.sqrt(1.0 / ((fan_in + fan_out) / 2.0)) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def _uniform_output_init(layer: nn.Module, generator: torch.Generator, scale: float) -> None:
    """Hafner's scaled uniform; scale 0 gives zeros."""
    fan_in, fan_out = _fans(layer.weight)
    limit = float(np.sqrt(3 * scale / ((fan_in + fan_out) / 2.0)))
    if limit > 0:
        nn.init.uniform_(layer.weight, -limit, limit, generator=generator)
    else:
        nn.init.zeros_(layer.weight)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def action_dims(spaces: Any) -> Tuple[bool, Tuple[int, ...]]:
    """``(is_continuous, actions_dim)`` of a run config's ``spaces`` block:
    a Box's shape, or the categorical sizes of the discrete heads."""
    actions = spaces.actions
    if actions.get("continuous", False):
        return True, tuple(int(d) for d in actions.shape)
    return False, tuple(int(d) for d in actions.n)


def _modules(cfg: Any, training: bool) -> Tuple[WorldModel, Actor, Optional[_PredictionHead]]:
    """The modules for ``cfg``, not yet initialised: the serving subset, or
    with ``training`` the whole world model and the critic."""
    wm_cfg = cfg.algo.world_model
    spaces = cfg.spaces
    is_continuous, actions_dim = action_dims(spaces)
    recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    discrete = int(wm_cfg.discrete_size)
    stoch_state_size = int(wm_cfg.stochastic_size) * discrete
    latent_dim = stoch_state_size + recurrent_state_size
    decoupled = bool(wm_cfg.get("decoupled_rssm", False))

    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    obs = spaces.obs
    screen = int(cfg.env.screen_size)
    stages = int(np.log2(screen) - np.log2(4))
    cnn_channels = [int(np.prod(obs[k].shape[2:] or (1,))) for k in cnn_keys]
    cnn_encoder = mlp_encoder = None
    cnn_encoder_output_dim = (2 ** (stages - 1)) * int(wm_cfg.encoder.cnn_channels_multiplier) * 4 * 4
    encoder_output_dim = 0
    if cnn_keys:
        cnn_encoder = CNNEncoder(cnn_keys, sum(cnn_channels), int(wm_cfg.encoder.cnn_channels_multiplier), stages)
        encoder_output_dim += cnn_encoder_output_dim
    if mlp_keys:
        mlp_in = sum(int(np.prod(obs[k].shape)) for k in mlp_keys)
        mlp_encoder = MLPEncoder(mlp_keys, mlp_in, int(wm_cfg.encoder.mlp_layers), int(wm_cfg.encoder.dense_units))
        encoder_output_dim += int(wm_cfg.encoder.dense_units)

    heads: Dict[str, Any] = {}
    critic = None
    if training:
        obs_cfg = wm_cfg.observation_model
        cnn_dec = list(cfg.algo.cnn_keys.get("decoder", cnn_keys))
        mlp_dec = list(cfg.algo.mlp_keys.get("decoder", mlp_keys))
        if cnn_dec:
            heads["cnn_decoder"] = CNNDecoder(
                cnn_dec,
                [int(np.prod(obs[k].shape[2:] or (1,))) for k in cnn_dec],
                int(obs_cfg.cnn_channels_multiplier),
                latent_dim,
                cnn_encoder_output_dim,
                stages,
            )
        if mlp_dec:
            heads["mlp_decoder"] = MLPDecoder(
                mlp_dec,
                [int(np.prod(obs[k].shape)) for k in mlp_dec],
                latent_dim,
                int(obs_cfg.mlp_layers),
                int(obs_cfg.dense_units),
            )
        rew, cont = wm_cfg.reward_model, wm_cfg.discount_model
        heads["reward_model"] = _PredictionHead(latent_dim, int(rew.bins), int(rew.mlp_layers), int(rew.dense_units))
        heads["continue_model"] = _PredictionHead(latent_dim, 1, int(cont.mlp_layers), int(cont.dense_units))
        critic_cfg = cfg.algo.critic
        critic = _PredictionHead(
            latent_dim, int(critic_cfg.bins), int(critic_cfg.mlp_layers), int(critic_cfg.dense_units)
        )

    world_model = WorldModel(
        Encoder(cnn_encoder, mlp_encoder),
        RecurrentModel(stoch_state_size + sum(actions_dim), recurrent_state_size, int(wm_cfg.recurrent_model.dense_units)),
        _StochHead(
            encoder_output_dim + (0 if decoupled else recurrent_state_size),
            int(wm_cfg.representation_model.hidden_size),
            stoch_state_size,
        ),
        _StochHead(recurrent_state_size, int(wm_cfg.transition_model.hidden_size), stoch_state_size),
        recurrent_state_size,
        discrete=discrete,
        unimix=float(cfg.algo.unimix),
        decoupled=decoupled,
        **heads,
    )
    actor_cfg = cfg.algo.actor
    actor = Actor(
        latent_dim,
        actions_dim,
        int(actor_cfg.dense_units),
        int(actor_cfg.mlp_layers),
        float(cfg.algo.unimix),
        is_continuous=is_continuous,
        distribution=(cfg.get("distribution") or {}).get("type", "auto"),
        init_std=float(actor_cfg.get("init_std", 2.0)),
        min_std=float(actor_cfg.get("min_std", 0.1)),
        max_std=float(actor_cfg.get("max_std", 1.0)),
        action_clip=float(actor_cfg.get("action_clip", 1.0)),
    )
    dtype = compute_dtype(cfg)
    for m in (world_model, actor, critic):
        if m is not None:
            set_compute_dtype(m, dtype)
    return world_model, actor, critic


def _init_weights(world_model: WorldModel, actor: Actor, critic: Optional[_PredictionHead], seed: int) -> None:
    """Hafner's initialisation from ``seed``, with the JAX package's output
    scales (agent.py:889-923): transition, representation, actor heads,
    continue head and decoder outputs at 1.0; reward head and critic output
    at 0.0, i.e. zeros. The serving subset is drawn first, so it is the same
    whether or not the training heads exist."""
    generator = torch.Generator().manual_seed(int(seed))
    serving = [world_model.encoder, world_model.recurrent_model, world_model.representation_model]
    serving.append(world_model.transition_model)
    with torch.no_grad():
        for m in serving + [actor]:
            _hafner_init(m, generator)
        _uniform_output_init(world_model.transition_model.out, generator, 1.0)
        _uniform_output_init(world_model.representation_model.out, generator, 1.0)
        for i in range(actor.n_heads):
            _uniform_output_init(getattr(actor, f"head_{i}"), generator, 1.0)
        if critic is None:
            return
        for name in TRAINING_ONLY_MODULES:
            if getattr(world_model, name) is not None:
                _hafner_init(getattr(world_model, name), generator)
        _hafner_init(critic, generator)
        _uniform_output_init(world_model.reward_model.out, generator, 0.0)
        _uniform_output_init(world_model.continue_model.out, generator, 1.0)
        _uniform_output_init(critic.out, generator, 0.0)
        if world_model.cnn_decoder is not None:
            _uniform_output_init(world_model.cnn_decoder.out.ConvTranspose_0, generator, 1.0)
        if world_model.mlp_decoder is not None:
            for i in range(len(world_model.mlp_decoder.keys)):
                _uniform_output_init(getattr(world_model.mlp_decoder, f"head_{i}"), generator, 1.0)


def build_agent(cfg: Any, device: "torch.device | str" = "cpu", state: Optional[Dict[str, Any]] = None) -> Tuple[WorldModel, Actor]:
    """The serving world model and actor for ``cfg`` (a run config with
    ``algo``, ``env``, ``seed`` and ``spaces``), initialised on the CPU with
    Hafner's scheme from ``cfg.seed``, then loaded from ``state``
    (``{"world_model": ..., "actor": ...}`` state dicts; a training
    checkpoint's decoder and head weights are dropped) where given, and moved
    to ``device``."""
    world_model, actor, _ = _modules(cfg, training=False)
    _init_weights(world_model, actor, None, int(cfg.get("seed") or 0))
    if state is not None:
        wm_state = {k: v for k, v in state["world_model"].items() if k.split(".")[0] not in TRAINING_ONLY_MODULES}
        world_model.load_state_dict(wm_state)
        actor.load_state_dict(state["actor"])
    return world_model.to(device).eval(), actor.to(device).eval()


def build_training_agent(
    cfg: Any, device: "torch.device | str" = "cpu", state: Optional[Dict[str, Any]] = None
) -> Tuple[WorldModel, Actor, _PredictionHead, _PredictionHead]:
    """World model (with decoders, reward and continue heads), actor, critic
    and target critic for training, initialised as :func:`build_agent` does
    (the target critic a copy of the critic), loaded from ``state``
    (``{"world_model", "actor", "critic", "target_critic"}`` state dicts)
    where given, and moved to ``device``."""
    world_model, actor, critic = _modules(cfg, training=True)
    _init_weights(world_model, actor, critic, int(cfg.get("seed") or 0))
    target_critic = copy.deepcopy(critic)
    if state is not None:
        world_model.load_state_dict(state["world_model"])
        actor.load_state_dict(state["actor"])
        critic.load_state_dict(state["critic"])
        target_critic.load_state_dict(state["target_critic"])
    target_critic.requires_grad_(False)
    return tuple(m.to(device).train() for m in (world_model, actor, critic, target_critic))
