"""DreamerV3 agent, the subset that serving runs (counterpart of
``sheeprl_tpu/algos/dreamer_v3/agent.py``): the encoders, the RSSM's
recurrent, representation and transition models, and the discrete actor.
The decoders and the reward, continue and critic heads belong to training.

Pixels stay NHWC at every public function, as in the JAX package; the
convolutions run NCHW inside, LayerNorm runs over channels, and the encoder
flattens in (H, W, C) order so converted weights see the features in the
order they were trained on.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.distributions import OneHotCategoricalStraightThrough
from sheeprl_tpu_torch.models import MLP, LayerNormGRUCell
from sheeprl_tpu_torch.ops import symlog

__all__ = [
    "CNNEncoder",
    "MLPEncoder",
    "Encoder",
    "RecurrentModel",
    "WorldModel",
    "Actor",
    "actor_dists",
    "actor_sample",
    "sample_stochastic",
    "build_agent",
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
            self.add_module(f"conv_{i}", nn.Conv2d(last, ch, kernel_size=4, stride=2, padding=1, bias=False))
            self.add_module(f"ln_{i}", nn.LayerNorm(ch, eps=1e-3))
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
        self.out = nn.Linear(int(hidden_size), int(stoch_state_size))

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


class WorldModel(nn.Module):
    """The serving subset of the world model: encoder and RSSM heads, plus
    the learnable initial recurrent state."""

    def __init__(
        self,
        encoder: Encoder,
        recurrent_model: RecurrentModel,
        representation_model: _StochHead,
        transition_model: _StochHead,
        recurrent_state_size: int,
        discrete: int = 32,
        unimix: float = 0.01,
    ) -> None:
        super().__init__()
        self.encoder = encoder
        self.recurrent_model = recurrent_model
        self.representation_model = representation_model
        self.transition_model = transition_model
        self.initial_recurrent_state = nn.Parameter(torch.zeros(int(recurrent_state_size)))
        self.discrete = int(discrete)
        self.unimix = float(unimix)

    def _mix(self, logits: torch.Tensor) -> torch.Tensor:
        grouped = logits.reshape(*logits.shape[:-1], -1, self.discrete)
        return _unimix(grouped, self.unimix).reshape(logits.shape)

    def get_initial_states(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``tanh(initial_recurrent_state)`` for ``n`` rows and the transition
        head's mode there (no sampling)."""
        rec = torch.tanh(self.initial_recurrent_state).expand(int(n), -1)
        post = sample_stochastic(self.transition(rec), self.discrete, sample=False)
        return rec, post

    def representation(self, recurrent_state: torch.Tensor, embedded_obs: torch.Tensor) -> torch.Tensor:
        return self._mix(self.representation_model(torch.cat([recurrent_state, embedded_obs], dim=-1)))

    def transition(self, recurrent_out: torch.Tensor) -> torch.Tensor:
        return self._mix(self.transition_model(recurrent_out))


class Actor(nn.Module):
    """Discrete task actor: an MLP and one logits head per action dimension."""

    def __init__(self, input_dim: int, actions_dim: Sequence[int], dense_units: int, mlp_layers: int, unimix: float):
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.unimix = float(unimix)
        self.model = MLP(input_dim, (int(dense_units),) * int(mlp_layers), activation="silu", layer_norm=True)
        for i, d in enumerate(self.actions_dim):
            self.add_module(f"head_{i}", nn.Linear(int(dense_units), d))

    def forward(self, state: torch.Tensor) -> List[torch.Tensor]:
        x = self.model(state)
        return [getattr(self, f"head_{i}")(x) for i in range(len(self.actions_dim))]


def actor_dists(actor: Actor, pre_dist: List[torch.Tensor]) -> List[OneHotCategoricalStraightThrough]:
    return [OneHotCategoricalStraightThrough(_unimix(logits, actor.unimix)) for logits in pre_dist]


def actor_sample(
    actor: Actor, state: torch.Tensor, uniforms: Optional[Sequence[torch.Tensor]] = None, greedy: bool = False
) -> Tuple[List[torch.Tensor], List[OneHotCategoricalStraightThrough]]:
    """One-hot actions per head: the mode when ``greedy``, else a
    straight-through draw with ``uniforms[i]`` as head ``i``'s noise."""
    dists = actor_dists(actor, actor(state))
    if greedy:
        return [d.mode for d in dists], dists
    if uniforms is None or len(uniforms) != len(dists):
        raise ValueError("sampled actions need one uniform tensor per action head")
    return [d.rsample(uniform=u) for d, u in zip(dists, uniforms)], dists


# -- initialization from a seed (JAX: agent.py:657-711) ----------------------


def _fans(weight: torch.Tensor) -> Tuple[float, float]:
    receptive = float(np.prod(weight.shape[2:])) if weight.ndim > 2 else 1.0
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def _hafner_init(module: nn.Module, generator: torch.Generator) -> None:
    """Every Linear/Conv weight from a truncated normal (cut at 2 std) with
    variance ``2 / (fan_in + fan_out)``, every bias zero."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in, fan_out = _fans(m.weight)
            std = np.sqrt(1.0 / ((fan_in + fan_out) / 2.0)) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def _uniform_output_init(layer: nn.Linear, generator: torch.Generator, scale: float) -> None:
    fan_in, fan_out = _fans(layer.weight)
    limit = float(np.sqrt(3 * scale / ((fan_in + fan_out) / 2.0)))
    if limit > 0:
        nn.init.uniform_(layer.weight, -limit, limit, generator=generator)
    else:
        nn.init.zeros_(layer.weight)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def build_agent(cfg: Any, device: "torch.device | str" = "cpu", state: Optional[Dict[str, Any]] = None) -> Tuple[WorldModel, Actor]:
    """The world model and actor for ``cfg`` (a run config with ``algo``,
    ``env``, ``seed`` and ``spaces``), initialised on the CPU with Hafner's
    scheme from ``cfg.seed``, then loaded from ``state`` (``{"world_model":
    ..., "actor": ...}`` state dicts) where given, and moved to ``device``."""
    wm_cfg = cfg.algo.world_model
    spaces = cfg.spaces
    if spaces.actions.get("continuous", False):
        raise NotImplementedError("continuous DreamerV3 actor heads are not ported yet; discrete actions only")
    actions_dim = tuple(int(d) for d in spaces.actions.n)
    recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    discrete = int(wm_cfg.discrete_size)
    stoch_state_size = int(wm_cfg.stochastic_size) * discrete
    if wm_cfg.get("decoupled_rssm", False):
        raise NotImplementedError("the decoupled RSSM is not ported yet")

    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    obs = spaces.obs
    screen = int(cfg.env.screen_size)
    stages = int(np.log2(screen) - np.log2(4))
    cnn_encoder = mlp_encoder = None
    encoder_output_dim = 0
    if cnn_keys:
        channels = sum(int(np.prod(obs[k].shape[2:] or (1,))) for k in cnn_keys)
        mult = int(wm_cfg.encoder.cnn_channels_multiplier)
        cnn_encoder = CNNEncoder(cnn_keys, channels, mult, stages)
        encoder_output_dim += (2 ** (stages - 1)) * mult * 4 * 4
    if mlp_keys:
        mlp_in = sum(int(np.prod(obs[k].shape)) for k in mlp_keys)
        mlp_encoder = MLPEncoder(mlp_keys, mlp_in, int(wm_cfg.encoder.mlp_layers), int(wm_cfg.encoder.dense_units))
        encoder_output_dim += int(wm_cfg.encoder.dense_units)

    world_model = WorldModel(
        Encoder(cnn_encoder, mlp_encoder),
        RecurrentModel(stoch_state_size + sum(actions_dim), recurrent_state_size, int(wm_cfg.recurrent_model.dense_units)),
        _StochHead(
            encoder_output_dim + recurrent_state_size,
            int(wm_cfg.representation_model.hidden_size),
            stoch_state_size,
        ),
        _StochHead(recurrent_state_size, int(wm_cfg.transition_model.hidden_size), stoch_state_size),
        recurrent_state_size,
        discrete=discrete,
        unimix=float(cfg.algo.unimix),
    )
    actor = Actor(
        stoch_state_size + recurrent_state_size,
        actions_dim,
        int(cfg.algo.actor.dense_units),
        int(cfg.algo.actor.mlp_layers),
        float(cfg.algo.unimix),
    )

    generator = torch.Generator().manual_seed(int(cfg.get("seed") or 0))
    with torch.no_grad():
        _hafner_init(world_model, generator)
        _hafner_init(actor, generator)
        _uniform_output_init(world_model.transition_model.out, generator, 1.0)
        _uniform_output_init(world_model.representation_model.out, generator, 1.0)
        for i in range(len(actions_dim)):
            _uniform_output_init(getattr(actor, f"head_{i}"), generator, 1.0)
    if state is not None:
        world_model.load_state_dict(state["world_model"])
        actor.load_state_dict(state["actor"])
    return world_model.to(device).eval(), actor.to(device).eval()
