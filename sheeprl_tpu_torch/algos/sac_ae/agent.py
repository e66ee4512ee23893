"""SAC-AE agent (counterpart of ``sheeprl_tpu/algos/sac_ae/agent.py``;
"Improving Sample Efficiency in Model-Free Reinforcement Learning from
Images", arXiv:1910.01741): pixel SAC whose encoder is also trained by an
autoencoder.

The layout is the JAX package's: the critic owns the whole encoder (a conv
trunk of four 3x3 convolutions, strides 2, 1, 1, 1, then a Dense, LayerNorm
and tanh head; an MLP over vector keys); the actor reads the SAME trunk's
features with the gradient stopped and applies its OWN Dense/LayerNorm/tanh
head to them; the Q ensemble is one batched module over (features, action)
as SAC's is; the target critic is ``target_encoder`` and ``target_qfs``,
moved by EMAs with their own rates; the decoder maps the encoder's features
back to pixels (a Dense to the trunk's output map, three 3x3 transposed
convolutions and a stride-2 one whose last row and column are zeros) and to
vectors. Submodule and parameter names are the flax tree's, so a converted
JAX tree (:func:`sheeprl_tpu_torch.utils.convert.sac_ae_state_from_jax`)
loads one to one. Pixels are NHWC everywhere outside the convolutions.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.sac.agent import SACCriticEnsemble, squashed_gaussian_sample
from sheeprl_tpu_torch.models import CNN, MLP, ConvTranspose, Dense, LayerNorm, set_compute_dtype
from sheeprl_tpu_torch.parallel import compute_dtype

__all__ = [
    "LOG_STD_MAX",
    "LOG_STD_MIN",
    "SACAEEncoder",
    "ActorEncoderHead",
    "SACAEActorHead",
    "SACAEDecoder",
    "SACAEAgent",
    "SACAEPlayer",
    "conv_output_side",
    "build_agent",
]

LOG_STD_MAX = 2.0
LOG_STD_MIN = -10.0
#: the conv trunk's (stride) per 3x3 VALID convolution
TRUNK_STRIDES = (2, 1, 1, 1)


def conv_output_side(screen_size: int) -> int:
    """The trunk's output side for a ``screen_size`` square input."""
    side = int(screen_size)
    for stride in TRUNK_STRIDES:
        side = (side - 3) // stride + 1
    return side


class SACAEEncoder(nn.Module):
    """``conv`` (the trunk), ``fc`` and ``ln`` over the pixel keys, ``mlp``
    over the vector keys; ``trunk`` exposes the pre-head activations."""

    def __init__(self, cnn_keys: Sequence[str], mlp_keys: Sequence[str], cnn_channels: int, mlp_dim: int,
                 screen_size: int, features_dim: int = 64, channels_multiplier: int = 16, dense_units: int = 64,
                 mlp_layers: int = 2, layer_norm: bool = False) -> None:
        super().__init__()
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.output_features = 0
        if self.cnn_keys:
            width = 32 * int(channels_multiplier)
            self.conv = CNN(int(cnn_channels), [width] * 4,
                            [{"kernel_size": 3, "stride": s} for s in TRUNK_STRIDES], activation="relu")
            self.trunk_features = conv_output_side(screen_size) ** 2 * width
            self.fc = Dense(self.trunk_features, int(features_dim))
            self.ln = LayerNorm(int(features_dim), eps=1e-5)
            self.output_features += int(features_dim)
        if self.mlp_keys:
            self.mlp = MLP(int(mlp_dim), (int(dense_units),) * int(mlp_layers), "relu", layer_norm=bool(layer_norm))
            self.output_features += int(dense_units)

    def trunk(self, obs: Dict[str, torch.Tensor]) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        cnn_flat = mlp_feat = None
        if self.cnn_keys:
            x = torch.cat([obs[k] for k in self.cnn_keys], dim=-1)
            cnn_flat = self.conv(x).reshape(x.shape[0], -1)  # (H, W, C) order, as flax flattens NHWC
        if self.mlp_keys:
            mlp_feat = self.mlp(torch.cat([obs[k] for k in self.mlp_keys], dim=-1))
        return cnn_flat, mlp_feat

    def head(self, cnn_flat: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.ln(self.fc(cnn_flat)))

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        cnn_flat, mlp_feat = self.trunk(obs)
        parts = ([self.head(cnn_flat)] if cnn_flat is not None else []) + ([mlp_feat] if mlp_feat is not None else [])
        return torch.cat(parts, dim=-1)


class ActorEncoderHead(nn.Module):
    """The actor's private Dense, LayerNorm and tanh over the (detached)
    trunk features; flax's unnamed ``Dense_0`` and ``LayerNorm_0``."""

    def __init__(self, trunk_features: int, features_dim: int) -> None:
        super().__init__()
        self.Dense_0 = Dense(int(trunk_features), int(features_dim))
        self.LayerNorm_0 = LayerNorm(int(features_dim), eps=1e-5)

    def forward(self, cnn_flat: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.LayerNorm_0(self.Dense_0(cnn_flat)))


class SACAEActorHead(nn.Module):
    """Two ReLU layers (``model``), then ``fc_mean`` and ``fc_logstd``; the
    log-std squashed by tanh into ``[LOG_STD_MIN, LOG_STD_MAX]``."""

    def __init__(self, features: int, action_dim: int, hidden_size: int = 1024) -> None:
        super().__init__()
        self.model = MLP(int(features), (int(hidden_size), int(hidden_size)), "relu")
        self.fc_mean = Dense(int(hidden_size), int(action_dim))
        self.fc_logstd = Dense(int(hidden_size), int(action_dim))

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.model(feat)
        log_std = torch.tanh(self.fc_logstd(x))
        return self.fc_mean(x), LOG_STD_MIN + 0.5 * (LOG_STD_MAX - LOG_STD_MIN) * (log_std + 1.0)


class _DeCNN(nn.Module):
    """Three 3x3 stride-1 transposed convolutions with ReLU (``deconv_i``)."""

    def __init__(self, in_channels: int, width: int) -> None:
        super().__init__()
        last = int(in_channels)
        for i in range(3):
            self.add_module(f"deconv_{i}", ConvTranspose(last, width, 3, 1))
            last = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = torch.relu(getattr(self, f"deconv_{i}")(x))
        return x


class SACAEDecoder(nn.Module):
    """Pixels: ``fc`` to the trunk's output map, ``deconv`` and ``to_obs``
    (3x3, stride 2, then one zero row and column: 25 -> 31 -> 64 at screen
    64), split on channels per key; vectors: ``mlp`` and a ``head_i`` per
    key. Latent in, NHWC pixels out."""

    def __init__(self, cnn_keys: Sequence[str], mlp_keys: Sequence[str], cnn_channels: Sequence[int],
                 mlp_dims: Sequence[int], latent_dim: int, screen_size: int, channels_multiplier: int = 16,
                 dense_units: int = 64, mlp_layers: int = 2, layer_norm: bool = False) -> None:
        super().__init__()
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.cnn_channels = [int(c) for c in cnn_channels]
        if self.cnn_keys:
            width = 32 * int(channels_multiplier)
            self.side, self.width = conv_output_side(screen_size), width
            self.fc = Dense(int(latent_dim), self.side * self.side * width)
            self.deconv = _DeCNN(width, width)
            self.to_obs = ConvTranspose(width, sum(self.cnn_channels), 3, 2, output_padding=1)
        if self.mlp_keys:
            self.mlp = MLP(int(latent_dim), (int(dense_units),) * int(mlp_layers), "relu", layer_norm=bool(layer_norm))
            for i, d in enumerate(mlp_dims):
                self.add_module(f"head_{i}", Dense(int(dense_units), int(d)))

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.cnn_keys:
            x = self.fc(latent).reshape(-1, self.side, self.side, self.width).permute(0, 3, 1, 2)
            x = self.to_obs(self.deconv(x)).permute(0, 2, 3, 1)  # NHWC
            out.update(zip(self.cnn_keys, torch.split(x, self.cnn_channels, dim=-1)))
        if self.mlp_keys:
            y = self.mlp(latent)
            out.update({k: getattr(self, f"head_{i}")(y) for i, k in enumerate(self.mlp_keys)})
        return out


class SACAEAgent(nn.Module):
    """Every SAC-AE module and ``log_alpha``, with the functions the train
    step and the player call. ``target_encoder`` and ``target_qfs`` take no
    gradient and move by :meth:`ema`."""

    def __init__(self, encoder: SACAEEncoder, actor_enc_head: Optional[ActorEncoderHead], actor: SACAEActorHead,
                 qfs: SACCriticEnsemble, decoder: SACAEDecoder, action_low, action_high, alpha: float,
                 tau: float, encoder_tau: float) -> None:
        super().__init__()
        self.encoder, self.actor_enc_head, self.actor, self.qfs, self.decoder = (
            encoder, actor_enc_head, actor, qfs, decoder)
        self.target_encoder = self._frozen_copy(encoder)
        self.target_qfs = self._frozen_copy(qfs)
        self.log_alpha = nn.Parameter(torch.log(torch.tensor([float(alpha)], dtype=torch.float32)))
        low, high = np.asarray(action_low, np.float64), np.asarray(action_high, np.float64)
        self.register_buffer("action_scale", torch.from_numpy(((high - low) / 2.0).astype(np.float32)), persistent=False)
        self.register_buffer("action_bias", torch.from_numpy(((high + low) / 2.0).astype(np.float32)), persistent=False)
        self.action_dim = int(low.size)
        self.target_entropy = -float(self.action_dim)
        self.tau, self.encoder_tau = float(tau), float(encoder_tau)

    @staticmethod
    def _frozen_copy(module: nn.Module) -> nn.Module:
        return copy.deepcopy(module).requires_grad_(False)

    # -- features ------------------------------------------------------------
    def actor_features(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The trunk's features with the gradient stopped, through the
        actor's own head for pixels."""
        cnn_flat, mlp_feat = self.encoder.trunk(obs)
        parts = []
        if cnn_flat is not None:
            parts.append(self.actor_enc_head(cnn_flat.detach()))
        if mlp_feat is not None:
            parts.append(mlp_feat.detach())
        return torch.cat(parts, dim=-1)

    # -- actor ---------------------------------------------------------------
    def sample_action(self, obs: Dict[str, torch.Tensor], noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, log_std = self.actor(self.actor_features(obs))
        return squashed_gaussian_sample(mean, torch.exp(log_std), self.action_scale, self.action_bias, noise)

    def greedy_action(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        mean, _ = self.actor(self.actor_features(obs))
        return torch.tanh(mean) * self.action_scale.to(mean.dtype) + self.action_bias.to(mean.dtype)

    # -- critic --------------------------------------------------------------
    def q_values(self, obs: Dict[str, torch.Tensor], action: torch.Tensor) -> torch.Tensor:
        return self.qfs(self.encoder(obs), action)

    @torch.no_grad()
    def next_target_q(self, next_obs: Dict[str, torch.Tensor], rewards: torch.Tensor, terminated: torch.Tensor,
                      gamma: float, noise: torch.Tensor) -> torch.Tensor:
        """The TD target from the target encoder and Qs with the entropy bonus."""
        next_action, next_logp = self.sample_action(next_obs, noise)
        q_t = self.target_qfs(self.target_encoder(next_obs), next_action)
        min_q = torch.min(q_t, dim=-1, keepdim=True).values - torch.exp(self.log_alpha) * next_logp
        return rewards + (1.0 - terminated) * gamma * min_q

    @torch.no_grad()
    def ema(self) -> None:
        """``target = tau * online + (1 - tau) * target`` for the Qs and, at
        ``encoder_tau``, the encoder; in place."""
        for online, target, tau in ((self.qfs, self.target_qfs, self.tau),
                                    (self.encoder, self.target_encoder, self.encoder_tau)):
            params, targets = list(online.parameters()), list(target.parameters())
            moved = torch._foreach_mul(params, tau)
            torch._foreach_add_(moved, torch._foreach_mul(targets, 1.0 - tau))
            torch._foreach_copy_(targets, moved)


class SACAEPlayer:
    """The env-side policy over the agent's actor path: no gradients,
    Gaussian noise from ``generator`` (on the agent's device)."""

    def __init__(self, agent: SACAEAgent, generator: Optional[torch.Generator] = None) -> None:
        self.agent = agent
        self.generator = generator

    @torch.no_grad()
    def get_actions(self, obs: Dict[str, torch.Tensor], greedy: bool = False) -> torch.Tensor:
        if greedy:
            return self.agent.greedy_action(obs)
        n = next(iter(obs.values())).shape[0]
        noise = torch.randn((n, self.agent.action_dim), generator=self.generator, device=self.agent.log_alpha.device)
        return self.agent.sample_action(obs, noise)[0]


def _flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisation: every Linear, Conv2d and
    ConvTranspose2d kernel from a normal truncated at 2 std with variance
    ``1 / fan_in`` (a transposed kernel's fan-in is its input channels times
    its window), biases zero; LayerNorms one and zero."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            window = int(np.prod(m.weight.shape[2:]))
            fan_in = (m.weight.shape[0] if isinstance(m, nn.ConvTranspose2d) else m.weight.shape[1]) * window
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def build_agent(
    cfg: Any,
    device: "torch.device | str" = "cpu",
    agent_state: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[SACAEAgent, SACAEPlayer]:
    """The agent for ``cfg`` (a run config with ``spaces``), initialised on
    the CPU from ``cfg.seed`` as flax does (the targets copies), loaded from
    ``agent_state`` where given and moved to ``device``; and the player over
    it, drawing from ``generator``."""
    algo, spaces = cfg.algo, cfg.spaces
    cnn_keys, mlp_keys = list(algo.cnn_keys.encoder), list(algo.mlp_keys.encoder)
    cnn_dec = list(algo.cnn_keys.get("decoder", cnn_keys))
    mlp_dec = list(algo.mlp_keys.get("decoder", mlp_keys))
    channels = {k: int(np.prod(spaces.obs[k].shape[2:] or (1,))) for k in cnn_keys}
    dims = {k: int(np.prod(spaces.obs[k].shape)) for k in mlp_keys}
    screen = int(cfg.env.screen_size)
    enc, dec = algo.encoder, algo.decoder
    encoder = SACAEEncoder(cnn_keys, mlp_keys, sum(channels.values()), sum(dims.values()), screen,
                           int(enc.features_dim), int(enc.cnn_channels_multiplier), int(enc.dense_units),
                           int(enc.mlp_layers), bool(enc.get("layer_norm", False)))
    act_dim = int(np.prod(spaces.actions.shape))
    actor_enc_head = ActorEncoderHead(encoder.trunk_features, int(enc.features_dim)) if cnn_keys else None
    agent = SACAEAgent(
        encoder,
        actor_enc_head,
        SACAEActorHead(encoder.output_features, act_dim, int(algo.actor.hidden_size)),
        SACCriticEnsemble(encoder.output_features, act_dim, int(algo.critic.n), int(algo.critic.hidden_size)),
        SACAEDecoder(cnn_dec, mlp_dec, [channels[k] for k in cnn_dec], [dims[k] for k in mlp_dec],
                     encoder.output_features, screen, int(dec.cnn_channels_multiplier), int(dec.dense_units),
                     int(dec.mlp_layers), bool(dec.get("layer_norm", False))),
        spaces.actions.low,
        spaces.actions.high,
        alpha=float(algo.alpha.alpha),
        tau=float(algo.tau),
        encoder_tau=float(enc.tau),
    )
    with torch.no_grad():
        init = torch.Generator().manual_seed(int(cfg.get("seed") or 0))
        for module in (agent.encoder, agent.actor_enc_head, agent.actor, agent.decoder):
            if module is not None:
                _flax_init_(module, init)
        agent.qfs.reset_parameters(init)
        agent.target_encoder.load_state_dict(agent.encoder.state_dict())
        agent.target_qfs.load_state_dict(agent.qfs.state_dict())
    set_compute_dtype(agent, compute_dtype(cfg))
    if agent_state is not None:
        agent.load_state_dict(agent_state)
    agent = agent.to(device)
    return agent, SACAEPlayer(agent, generator)

