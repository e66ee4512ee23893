"""PPO agent (counterpart of ``sheeprl_tpu/algos/ppo/agent.py``): one module
holding the encoders, the critic and the actor, and the player that steps
the envs with it.

Submodules keep the flax names (``feature_extractor`` with its
``cnn_encoder/nature`` and ``mlp_encoder/mlp``, ``critic``,
``actor_backbone``, ``actor_head_{i}``), so a converted flax tree
(:func:`sheeprl_tpu_torch.utils.convert.ppo_state_from_jax`) loads into the
``state_dict`` one to one. Discrete and multi-discrete action spaces get
one categorical head per sub-action, sampled Gumbel-max over uniforms from
an explicit ``torch.Generator`` as ``jax.random.categorical`` draws it. A
continuous (Box) space gets one head of width ``2 * sum(actions_dim)``, the
mean and the log standard deviation of an ``Independent(Normal)``, sampled
``mean + std * eps`` over standard normals drawn the same way; its actions
go to the env raw, unclipped, as the JAX package sends them. The two
frameworks never give the same draws for one seed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.distributions import Independent, Normal, OneHotCategorical
from sheeprl_tpu_torch.models import MLP, Dense, MultiEncoder, NatureCNN, lecun_normal_, set_compute_dtype
from sheeprl_tpu_torch.parallel import compute_dtype

__all__ = [
    "PPOAgent",
    "CNNEncoder",
    "MLPEncoder",
    "actor_heads",
    "apply_heads",
    "action_dists",
    "dist_terms",
    "draw_actions",
    "env_actions",
    "forward_with_actions",
    "sample_actions",
    "PPOPlayer",
    "build_agent",
]

_TINY = float(np.finfo(np.float32).tiny)


class CNNEncoder(nn.Module):
    """NatureCNN over the channel-concatenated pixel keys (NHWC)."""

    def __init__(self, keys: Sequence[str], input_channels: int, screen_size: int, features_dim: int = 512) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.nature = NatureCNN(input_channels, screen_size, features_dim)
        self.output_features = int(features_dim)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.nature(torch.cat([obs[k] for k in self.keys], dim=-1))


class MLPEncoder(nn.Module):
    """An MLP over the concatenated (flat) vector keys, with a last ``out``
    layer of ``features_dim`` where that is set."""

    def __init__(
        self,
        keys: Sequence[str],
        input_dim: int,
        features_dim: Optional[int],
        dense_units: int = 64,
        mlp_layers: int = 2,
        dense_act: str = "relu",
        layer_norm: bool = False,
    ) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.mlp = MLP(input_dim, (int(dense_units),) * int(mlp_layers), dense_act, layer_norm, features_dim)
        self.output_features = self.mlp.output_features

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.mlp(torch.cat([obs[k] for k in self.keys], dim=-1))


def _mlp(input_dim: int, cfg: Mapping[str, Any], output_dim: Optional[int]) -> MLP:
    hidden = (int(cfg["dense_units"]),) * int(cfg["mlp_layers"])
    return MLP(input_dim, hidden, cfg["dense_act"], bool(cfg["layer_norm"]), output_dim)


def actor_heads(module: nn.Module, backbone: int, actions_dim: Sequence[int], is_continuous: bool) -> None:
    """Add the flax-named actor heads to ``module``: ``actor_head_0`` of
    width ``2 * sum(actions_dim)`` (mean, log std) for a continuous space,
    else ``actor_head_{i}`` of width ``actions_dim[i]``."""
    if is_continuous:
        module.add_module("actor_head_0", Dense(backbone, 2 * int(sum(actions_dim))))
    else:
        for i, d in enumerate(actions_dim):
            module.add_module(f"actor_head_{i}", Dense(backbone, int(d)))


def apply_heads(module: nn.Module, backbone: torch.Tensor) -> List[torch.Tensor]:
    return [getattr(module, f"actor_head_{i}")(backbone) for i in range(module.n_heads)]


class PPOAgent(nn.Module):
    """``forward(obs) -> (actor_outs, value)``: one logits tensor per
    sub-action (continuous: one ``[mean, log_std]`` tensor) and the ``(...,
    1)`` value. ``obs_shapes`` maps each key to its shape (pixels NHWC)."""

    def __init__(
        self,
        actions_dim: Sequence[int],
        is_continuous: bool,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        encoder_cfg: Mapping[str, Any],
        actor_cfg: Mapping[str, Any],
        critic_cfg: Mapping[str, Any],
        obs_shapes: Mapping[str, Sequence[int]],
        screen_size: int = 64,
    ) -> None:
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.n_heads = 1 if self.is_continuous else len(self.actions_dim)
        cnn_encoder = mlp_encoder = None
        if cnn_keys:
            channels = sum(int(obs_shapes[k][-1]) for k in cnn_keys)
            cnn_encoder = CNNEncoder(cnn_keys, channels, screen_size, int(encoder_cfg["cnn_features_dim"]))
        if mlp_keys:
            mlp_in = sum(int(np.prod(obs_shapes[k])) for k in mlp_keys)
            mlp_encoder = MLPEncoder(
                mlp_keys,
                mlp_in,
                encoder_cfg.get("mlp_features_dim"),
                int(encoder_cfg["dense_units"]),
                int(encoder_cfg["mlp_layers"]),
                encoder_cfg["dense_act"],
                bool(encoder_cfg["layer_norm"]),
            )
        self.feature_extractor = MultiEncoder(cnn_encoder, mlp_encoder)
        features = self.feature_extractor.output_features
        self.critic = _mlp(features, critic_cfg, 1)
        self.actor_backbone = _mlp(features, actor_cfg, None) if int(actor_cfg["mlp_layers"]) > 0 else None
        backbone = self.actor_backbone.output_features if self.actor_backbone is not None else features
        actor_heads(self, backbone, self.actions_dim, self.is_continuous)

    def forward(self, obs: Dict[str, torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        feat = self.feature_extractor(obs)
        value = self.critic(feat)
        backbone = self.actor_backbone(feat) if self.actor_backbone is not None else feat
        return apply_heads(self, backbone), value


def action_dists(actor_outs: Sequence[torch.Tensor], is_continuous: bool) -> list:
    """One ``Independent(Normal(mean, exp(log_std)))`` over the continuous
    head's two halves, or one ``OneHotCategorical`` per discrete head (JAX
    ``_dists``)."""
    if is_continuous:
        mean, log_std = torch.chunk(actor_outs[0], 2, dim=-1)
        return [Independent(Normal(mean, torch.exp(log_std)), 1)]
    return [OneHotCategorical(logits) for logits in actor_outs]


def dist_terms(
    actor_outs: Sequence[torch.Tensor], is_continuous: bool, actions: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-prob and entropy of the given actions (one tensor per head:
    one-hots, or the continuous action vector), summed over the heads, each
    ``(..., 1)``."""
    dists = action_dists(actor_outs, is_continuous)
    if is_continuous:
        a = torch.cat(list(actions), dim=-1)
        return dists[0].log_prob(a)[..., None], dists[0].entropy()[..., None]
    logprob = torch.stack([d.log_prob(a) for d, a in zip(dists, actions)], dim=-1).sum(dim=-1, keepdim=True)
    entropy = torch.stack([d.entropy() for d in dists], dim=-1).sum(dim=-1, keepdim=True)
    return logprob, entropy


def forward_with_actions(
    agent: PPOAgent, obs: Dict[str, torch.Tensor], actions: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Log-prob and entropy of the given actions (one tensor per head),
    summed over the heads, and the values: each ``(..., 1)``."""
    actor_outs, values = agent(obs)
    logprob, entropy = dist_terms(actor_outs, agent.is_continuous, actions)
    return logprob, entropy, values


def draw_actions(
    actor_outs: Sequence[torch.Tensor],
    is_continuous: bool,
    generator: Optional[torch.Generator] = None,
    greedy: bool = False,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Actions per head (sampled, or the mode with ``greedy``) and their
    summed log-prob ``(..., 1)``. A discrete head ``i`` takes its Gumbel
    noise from ``uniforms[i]`` (shaped like its logits) where given; a
    continuous head its standard normals from ``noise`` (shaped like its
    mean); else each draws from ``generator``."""
    dists = action_dists(actor_outs, is_continuous)
    if is_continuous:
        d = dists[0]
        a = d.mode if greedy else d.sample(generator, noise)
        return (a,), d.log_prob(a)[..., None]
    acts, logprobs = [], []
    for i, (d, logits) in enumerate(zip(dists, actor_outs)):
        if greedy:
            a = d.mode
        elif uniforms is not None:
            a = d.sample(uniform=uniforms[i])
        else:  # uniforms in [tiny, 1), the interval jax.random.categorical draws from
            u = torch.rand(logits.shape, generator=generator, device=logits.device).clamp_(min=_TINY)
            a = d.sample(uniform=u)
        acts.append(a)
        logprobs.append(d.log_prob(a))
    return tuple(acts), torch.stack(logprobs, dim=-1).sum(dim=-1, keepdim=True)


def sample_actions(
    agent: PPOAgent,
    obs: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    greedy: bool = False,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """The player's forward: actions per head (:func:`draw_actions`), their
    summed log-prob ``(..., 1)`` and the values."""
    actor_outs, values = agent(obs)
    acts, logprob = draw_actions(actor_outs, agent.is_continuous, generator, greedy, uniforms, noise)
    return acts, logprob, values


def env_actions(acts: Sequence[torch.Tensor], is_continuous: bool) -> torch.Tensor:
    """What the env takes: the continuous action vector as it is, or each
    discrete head's index ``(..., heads)``."""
    if is_continuous:
        return torch.cat(list(acts), dim=-1)
    return torch.stack([a.argmax(dim=-1) for a in acts], dim=-1)


class PPOPlayer:
    """The env-side policy: one agent forward per env step, no gradients,
    the draws from ``generator`` (on the agent's device)."""

    def __init__(self, agent: PPOAgent, generator: Optional[torch.Generator] = None) -> None:
        self.agent = agent
        self.generator = generator

    @torch.no_grad()
    def rollout_step(
        self, obs: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(env_actions, buffer_actions, logprobs, values)``: the env's
        actions (integer ``(N, heads)``, or the continuous ``(N, dims)``),
        the concatenated one-hots (continuous: the actions again), and
        ``(N, 1)`` each of log-probs and values."""
        acts, logprob, values = sample_actions(self.agent, obs, self.generator)
        return env_actions(acts, self.agent.is_continuous), torch.cat(acts, dim=-1), logprob, values

    @torch.no_grad()
    def get_values(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.agent(obs)[1]

    @torch.no_grad()
    def get_actions(self, obs: Dict[str, torch.Tensor], greedy: bool = False) -> Tuple[torch.Tensor, ...]:
        return sample_actions(self.agent, obs, self.generator, greedy=greedy)[0]


def build_agent(
    cfg: Any,
    actions_dim: Sequence[int],
    is_continuous: bool,
    obs_spaces: Mapping[str, Mapping[str, Any]],
    device: "torch.device | str" = "cpu",
    agent_state: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[PPOAgent, PPOPlayer]:
    """The agent for ``cfg`` (``obs_spaces`` is the run config's
    ``spaces.obs``), initialised on the CPU from ``cfg.seed`` as flax does
    (not torch's default), then loaded from ``agent_state`` where given and
    moved to ``device``; and the player over it, drawing from ``generator``."""
    agent = PPOAgent(
        actions_dim,
        is_continuous,
        list(cfg.algo.cnn_keys.encoder),
        list(cfg.algo.mlp_keys.encoder),
        cfg.algo.encoder,
        cfg.algo.actor,
        cfg.algo.critic,
        {k: tuple(v["shape"]) for k, v in obs_spaces.items()},
        int(cfg.env.screen_size),
    )
    with torch.no_grad():
        lecun_normal_(agent, torch.Generator().manual_seed(int(cfg.get("seed") or 0)))
    set_compute_dtype(agent, compute_dtype(cfg))
    if agent_state is not None:
        agent.load_state_dict(agent_state)
    agent = agent.to(device)
    return agent, PPOPlayer(agent, generator)
