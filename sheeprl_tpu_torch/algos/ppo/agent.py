"""PPO agent (counterpart of ``sheeprl_tpu/algos/ppo/agent.py``): one module
holding the encoders, the critic and the actor, and the player that steps
the envs with it.

Submodules keep the flax names (``feature_extractor`` with its
``cnn_encoder/nature`` and ``mlp_encoder/mlp``, ``critic``,
``actor_backbone``, ``actor_head_{i}``), so a converted flax tree
(:func:`sheeprl_tpu_torch.utils.convert.ppo_state_from_jax`) loads into the
``state_dict`` one to one. Discrete and multi-discrete action spaces are
ported: one categorical head per sub-action. Sampling is Gumbel-max over
uniforms from an explicit ``torch.Generator``, as ``jax.random.categorical``
draws it; the two frameworks never give the same draws for one seed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.distributions import OneHotCategorical
from sheeprl_tpu_torch.models import MLP, MultiEncoder, NatureCNN, lecun_normal_

__all__ = ["PPOAgent", "CNNEncoder", "MLPEncoder", "forward_with_actions", "sample_actions", "PPOPlayer", "build_agent"]

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


class PPOAgent(nn.Module):
    """``forward(obs) -> (actor_outs, value)``: one logits tensor per
    sub-action and the ``(..., 1)`` value. ``obs_shapes`` maps each key to
    its shape (pixels NHWC)."""

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
        if is_continuous:
            raise NotImplementedError(
                "continuous PPO (the Independent(Normal) actor head) is not ported yet; "
                "see ROADMAP.md, 'Left out of slice 3'"
            )
        self.actions_dim = tuple(int(d) for d in actions_dim)
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
        for i, d in enumerate(self.actions_dim):
            self.add_module(f"actor_head_{i}", nn.Linear(backbone, d))

    def forward(self, obs: Dict[str, torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        feat = self.feature_extractor(obs)
        value = self.critic(feat)
        backbone = self.actor_backbone(feat) if self.actor_backbone is not None else feat
        return [getattr(self, f"actor_head_{i}")(backbone) for i in range(len(self.actions_dim))], value


def forward_with_actions(
    agent: PPOAgent, obs: Dict[str, torch.Tensor], actions: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Log-prob and entropy of the given one-hot actions (one tensor per
    head), summed over the heads, and the values: each ``(..., 1)``."""
    actor_outs, values = agent(obs)
    dists = [OneHotCategorical(logits) for logits in actor_outs]
    logprob = torch.stack([d.log_prob(a) for d, a in zip(dists, actions)], dim=-1).sum(dim=-1, keepdim=True)
    entropy = torch.stack([d.entropy() for d in dists], dim=-1).sum(dim=-1, keepdim=True)
    return logprob, entropy, values


def sample_actions(
    agent: PPOAgent,
    obs: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    greedy: bool = False,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """The player's forward: one-hot actions per head (sampled, or the mode
    with ``greedy``), their summed log-prob ``(..., 1)`` and the values.
    Head ``i``'s Gumbel noise comes from ``uniforms[i]`` (shaped like its
    logits) where given, else from ``generator``."""
    actor_outs, values = agent(obs)
    acts, logprobs = [], []
    for i, logits in enumerate(actor_outs):
        d = OneHotCategorical(logits)
        if greedy:
            a = d.mode
        elif uniforms is not None:
            a = d.sample(uniform=uniforms[i])
        else:  # uniforms in [tiny, 1), the interval jax.random.categorical draws from
            u = torch.rand(logits.shape, generator=generator, device=logits.device).clamp_(min=_TINY)
            a = d.sample(uniform=u)
        acts.append(a)
        logprobs.append(d.log_prob(a))
    return tuple(acts), torch.stack(logprobs, dim=-1).sum(dim=-1, keepdim=True), values


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
        integer actions ``(N, heads)``, the concatenated one-hots, and
        ``(N, 1)`` each of log-probs and values."""
        acts, logprob, values = sample_actions(self.agent, obs, self.generator)
        env_actions = torch.stack([a.argmax(dim=-1) for a in acts], dim=-1)
        return env_actions, torch.cat(acts, dim=-1), logprob, values

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
    if agent_state is not None:
        agent.load_state_dict(agent_state)
    agent = agent.to(device)
    return agent, PPOPlayer(agent, generator)
