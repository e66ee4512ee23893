"""SAC agent (counterpart of ``sheeprl_tpu/algos/sac/agent.py``): the
squashed-Gaussian actor, an ensemble of ``n`` Q critics, their target copy
and the learnable entropy coefficient, in one module, and the player that
acts with it.

Names follow the flax tree ``{actor, critic, target_critic, log_alpha}``, so
a converted JAX tree (:func:`sheeprl_tpu_torch.utils.convert.sac_state_from_jax`)
loads one to one. The critic ensemble is, as in the JAX package (a flax
``nn.vmap``), ONE batched module: each layer's parameters are stacked on a
leading axis of size ``n`` in flax's layout (``kernel (n, in, out)``,
``bias (n, out)``), and the whole ensemble is one batched matrix product per
layer; its output is ``(batch, n)``. Gaussian noise is an argument of every
sampling function, so a test can feed JAX's own draws; the player draws it
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.models import MLP, Dense, lecun_normal_, set_compute_dtype
from sheeprl_tpu_torch.parallel import compute_dtype

__all__ = [
    "LOG_STD_MAX",
    "LOG_STD_MIN",
    "squashed_gaussian_sample",
    "SACActor",
    "SACCriticEnsemble",
    "SACAgent",
    "SACPlayer",
    "build_agent",
]

LOG_STD_MAX = 2.0
LOG_STD_MIN = -5.0
_LOG_2PI = float(np.log(np.float32(2.0 * np.pi)))


def squashed_gaussian_sample(
    mean: torch.Tensor, std: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, noise: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reparameterized tanh-squashed Gaussian sample rescaled to the action
    bounds, with its ``(..., 1)`` log-prob (Eq. 26 of arXiv:1812.05905), in
    the JAX package's op order; ``noise`` is standard normal, shaped like
    ``mean``. The noise and the bounds are taken in ``mean``'s dtype, as the
    JAX package draws its normals and casts its bounds: below float32 the
    whole sample and its log-prob are in the compute dtype."""
    noise, scale, bias = noise.to(mean.dtype), scale.to(mean.dtype), bias.to(mean.dtype)
    x = mean + std * noise
    y = torch.tanh(x)
    action = y * scale + bias
    log_prob = -0.5 * (((x - mean) / std) ** 2 + 2.0 * torch.log(std) + _LOG_2PI)
    log_prob = log_prob - torch.log(scale * (1.0 - y**2) + 1e-6)
    return action, log_prob.sum(-1, keepdim=True)


class SACActor(nn.Module):
    """``backbone`` (two ReLU layers) then the ``fc_mean`` and ``fc_logstd``
    heads."""

    def __init__(self, obs_dim: int, action_dim: int, hidden_size: int = 256) -> None:
        super().__init__()
        self.backbone = MLP(obs_dim, (hidden_size, hidden_size), "relu")
        self.fc_mean = Dense(hidden_size, action_dim)
        self.fc_logstd = Dense(hidden_size, action_dim)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.backbone(obs)
        return self.fc_mean(x), self.fc_logstd(x)


class _StackedDense(nn.Module):
    """``n`` Dense layers side by side: ``x (n, B, in) -> (n, B, out)``;
    below float32 each computes as :class:`~sheeprl_tpu_torch.models.Dense`."""

    dtype: torch.dtype = torch.float32

    def __init__(self, n: int, in_features: int, out_features: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(n, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(n, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return torch.baddbmm(self.bias.unsqueeze(1), x, self.kernel)
        return torch.bmm(x.to(self.dtype), self.kernel.to(self.dtype)) + self.bias.to(self.dtype).unsqueeze(1)


class _StackedMLP(nn.Module):
    def __init__(self, n: int, in_features: int, hidden_size: int) -> None:
        super().__init__()
        self.dense_0 = _StackedDense(n, in_features, hidden_size)
        self.dense_1 = _StackedDense(n, hidden_size, hidden_size)
        self.out = _StackedDense(n, hidden_size, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.dense_0(x))
        x = torch.relu(self.dense_1(x))
        return self.out(x)


class SACCriticEnsemble(nn.Module):
    """``n`` independent Q(s, a) MLPs (two ReLU layers each) as one batched
    module; ``forward(obs, action) -> (batch, n)``."""

    def __init__(self, obs_dim: int, action_dim: int, n: int = 2, hidden_size: int = 256) -> None:
        super().__init__()
        self.n = int(n)
        self.qfs = nn.ModuleDict({"model": _StackedMLP(self.n, obs_dim + action_dim, hidden_size)})

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, action], dim=-1)
        q = self.qfs["model"](x.unsqueeze(0).expand(self.n, *x.shape))  # (n, batch, 1)
        return q[..., 0].transpose(0, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisation, each critic's slice on its own: kernels
        truncated normal with variance ``1 / fan_in``, biases zero."""
        for layer in self.qfs["model"].children():
            std = math.sqrt(1.0 / layer.kernel.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(layer.kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            layer.bias.zero_()


class SACAgent(nn.Module):
    """``actor``, ``critic``, ``target_critic`` (no gradients; moved by
    :meth:`ema`) and ``log_alpha``, with the functions the train step and
    the player call. ``action_scale``/``action_bias`` map ``tanh`` outputs
    to the action bounds."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        action_low: Sequence[float],
        action_high: Sequence[float],
        actor_hidden: int = 256,
        critic_hidden: int = 256,
        n_critics: int = 2,
        alpha: float = 1.0,
        tau: float = 0.005,
    ) -> None:
        super().__init__()
        self.obs_dim, self.action_dim = int(obs_dim), int(action_dim)
        self.actor = SACActor(obs_dim, action_dim, actor_hidden)
        self.critic = SACCriticEnsemble(obs_dim, action_dim, n_critics, critic_hidden)
        self.target_critic = SACCriticEnsemble(obs_dim, action_dim, n_critics, critic_hidden).requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.log(torch.tensor([float(alpha)], dtype=torch.float32)))
        low, high = np.asarray(action_low, np.float64), np.asarray(action_high, np.float64)
        self.register_buffer("action_scale", torch.from_numpy(((high - low) / 2.0).astype(np.float32)), persistent=False)
        self.register_buffer("action_bias", torch.from_numpy(((high + low) / 2.0).astype(np.float32)), persistent=False)
        self.target_entropy = -float(action_dim)
        self.tau = float(tau)

    # -- actor ---------------------------------------------------------------
    def actor_dist(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, log_std = self.actor(obs)
        return mean, torch.exp(torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX))

    def sample_action(self, obs: torch.Tensor, noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, std = self.actor_dist(obs)
        return squashed_gaussian_sample(mean, std, self.action_scale, self.action_bias, noise)

    def greedy_action(self, obs: torch.Tensor) -> torch.Tensor:
        mean, _ = self.actor(obs)
        return torch.tanh(mean) * self.action_scale.to(mean.dtype) + self.action_bias.to(mean.dtype)

    # -- critics -------------------------------------------------------------
    def q_values(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return self.critic(obs, action)

    @torch.no_grad()
    def next_target_q(
        self, next_obs: torch.Tensor, rewards: torch.Tensor, terminated: torch.Tensor, gamma: float, noise: torch.Tensor
    ) -> torch.Tensor:
        """The TD target from the target ensemble with the entropy bonus."""
        next_action, next_logp = self.sample_action(next_obs, noise)
        q_t = self.target_critic(next_obs, next_action)
        min_q = torch.min(q_t, dim=-1, keepdim=True).values - torch.exp(self.log_alpha) * next_logp
        return rewards + (1.0 - terminated) * gamma * min_q

    @torch.no_grad()
    def ema(self) -> None:
        """Soft target update ``target = tau * critic + (1 - tau) * target``,
        in place."""
        params, targets = list(self.critic.parameters()), list(self.target_critic.parameters())
        moved = torch._foreach_mul(params, self.tau)
        torch._foreach_add_(moved, torch._foreach_mul(targets, 1.0 - self.tau))
        torch._foreach_copy_(targets, moved)


class SACPlayer:
    """The env-side policy over the agent's actor: no gradients, Gaussian
    noise from ``generator`` (on the agent's device)."""

    def __init__(self, agent: SACAgent, generator: Optional[torch.Generator] = None) -> None:
        self.agent = agent
        self.generator = generator

    @torch.no_grad()
    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        return self.get_actions(obs)

    @torch.no_grad()
    def get_actions(self, obs: torch.Tensor, greedy: bool = False) -> torch.Tensor:
        if greedy:
            return self.agent.greedy_action(obs)
        noise = torch.randn((obs.shape[0], self.agent.action_dim), generator=self.generator, device=obs.device)
        return self.agent.sample_action(obs, noise)[0]


def build_agent(
    cfg: Any,
    obs_dim: int,
    action_space: Mapping[str, Any],
    device: "torch.device | str" = "cpu",
    agent_state: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[SACAgent, SACPlayer]:
    """The agent for ``cfg`` over a Box action space (the run config's
    ``spaces.actions``: ``shape``, ``low``, ``high``), initialised on the
    CPU from ``cfg.seed`` as flax does, the target critic a copy of the
    critic; then loaded from ``agent_state`` where given and moved to
    ``device``; and the player over it, drawing from ``generator``."""
    algo = cfg.algo
    agent = SACAgent(
        obs_dim,
        int(np.prod(action_space["shape"])),
        action_space["low"],
        action_space["high"],
        actor_hidden=int(algo.actor.hidden_size),
        critic_hidden=int(algo.critic.hidden_size),
        n_critics=int(algo.critic.n),
        alpha=float(algo.alpha.alpha),
        tau=float(algo.tau),
    )
    with torch.no_grad():
        init = torch.Generator().manual_seed(int(cfg.get("seed") or 0))
        lecun_normal_(agent.actor, init)
        agent.critic.reset_parameters(init)
        agent.target_critic.load_state_dict(agent.critic.state_dict())
    set_compute_dtype(agent, compute_dtype(cfg))
    if agent_state is not None:
        agent.load_state_dict(agent_state)
    agent = agent.to(device)
    return agent, SACPlayer(agent, generator)
