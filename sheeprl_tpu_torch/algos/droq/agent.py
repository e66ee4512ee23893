"""DroQ agent (counterpart of ``sheeprl_tpu/algos/droq/agent.py``; "Dropout
Q-Functions for Doubly Efficient Reinforcement Learning", arXiv:2110.02034):
SAC's squashed-Gaussian actor and entropy coefficient, with a critic
ensemble whose hidden layers are ``Linear -> Dropout -> LayerNorm(eps 1e-5)
-> ReLU``.

As in the JAX package, the ensemble is ONE batched module (a flax
``nn.vmap``): each layer's parameters are stacked on a leading axis of size
``n`` in flax's layout (``kernel (n, in, out)``, ``bias (n, out)``, LayerNorm
``scale``/``bias (n, features)``), so a converted JAX tree
(:func:`sheeprl_tpu_torch.utils.convert.sac_state_from_jax`) loads one to
one. Dropout is live in both the online and the target pass (the DroQ
estimator). Its masks are ``(2, n, B, hidden)`` ``{0, 1}`` tensors, one per
hidden layer: drawn with ``torch.bernoulli`` from an explicit generator, or
passed in, so a test can feed the masks JAX drew; a kept element is divided
by the keep probability, as flax's ``Dropout`` divides it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.sac.agent import SACAgent, SACPlayer, _StackedDense
from sheeprl_tpu_torch.models import lecun_normal_, set_compute_dtype
from sheeprl_tpu_torch.ops import layer_norm
from sheeprl_tpu_torch.parallel import compute_dtype

__all__ = ["DroQCriticEnsemble", "DroQAgent", "build_agent"]


class _StackedLayerNorm(nn.Module):
    """``n`` LayerNorms side by side over ``(n, B, features)``, flax's
    ``scale`` and ``bias`` stacked; below float32 each computes as
    :func:`~sheeprl_tpu_torch.ops.layer_norm`."""

    dtype: torch.dtype = torch.float32

    def __init__(self, n: int, features: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n, features))
        self.bias = nn.Parameter(torch.zeros(n, features))
        self.eps = float(eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype != torch.float32:
            return layer_norm(x, self.scale.unsqueeze(1), self.bias.unsqueeze(1), self.eps, self.dtype)
        x = F.layer_norm(x, x.shape[-1:], eps=self.eps)
        return x * self.scale.unsqueeze(1) + self.bias.unsqueeze(1)


class _DropoutStackedMLP(nn.Module):
    def __init__(self, n: int, in_features: int, hidden_size: int) -> None:
        super().__init__()
        self.dense_0 = _StackedDense(n, in_features, hidden_size)
        self.ln_0 = _StackedLayerNorm(n, hidden_size)
        self.dense_1 = _StackedDense(n, hidden_size, hidden_size)
        self.ln_1 = _StackedLayerNorm(n, hidden_size)
        self.out = _StackedDense(n, hidden_size, 1)

    def forward(self, x: torch.Tensor, masks: Optional[torch.Tensor], keep: float) -> torch.Tensor:
        for i in range(2):
            x = getattr(self, f"dense_{i}")(x)
            if masks is not None:
                x = x * masks[i].to(x.dtype) / keep
            x = torch.relu(getattr(self, f"ln_{i}")(x))
        return self.out(x)


class DroQCriticEnsemble(nn.Module):
    """``n`` Q(s, a) MLPs with dropout and LayerNorm as one batched module;
    ``forward(obs, action, masks) -> (batch, n)``. ``masks`` None runs
    without dropout (``dropout`` 0)."""

    def __init__(self, obs_dim: int, action_dim: int, n: int = 2, hidden_size: int = 256, dropout: float = 0.0) -> None:
        super().__init__()
        self.n, self.hidden_size = int(n), int(hidden_size)
        self.dropout = float(dropout)
        self.qfs = nn.ModuleDict({"model": _DropoutStackedMLP(self.n, obs_dim + action_dim, self.hidden_size)})

    def draw_masks(self, batch: int, generator: Optional[torch.Generator], device) -> Optional[torch.Tensor]:
        """``(2, n, batch, hidden)`` keep masks, each element kept with
        probability ``1 - dropout``; None without dropout."""
        if self.dropout <= 0.0:
            return None
        keep = torch.full((2, self.n, int(batch), self.hidden_size), 1.0 - self.dropout, device=device)
        return torch.bernoulli(keep, generator=generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor, masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = torch.cat([obs, action], dim=-1)
        q = self.qfs["model"](x.unsqueeze(0).expand(self.n, *x.shape), masks, 1.0 - self.dropout)  # (n, batch, 1)
        return q[..., 0].transpose(0, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisation, each critic's slice on its own: kernels
        truncated normal with variance ``1 / fan_in``, biases zero, LayerNorm
        scales one."""
        for layer in self.qfs["model"].children():
            if isinstance(layer, _StackedDense):
                std = math.sqrt(1.0 / layer.kernel.shape[1]) / 0.87962566103423978
                nn.init.trunc_normal_(layer.kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                layer.bias.zero_()
            else:
                layer.scale.fill_(1.0)
                layer.bias.zero_()


class DroQAgent(SACAgent):
    """:class:`~sheeprl_tpu_torch.algos.sac.agent.SACAgent` with the dropout
    critic ensemble and its target copy; the TD target runs the target
    ensemble with live dropout."""

    def __init__(self, obs_dim: int, action_dim: int, action_low, action_high, actor_hidden: int = 256,
                 critic_hidden: int = 256, n_critics: int = 2, alpha: float = 1.0, tau: float = 0.005,
                 dropout: float = 0.0) -> None:
        super().__init__(obs_dim, action_dim, action_low, action_high, actor_hidden, critic_hidden, n_critics, alpha,
                         tau)
        self.critic = DroQCriticEnsemble(obs_dim, action_dim, n_critics, critic_hidden, dropout)
        self.target_critic = DroQCriticEnsemble(obs_dim, action_dim, n_critics, critic_hidden, dropout)
        self.target_critic.requires_grad_(False)

    @torch.no_grad()
    def next_target_q_droq(self, next_obs: torch.Tensor, rewards: torch.Tensor, terminated: torch.Tensor,
                           gamma: float, noise: torch.Tensor, masks: Optional[torch.Tensor]) -> torch.Tensor:
        """The TD target from the target ensemble (dropout ``masks`` live)
        with the entropy bonus."""
        next_action, next_logp = self.sample_action(next_obs, noise)
        q_t = self.target_critic(next_obs, next_action, masks)
        min_q = torch.min(q_t, dim=-1, keepdim=True).values - torch.exp(self.log_alpha) * next_logp
        return rewards + (1.0 - terminated) * gamma * min_q


def build_agent(
    cfg: Any,
    obs_dim: int,
    action_space: Mapping[str, Any],
    device: "torch.device | str" = "cpu",
    agent_state: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[DroQAgent, SACPlayer]:
    """The agent for ``cfg`` over a Box action space, initialised on the CPU
    from ``cfg.seed`` as flax does (the target critic a copy of the critic),
    loaded from ``agent_state`` where given and moved to ``device``; and the
    SAC player over it, drawing from ``generator``."""
    algo = cfg.algo
    agent = DroQAgent(
        obs_dim,
        int(np.prod(action_space["shape"])),
        action_space["low"],
        action_space["high"],
        actor_hidden=int(algo.actor.hidden_size),
        critic_hidden=int(algo.critic.hidden_size),
        n_critics=int(algo.critic.n),
        alpha=float(algo.alpha.alpha),
        tau=float(algo.tau),
        dropout=float(algo.critic.get("dropout", 0.0)),
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
