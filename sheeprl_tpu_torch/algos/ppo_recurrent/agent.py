"""Recurrent PPO agent (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/agent.py``): the PPO encoders, then an
LSTM over ``[features, previous actions]``, then the critic, the actor
backbone and the actor heads. Inputs are time-major ``(T, B, ...)``.

The LSTM is ``torch.nn.LSTM`` (cuDNN on the card) with flax's
``OptimizedLSTMCell`` math: gates ``i, f, g, o`` in torch's order, input
projections without a bias and recurrent ones with one. torch's LSTM adds
an input bias too; it is held at zero and out of training
(``requires_grad`` off), so the cell computes what flax's does. flax's carry
is ``(cx, hx)``; this module takes and returns ``(hx, cx)``. A training
sequence runs from its stored ``(hx, cx)`` through its right padding, which
the losses mask out, as the JAX ``nn.scan`` does.

Submodules keep the flax names (``feature_extractor.mlp_encoder``,
``rnn.pre_mlp``, ``rnn.lstm``, ``rnn.post_mlp``, ``critic``,
``actor_backbone``, ``actor_head_{i}``):
:func:`sheeprl_tpu_torch.utils.convert.ppo_recurrent_state_from_jax` carries
a flax tree across.

The session step (:func:`session_step`) is the player's T=1 forward on one
row per session with the row's LSTM pair, previous action, seed and step
counter; sampled draws are ``counter_uniform`` (``counter_normal`` for a
continuous head) of the row's seed and counter, so a batched row equals the
row alone. The offline test episode steps one such row, so a served session
fed the episode's observations gives its actions.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.ppo.agent import (
    CNNEncoder,
    MLPEncoder,
    actor_heads,
    apply_heads,
    dist_terms,
    draw_actions,
    env_actions,
)
from sheeprl_tpu_torch.models import MLP, MultiEncoder, lecun_normal_, set_compute_dtype
from sheeprl_tpu_torch.ops import counter_normal, counter_uniform
from sheeprl_tpu_torch.parallel import compute_dtype

__all__ = [
    "RecurrentModel",
    "RecurrentPPOAgent",
    "RecurrentPPOPlayer",
    "forward_with_actions",
    "sample_actions",
    "initial_state",
    "session_step",
    "build_agent",
]

_TRUNC = 0.87962566103423978  # the std of a unit normal truncated at +-2


def _side_mlp(input_dim: int, cfg: Mapping[str, Any]) -> Optional[MLP]:
    if not cfg.get("apply"):
        return None
    return MLP(input_dim, (int(cfg["dense_units"]),), cfg.get("activation", "relu"), bool(cfg.get("layer_norm")))


class RecurrentModel(nn.Module):
    """Optional pre-MLP, the LSTM over ``(T, B, in)`` from ``(hx, cx)``,
    optional post-MLP: ``(x, hx, cx) -> (out, (hx', cx'))``. Below float32
    the LSTM runs as flax's ``OptimizedLSTMCell(dtype=...)`` computes, one
    step at a time in plain ops (:meth:`_lstm_low`)."""

    dtype: torch.dtype = torch.float32

    def __init__(self, input_size: int, lstm_hidden_size: int, pre_rnn_mlp: Mapping[str, Any],
                 post_rnn_mlp: Mapping[str, Any]) -> None:
        super().__init__()
        self.pre_mlp = _side_mlp(input_size, pre_rnn_mlp)
        lstm_in = self.pre_mlp.output_features if self.pre_mlp is not None else int(input_size)
        self.hidden_size = int(lstm_hidden_size)
        self.lstm = nn.LSTM(lstm_in, self.hidden_size)
        self.lstm.bias_ih_l0.requires_grad_(False)  # flax's input projections carry no bias
        self.post_mlp = _side_mlp(self.hidden_size, post_rnn_mlp)
        self.output_features = self.post_mlp.output_features if self.post_mlp is not None else self.hidden_size

    def forward(self, x: torch.Tensor, hx: torch.Tensor, cx: torch.Tensor):
        if self.pre_mlp is not None:
            x = self.pre_mlp(x)
        if self.dtype != torch.float32:
            out, (h, c) = self._lstm_low(x, hx, cx)
        else:
            out, (h, c) = self.lstm(x, (hx[None].contiguous(), cx[None].contiguous()))
            h, c = h[0], c[0]
        if self.post_mlp is not None:
            out = self.post_mlp(out)
        return out, (h, c)

    def _lstm_low(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """flax's ``OptimizedLSTMCell`` in ``self.dtype``: per step the
        hidden projection with its bias and the input projection, each rounded
        to the dtype, summed; the gates; ``c' = f c + i g`` and ``h' = o
        tanh(c')``, whose dtype follows the carry's (float32 carries stay
        float32, as in flax). The weights are torch's, in its ``i, f, g, o``
        order, which is flax's."""
        dt = self.dtype
        w_ih, w_hh = self.lstm.weight_ih_l0.to(dt), self.lstm.weight_hh_l0.to(dt)
        b_hh = self.lstm.bias_hh_l0.to(dt)
        outs = []
        for t in range(x.shape[0]):
            y = (F.linear(h.to(dt), w_hh) + b_hh) + F.linear(x[t].to(dt), w_ih)
            i, f, g, o = y.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=0), (h, c)


class RecurrentPPOAgent(nn.Module):
    """``forward(obs, prev_actions, hx, cx) -> (actor_outs, values, (hx,
    cx))`` over time-major ``(T, B, ...)`` inputs; the encoders fold T into
    the batch."""

    def __init__(
        self,
        actions_dim: Sequence[int],
        is_continuous: bool,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        encoder_cfg: Mapping[str, Any],
        rnn_cfg: Mapping[str, Any],
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
            mlp_encoder = MLPEncoder(mlp_keys, mlp_in, encoder_cfg.get("mlp_features_dim"),
                                     int(encoder_cfg["dense_units"]), int(encoder_cfg["mlp_layers"]),
                                     encoder_cfg["dense_act"], bool(encoder_cfg["layer_norm"]))
        self.feature_extractor = MultiEncoder(cnn_encoder, mlp_encoder)
        self.rnn = RecurrentModel(self.feature_extractor.output_features + int(sum(self.actions_dim)),
                                  int(rnn_cfg["lstm"]["hidden_size"]), rnn_cfg["pre_rnn_mlp"], rnn_cfg["post_rnn_mlp"])
        width = self.rnn.output_features
        self.critic = MLP(width, (int(critic_cfg["dense_units"]),) * int(critic_cfg["mlp_layers"]),
                          critic_cfg["dense_act"], bool(critic_cfg["layer_norm"]), 1)
        self.actor_backbone = MLP(width, (int(actor_cfg["dense_units"]),) * int(actor_cfg["mlp_layers"]),
                                  actor_cfg["dense_act"], bool(actor_cfg["layer_norm"]))
        actor_heads(self, self.actor_backbone.output_features, self.actions_dim, self.is_continuous)

    def trainable_parameters(self) -> List[nn.Parameter]:
        """Every parameter but the LSTM's held-zero input bias."""
        return [p for p in self.parameters() if p.requires_grad]

    def forward(self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, hx: torch.Tensor, cx: torch.Tensor):
        T, B = prev_actions.shape[0], prev_actions.shape[1]
        feat = self.feature_extractor({k: v.reshape(T * B, *v.shape[2:]) for k, v in obs.items()}).reshape(T, B, -1)
        out, states = self.rnn(torch.cat([feat, prev_actions], dim=-1), hx, cx)
        return apply_heads(self, self.actor_backbone(out)), self.critic(out), states


def forward_with_actions(agent: RecurrentPPOAgent, obs, prev_actions, hx, cx, actions: Sequence[torch.Tensor]):
    """The train path: log-prob and entropy of the stored actions (one
    tensor per head), summed over the heads, and the values, each ``(T, B,
    1)``."""
    actor_outs, values, _ = agent(obs, prev_actions, hx, cx)
    logprob, entropy = dist_terms(actor_outs, agent.is_continuous, actions)
    return logprob, entropy, values


def sample_actions(
    agent: RecurrentPPOAgent,
    obs,
    prev_actions,
    hx,
    cx,
    generator: Optional[torch.Generator] = None,
    greedy: bool = False,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    noise: Optional[torch.Tensor] = None,
):
    """The player's forward: ``(actions per head, log-prob (T, B, 1),
    values (T, B, 1), (hx', cx'))``; the draws as PPO's ``draw_actions``
    takes them."""
    actor_outs, values, states = agent(obs, prev_actions, hx, cx)
    acts, logprob = draw_actions(actor_outs, agent.is_continuous, generator, greedy, uniforms, noise)
    return acts, logprob, values, states


class RecurrentPPOPlayer:
    """The env-side policy: one T=1 forward per env step with the carried
    ``(hx, cx)``, no gradients, the draws from ``generator``."""

    def __init__(self, agent: RecurrentPPOAgent, generator: Optional[torch.Generator] = None) -> None:
        self.agent = agent
        self.generator = generator

    def reset_states(self, n: int, device: "torch.device | str") -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.agent.rnn.hidden_size
        return torch.zeros((n, h), device=device), torch.zeros((n, h), device=device)

    @torch.no_grad()
    def __call__(self, obs, prev_actions, states, greedy: bool = False):
        return sample_actions(self.agent, obs, prev_actions, states[0], states[1], self.generator, greedy)

    @torch.no_grad()
    def get_values(self, obs, prev_actions, states):
        _, values, new_states = self.agent(obs, prev_actions, states[0], states[1])
        return values, new_states


def initial_state(agent: RecurrentPPOAgent, n: int, seed: int, device: "torch.device | str") -> Dict[str, torch.Tensor]:
    """``n`` fresh session rows: a zero LSTM pair, no previous action,
    ``seed``, step 0."""
    h = agent.rnn.hidden_size
    return {
        "hx": torch.zeros((n, h), device=device),
        "cx": torch.zeros((n, h), device=device),
        "prev_actions": torch.zeros((n, int(sum(agent.actions_dim))), device=device),
        "seed": torch.full((n,), int(seed), dtype=torch.int64, device=device),
        "counter": torch.zeros((n,), dtype=torch.int64, device=device),
    }


def session_step(
    agent: RecurrentPPOAgent, obs: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor], greedy: bool
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One T=1 step of every row (``obs`` batch-major ``(B, ...)``): the env
    actions ``(B, action_dim)`` and the advanced rows. Sample mode draws
    discrete head ``i`` from stream ``i`` of the row's ``(seed, counter)``,
    a continuous head from stream 0's normals."""
    uniforms = noise = None
    if not greedy:
        seed, counter = state["seed"], state["counter"]
        if agent.is_continuous:
            noise = counter_normal(seed, counter, 0, int(sum(agent.actions_dim)))[None]
        else:
            uniforms = [counter_uniform(seed, counter, i, d)[None] for i, d in enumerate(agent.actions_dim)]
    acts, _, _, (hx, cx) = sample_actions(agent, {k: v[None] for k, v in obs.items()}, state["prev_actions"][None],
                                          state["hx"], state["cx"], greedy=greedy, uniforms=uniforms, noise=noise)
    new_state = {
        "hx": hx,
        "cx": cx,
        "prev_actions": torch.cat(acts, dim=-1)[0],
        "seed": state["seed"],
        "counter": state["counter"] + 1,
    }
    return env_actions(acts, agent.is_continuous)[0], new_state


def _init_lstm(lstm: nn.LSTM, generator: torch.Generator) -> None:
    """flax's ``OptimizedLSTMCell`` initialisation per gate: input kernels
    lecun-normal (truncated at 2 std, variance 1 / fan_in), recurrent
    kernels orthogonal, biases zero."""
    h = lstm.hidden_size
    std = np.sqrt(1.0 / lstm.input_size) / _TRUNC
    for g in range(4):
        nn.init.trunc_normal_(lstm.weight_ih_l0[g * h:(g + 1) * h], 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        nn.init.orthogonal_(lstm.weight_hh_l0[g * h:(g + 1) * h], generator=generator)
    nn.init.zeros_(lstm.bias_ih_l0)
    nn.init.zeros_(lstm.bias_hh_l0)


def build_agent(
    cfg: Any,
    actions_dim: Sequence[int],
    is_continuous: bool,
    obs_spaces: Mapping[str, Mapping[str, Any]],
    device: "torch.device | str" = "cpu",
    agent_state: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[RecurrentPPOAgent, RecurrentPPOPlayer]:
    """The agent for ``cfg``, initialised on the CPU from ``cfg.seed`` as
    flax does, then loaded from ``agent_state`` where given and moved to
    ``device``; and the player over it, drawing from ``generator``."""
    agent = RecurrentPPOAgent(
        actions_dim,
        is_continuous,
        list(cfg.algo.cnn_keys.encoder),
        list(cfg.algo.mlp_keys.encoder),
        cfg.algo.encoder,
        cfg.algo.rnn,
        cfg.algo.actor,
        cfg.algo.critic,
        {k: tuple(v["shape"]) for k, v in obs_spaces.items()},
        int(cfg.env.screen_size),
    )
    init_gen = torch.Generator().manual_seed(int(cfg.get("seed") or 0))
    with torch.no_grad():
        lecun_normal_(agent, init_gen)
        _init_lstm(agent.rnn.lstm, init_gen)
    set_compute_dtype(agent, compute_dtype(cfg))
    if agent_state is not None:
        agent.load_state_dict(agent_state)
    agent = agent.to(device)
    agent.rnn.lstm.flatten_parameters()
    return agent, RecurrentPPOPlayer(agent, generator)
