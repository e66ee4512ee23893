"""DreamerV3 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v3/utils.py``)."""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import make_env
from sheeprl_tpu_torch.parallel.comm import all_gather_wire

__all__ = ["AGGREGATOR_KEYS", "prepare_obs", "init_moments", "moments_update", "compute_lambda_values", "test",
           "patch_restarted_envs"]

#: the metrics the DreamerV3 loop aggregates (JAX ``AGGREGATOR_KEYS``)
AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
}


def patch_restarted_envs(restarted: Sequence[bool], dones: np.ndarray, step_data: Dict[str, np.ndarray],
                         rb: Any = None, driver: Any = None) -> None:
    """The JAX Dreamer loops' ``restart_on_exception`` patch: for each env
    rebuilt by ``RestartOnException`` in a step that did not end its
    episode, the env's last stored row (the host buffer's, or the
    ring driver's newest staged one) becomes truncated, not terminated and
    not first (the ring stores no ``truncated``), and the step's row starts
    a new episode (``is_first``)."""
    for i, flag in enumerate(restarted):
        if not flag or dones[i]:
            continue
        if rb is not None:
            sub = rb.buffer[i]
            last = (sub.pos - 1) % len(sub)
            sub.buffer["terminated"][last] = 0.0
            sub.buffer["truncated"][last] = 1.0
            sub.buffer["is_first"][last] = 0.0
        if driver is not None:
            driver.patch_last(i, {"terminated": 0.0, "is_first": 0.0})
        step_data["is_first"][0, i] = 1.0


def init_moments(device: "torch.device | str" = "cpu") -> Dict[str, torch.Tensor]:
    """Initial state of the return normaliser: two float32 scalars."""
    return {"low": torch.zeros((), dtype=torch.float32, device=device),
            "high": torch.zeros((), dtype=torch.float32, device=device)}


def moments_update(
    state: Dict[str, torch.Tensor],
    x: torch.Tensor,
    decay: float = 0.99,
    max_: float = 1e8,
    percentile_low: float = 0.05,
    percentile_high: float = 0.95,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """EMA of the low and high percentiles of the lambda-returns (linear
    interpolation, as ``jnp.quantile``); returns ``(new_state, offset,
    invscale)``. The returns are detached, then gathered from every rank of
    a data-parallel group on the gradient wire (``all_gather_wire``, as the
    JAX package gathers over ``dp``: in bfloat16 under a bfloat16 wire), so
    every rank takes the group's quantiles and no gradient crosses the
    collective. At one process the gather is the identity."""
    x = all_gather_wire(x.detach().to(torch.float32)).reshape(-1)
    low = torch.quantile(x, percentile_low)
    high = torch.quantile(x, percentile_high)
    new_low = decay * state["low"] + (1 - decay) * low
    new_high = decay * state["high"] + (1 - decay) * high
    invscale = torch.clamp(new_high - new_low, min=1.0 / max_)
    return {"low": new_low, "high": new_high}, new_low, invscale


def compute_lambda_values(
    rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor, lmbda: float = 0.95
) -> torch.Tensor:
    """TD(lambda) returns, a reverse loop over the horizon accumulated in
    float32; all inputs ``(H, B, 1)``."""
    rewards, values, continues = (t.to(torch.float32) for t in (rewards, values, continues))
    interm = rewards + continues * values * (1 - lmbda)
    nxt = values[-1]
    out = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        nxt = interm[t] + continues[t] * lmbda * nxt
        out[t] = nxt
    return torch.stack(out, dim=0)


def prepare_obs(obs: Dict[str, np.ndarray], *, cnn_keys: Sequence[str] = (), num_envs: int = 1) -> Dict[str, np.ndarray]:
    """Batch-shaped ``(num_envs, ...)`` float32 host arrays: pixels stay NHWC
    and are mapped to ``[-0.5, 0.5]``, vectors are flattened per row."""
    out = {}
    for k, v in obs.items():
        v = np.asarray(v, dtype=np.float32)
        if k in cnn_keys:
            v = v.reshape(num_envs, *v.shape[-3:]) / 255.0 - 0.5
        else:
            v = v.reshape(num_envs, -1)
        out[k] = v
    return out


@torch.no_grad()
def test(agent: Any, cfg: Any, device: "torch.device | str", greedy: bool = True) -> Tuple[float, int]:
    """One episode of ``agent`` (a
    :class:`~sheeprl_tpu_torch.algos.dreamer_v3.evaluate.DreamerV3Agent`) on
    a fresh env seeded with ``cfg.seed``, batch 1; prints its return and
    returns it with the episode's step count.

    The episode is one serving session: each step is
    :func:`~sheeprl_tpu_torch.algos.dreamer_v3.evaluate.session_step` on a
    state row seeded with ``cfg.seed``, so every draw (the posterior, and
    without ``greedy`` the actions) comes from ``counter_uniform`` of the
    seed and the step, as a served session's do, and no generator is
    consumed: a served session fed the episode's frames gives its actions,
    and a training run's generator is left as it was."""
    # imported here: the evaluate module imports this one
    from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import initial_state, session_step

    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    env = make_env(cfg, int(cfg.seed))
    obs = env.reset(seed=int(cfg.seed))[0]
    state = initial_state(agent, 1, int(cfg.seed))
    done, cumulative, steps = False, 0.0, 0
    while not done:
        prepared = prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys=cnn_keys, num_envs=1)
        actions, state = session_step(agent, {k: torch.from_numpy(v).to(device) for k, v in prepared.items()},
                                      state, greedy)
        real = actions.float().cpu().numpy().reshape(-1)
        obs, reward, terminated, truncated, _ = env.step(real[0] if real.size == 1 else real)
        done = terminated or truncated
        cumulative += float(reward)
        steps += 1
    env.close()
    print("Test - Reward:", cumulative, flush=True)
    return cumulative, steps
