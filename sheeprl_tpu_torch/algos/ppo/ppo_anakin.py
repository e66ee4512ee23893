"""PPO on the card's own envs (Anakin; counterpart of
``sheeprl_tpu/algos/ppo/ppo_anakin.py``, one device).

The JAX package fuses a whole PPO iteration into one XLA program over
pure-JAX envs and runs ``iters_per_block`` of them per host dispatch. The
port keeps that program's contract, not its fusion: the host issues a whole
block of iterations and reads the card once, at the block's end. Each
iteration, in the JAX package's order:

- the rollout: ``rollout_steps`` steps of the batched device envs
  (:mod:`sheeprl_tpu_torch.envs.device_envs`, same-step autoreset), one
  policy forward each, the actions drawn from uniforms (continuous: normals)
  drawn for the whole rollout at once; on a time-limit truncation the
  reward is bootstrapped as ``where(truncated, r + gamma * V(final obs), r)``
  (the JAX block gates that critic forward with ``lax.cond(truncated.any())``;
  computed unconditionally it needs no host read and gives the same floats
  wherever the value is finite);
- GAE, bootstrapped with the value of the last observation: one launch of
  the ``gae`` kernel on the card;
- the host loop's update (:func:`~sheeprl_tpu_torch.algos.ppo.ppo.make_train_step`):
  ``update_epochs`` passes over the flattened rollout in minibatches, with
  the permutations drawn on the card.

Nothing inside a block reads the card: no ``.item()``, no copy to the host,
no branch on a tensor's value. The losses, the guard's skip counts and the
finished episodes' returns and lengths stay on the card as ``(iters, ...)``
tensors until :func:`read_block` copies them to the host in one transfer
(JAX's ``jax.device_get(metrics)``). The sentinel, logging, annealing (at
block granularity, as in JAX), checkpoints (at block boundaries) and the
end-of-run greedy test follow the JAX loop.

Random draws come from two ``torch.Generator`` streams on the card: the
rollout's (actions and env resets) and the update's (permutations). A block
takes its draws as an argument instead (``draws``), so a test can feed the
ones JAX's keys give. The checkpoint holds the JAX loop's keys, plus
``train_step``, ``last_train`` and both generators' states (``rng``,
``rollout_rng``); a resumed run's envs restart from the seed's reset, as
JAX's do.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, PPOPlayer, build_agent, draw_actions
from sheeprl_tpu_torch.algos.ppo.ppo import LOSS_NAMES, make_optimizer, make_train_step
from sheeprl_tpu_torch.algos.ppo.utils import test
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.envs.device_envs import BatchedDeviceEnv, DeviceEnv, is_device_env, make_device_env
from sheeprl_tpu_torch.fault import CheckpointManager, DivergenceSentinel, load_resume_state
from sheeprl_tpu_torch.ops.kernels import gae, gae_factors
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric, build_aggregator
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import polynomial_decay

__all__ = [
    "FERRY_ELEMS_BOUND",
    "AnakinCarry",
    "make_anakin_block",
    "draw_iteration",
    "draw_permutations",
    "rollout",
    "read_block",
    "dispatch_block",
    "resolve_iters_per_block",
    "anakin_env",
    "main",
]

#: per-block budget, in elements, of the episode arrays a block keeps on
#: the card for the host's one read (JAX ``FERRY_ELEMS_BOUND``)
FERRY_ELEMS_BOUND = 1 << 24

_TINY = float(np.finfo(np.float32).tiny)


class AnakinCarry(NamedTuple):
    """What a block carries from one iteration to the next: the envs' state,
    their observations ``(..., N, obs_dim)`` and the running episodes'
    returns (float32) and lengths (int32)."""

    env_state: Any
    obs: torch.Tensor
    ep_ret: torch.Tensor
    ep_len: torch.Tensor


def anakin_env(cfg: Any, swept_params: Sequence[str] = ()) -> tuple:
    """``(env, obs_key)``: the device env ``env.id`` names (with
    ``env.max_episode_steps`` where set; ``swept_params``, the env fields a
    population sweeps, may not be among them) and the one vector
    observation key the Anakin loops take."""
    algo_name = str(cfg.algo.name)
    if not is_device_env(cfg.env.id):
        from sheeprl_tpu_torch.envs.device_envs import DEVICE_ENV_REGISTRY

        raise ValueError(
            f"algo={algo_name} requires a device environment; '{cfg.env.id}' is not registered "
            f"(available: {sorted(DEVICE_ENV_REGISTRY)}). Use algo=ppo for host-loop training."
        )
    cnn_keys = list(cfg.algo.cnn_keys.encoder or [])
    mlp_keys = list(cfg.algo.mlp_keys.encoder or [])
    if cnn_keys or len(mlp_keys) != 1:
        raise ValueError(
            f"{algo_name} supports exactly one vector observation key (the classic-control device envs); got "
            f"cnn={cnn_keys} mlp={mlp_keys}"
        )
    kwargs = {}
    if cfg.env.get("max_episode_steps") and int(cfg.env.max_episode_steps) > 0:
        kwargs["max_episode_steps"] = int(cfg.env.max_episode_steps)
    return make_device_env(cfg.env.id, swept_params=tuple(swept_params), **kwargs), mlp_keys[0]


def draw_iteration(env: DeviceEnv, agent: PPOAgent, batch: Sequence[int], rollout_steps: int,
                   perm_lead: Sequence[int], rows: int, rollout_gen: Optional[torch.Generator],
                   train_gen: Optional[torch.Generator], device) -> Dict[str, Any]:
    """One iteration's draws, on ``device``: per rollout step the actions'
    noise (``uniforms``, one ``(T, *batch, d)`` tensor per discrete head, in
    [tiny, 1) as ``jax.random.categorical`` draws them; or ``noise``, the
    continuous head's standard normals) and the envs' reset uniforms
    (``reset``), from ``rollout_gen``; then the update's permutations
    (``perms``, ``(*perm_lead, rows)``: the epochs', each member's for a
    population) from ``train_gen``."""
    lead = (rollout_steps,) + tuple(batch)
    out: Dict[str, Any] = {}
    if agent.is_continuous:
        out["noise"] = torch.randn(lead + (int(sum(agent.actions_dim)),), generator=rollout_gen, device=device)
    else:
        out["uniforms"] = [torch.rand(lead + (d,), generator=rollout_gen, device=device).clamp_(min=_TINY)
                           for d in agent.actions_dim]
    out["reset"] = torch.rand(lead + tuple(env.reset_shape), generator=rollout_gen, device=device)
    out["perms"] = draw_permutations(perm_lead, rows, train_gen, device)
    return out


def draw_permutations(lead: Sequence[int], rows: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """``lead + (rows,)`` permutations of ``range(rows)``: the sort order of
    float64 uniform keys, one sort for all of them on the device (ties, at
    2^-53 apart, are left to the sort), as ``jax.random.permutation`` sorts
    random keys. ``torch.randperm`` draws one permutation a call."""
    keys = torch.rand(tuple(lead) + (rows,), generator=generator, device=device, dtype=torch.float64)
    return torch.argsort(keys, dim=-1)


def _values(agent: PPOAgent, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The critic alone (the feature extractor, then the critic): the value
    ``agent(obs)[1]`` gives, without the actor's layers."""
    return agent.critic(agent.feature_extractor(obs))


@torch.no_grad()
def rollout(benv: BatchedDeviceEnv, forward: Callable, values: Callable, rollout_steps: int, carry: AnakinCarry,
            env_params: Any, gamma: "float | torch.Tensor", draws: Dict[str, Any]) -> tuple:
    """``rollout_steps`` steps of the envs, the policy ``forward(obs) ->
    (actor outs, values)`` drawing its actions from ``draws``, the critic
    ``values(obs)`` bootstrapping each time-limit truncation (``gamma``
    broadcasts over the envs). ``(carry, traj, next_value)``: ``traj`` holds
    ``(T, *batch, ...)`` tensors: the observations, one-hot (continuous: raw)
    actions, log-probs, values, training rewards, dones, raw rewards, and
    where an episode ended its return and length; ``next_value`` the last
    observation's value."""
    env_state, obs, ep_ret, ep_len = carry
    traj: Dict[str, List[torch.Tensor]] = {k: [] for k in (
        "obs", "actions", "logprobs", "values", "rewards", "dones", "raw", "ep_ret", "ep_len")}
    for t in range(rollout_steps):
        actor_outs, value = forward(obs)
        if "noise" in draws:
            acts, logprob = draw_actions(actor_outs, True, noise=draws["noise"][t])
            env_action = acts[0]
        else:
            acts, logprob = draw_actions(actor_outs, False, uniforms=[u[t] for u in draws["uniforms"]])
            env_action = acts[0].argmax(dim=-1)  # the device envs take one discrete head
        env_state, next_obs, reward, done, info = benv.step(env_state, env_action, env_params, noise=draws["reset"][t])
        v_final = values(info["final_obs"])[..., 0]
        train_reward = torch.where(info["truncated"], reward + gamma * v_final, reward)
        ep_ret = ep_ret + reward
        ep_len = ep_len + 1
        traj["obs"].append(obs)
        traj["actions"].append(torch.cat(acts, dim=-1))
        traj["logprobs"].append(logprob)
        traj["values"].append(value)
        traj["rewards"].append(train_reward)
        traj["dones"].append(done)
        traj["raw"].append(reward)
        traj["ep_ret"].append(torch.where(done, ep_ret, 0.0))
        traj["ep_len"].append(torch.where(done, ep_len, 0))
        ep_ret = torch.where(done, 0.0, ep_ret)
        ep_len = torch.where(done, 0, ep_len)
        obs = next_obs
    stacked = {k: torch.stack(v) for k, v in traj.items()}
    return AnakinCarry(env_state, obs, ep_ret, ep_len), stacked, values(obs)


def make_anakin_block(agent: PPOAgent, optimizer, cfg: Any, benv: BatchedDeviceEnv, obs_key: str,
                      guard: bool = False, population: bool = False) -> Callable:
    """The block (JAX ``make_anakin_local_block``): ``block(carry, iters,
    env_params, clip_coef, ent_coef, gamma=None, gae_lambda=None,
    rollout_gen=None, train_gen=None, draws=None) -> (carry, metrics)``.
    ``iters`` iterations of rollout, GAE and update; the agent and the
    optimizer are updated in place. ``draws`` (a list of
    :func:`draw_iteration` dicts, one per iteration) replaces the generators.

    ``metrics`` stays on the card: ``pg``, ``v``, ``ent`` and ``bad`` (the
    minibatches the guard skipped) ``(iters,)``; ``ep_done``, ``ep_ret``,
    ``ep_len`` ``(iters, T, N)``, where an episode ended, its return and
    length. With ``population`` (one member of a population, run by the
    population driver at P = 1, as JAX unrolls its size-1 ``vmap``) gamma and
    lambda are ``(1,)`` float32 tensors and GAE takes the per-member entry
    with the population's float32 rounding, and ``fit`` ``(iters,)`` is the
    iteration's mean per-env sum of raw rewards."""
    T = int(cfg.algo.rollout_steps)
    N = benv.num_envs
    rows = T * N
    epochs = int(cfg.algo.update_epochs)
    train_fn = make_train_step(agent, optimizer, cfg, rows, guard=guard)
    cfg_gamma, cfg_lambda = float(cfg.algo.gamma), float(cfg.algo.gae_lambda)

    def forward(obs):
        return agent({obs_key: obs})

    def values(obs):
        return _values(agent, {obs_key: obs})

    def block(carry: AnakinCarry, iters: int, env_params, clip_coef: torch.Tensor, ent_coef: torch.Tensor,
              gamma: "torch.Tensor | None" = None, gae_lambda: "torch.Tensor | None" = None,
              rollout_gen: Optional[torch.Generator] = None, train_gen: Optional[torch.Generator] = None,
              draws: Optional[List[Dict[str, Any]]] = None):
        device = carry.obs.device
        if population:
            gamma_r, lam = gamma.reshape(1), gae_lambda.reshape(1)
        else:
            gamma_r, lam = cfg_gamma, cfg_lambda
        per_iter: Dict[str, List[torch.Tensor]] = {k: [] for k in ("losses", "bad", "ep_done", "ep_ret", "ep_len",
                                                                 "fit")}
        for i in range(iters):
            d = draws[i] if draws is not None else draw_iteration(
                benv.env, agent, carry.obs.shape[:-1], T, (epochs,), rows, rollout_gen, train_gen, device)
            carry, traj, next_value = rollout(benv, forward, values, T, carry, env_params, gamma_r, d)
            dones = traj["dones"].to(torch.float32)[..., None]
            rewards = traj["rewards"][..., None]
            if population:  # the member axis of one: (T, 1, N, 1), the population's rounding of gamma * lambda
                returns, advantages = gae_factors(rewards[:, None], traj["values"][:, None], dones[:, None],
                                                  next_value[None], gamma_r, lam)
                returns, advantages = returns[:, 0], advantages[:, 0]
                per_iter["fit"].append(traj["raw"].sum(dim=0).mean())
            else:
                returns, advantages = gae(rewards, traj["values"], dones, next_value, gamma_r, lam)
            data = {obs_key: traj["obs"], "actions": traj["actions"], "logprobs": traj["logprobs"],
                    "values": traj["values"], "returns": returns, "advantages": advantages}
            data = {k: v.reshape(rows, *v.shape[2:]) for k, v in data.items()}
            losses, skipped = train_fn(data, clip_coef, ent_coef, perms=d["perms"])
            per_iter["losses"].append(losses)
            per_iter["bad"].append(skipped)
            per_iter["ep_done"].append(traj["dones"])
            per_iter["ep_ret"].append(traj["ep_ret"])
            per_iter["ep_len"].append(traj["ep_len"])
        losses = torch.stack(per_iter["losses"])
        metrics = {"pg": losses[:, 0], "v": losses[:, 1], "ent": losses[:, 2], "bad": torch.stack(per_iter["bad"])}
        for k in ("ep_done", "ep_ret", "ep_len"):
            metrics[k] = torch.stack(per_iter[k])
        if population:
            metrics["fit"] = torch.stack(per_iter["fit"])
        return carry, metrics

    return block


def read_block(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The block's one read of the card: every metric packed into one
    float64 tensor (exact for float32 values and the counts), copied to the
    host in one transfer, and unpacked into numpy arrays of the metrics'
    shapes (``ep_done`` bool, ``ep_len`` int64)."""
    names = list(metrics)
    flat = [metrics[k].reshape(-1).to(torch.float64) for k in names]
    host = torch.cat(flat).cpu().numpy()  # the one read
    out, start = {}, 0
    for k, t in zip(names, flat):
        arr = host[start:start + t.numel()].reshape(tuple(metrics[k].shape))
        start += t.numel()
        if metrics[k].dtype == torch.bool:
            arr = arr.astype(bool)
        elif not metrics[k].is_floating_point():
            arr = arr.astype(np.int64)
        out[k] = arr
    return out


def resolve_iters_per_block(cfg: Any, total_iters: int, policy_steps_per_iter: int, ferry_episodes: bool,
                            population_size: int = 1) -> int:
    """Iterations per block (JAX ``resolve_iters_per_block``):
    ``algo.iters_per_block``, else the log and checkpoint interval in
    iterations, so metrics and checkpoints land where the host loop puts
    them; at most the run's iterations, and with the episode arrays kept,
    at most what :data:`FERRY_ELEMS_BOUND` allows for ``(P, iters, T, N)``."""
    if cfg.algo.get("iters_per_block"):
        iters = int(cfg.algo.iters_per_block)
    else:
        intervals = []
        log_level, log_every = int(cfg.metric.get("log_level", 1)), int(cfg.metric.get("log_every", 5000))
        if log_level > 0 and log_every > 0:
            intervals.append(log_every)
        if int(cfg.checkpoint.every) > 0:
            intervals.append(int(cfg.checkpoint.every))
        interval = min(intervals) if intervals else int(cfg.algo.total_steps)
        iters = max(1, interval // policy_steps_per_iter)
    iters = max(1, min(iters, total_iters))
    if ferry_episodes:
        rows = max(1, int(cfg.algo.rollout_steps) * int(cfg.env.num_envs) * max(1, int(population_size)))
        iters = max(1, min(iters, FERRY_ELEMS_BOUND // rows))
    return iters


def dispatch_block(block: Callable, *args, **kwargs) -> tuple:
    """One block and its one read of the card: ``(carry, host metrics)``."""
    carry, metrics = block(*args, **kwargs)
    return carry, read_block(metrics)


def log_block_rates(logger, step: int, train_steps: int, env_steps: int, members: int = 0) -> None:
    """The JAX Anakin loops' rates since the last log point, both over
    ``Time/train_time`` (the blocks, each with its read): ``Time/sps_train``,
    ``Time/sps_env_interaction`` and, for a population of ``members``,
    ``Time/sps_env_interaction_aggregate``; then the timers reset."""
    if timer.disabled:
        return
    seconds = timer.compute().get("Time/train_time", 0)
    if seconds > 0:
        rates = {"Time/sps_train": train_steps / seconds, "Time/sps_env_interaction": env_steps / seconds}
        if members:
            rates["Time/sps_env_interaction_aggregate"] = env_steps * members / seconds
        logger.log_dict(rates, step)
    timer.reset()


def _log_episodes(summary, aggregator, metrics, block_iters, policy_step0, steps_per_iter, echo: bool = True) -> None:
    """Finished episodes of a block's host metrics, iteration by iteration,
    into the summary, the aggregator and, with ``echo``, the console (JAX's
    bookkeeping)."""
    for i in range(block_iters):
        policy_step = policy_step0 + (i + 1) * steps_per_iter
        ts, envs = np.nonzero(metrics["ep_done"][i])
        for t_i, e_i in zip(ts, envs):
            ret, length = float(metrics["ep_ret"][i][t_i, e_i]), int(metrics["ep_len"][i][t_i, e_i])
            summary["episodes"].append((policy_step, int(e_i), ret, length))
            if aggregator is not None:
                if "Rewards/rew_avg" in aggregator:
                    aggregator.update("Rewards/rew_avg", ret)
                if "Game/ep_len_avg" in aggregator:
                    aggregator.update("Game/ep_len_avg", length)
            if echo:
                print(f"Rank-0: policy_step={policy_step}, reward_env_{e_i}={ret}", flush=True)


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The single-run Anakin loop (JAX ``ppo_anakin.main``); with
    ``algo.population.size`` > 1 it hands over to the population driver.
    Returns a summary: counters, each iteration's losses, the finished
    episodes, host seconds per block, the last checkpoint, the sentinel's
    counts."""
    pop_cfg = cfg.algo.get("population") or {}
    if int(pop_cfg.get("size") or 1) > 1:
        from sheeprl_tpu_torch.algos.ppo.ppo_anakin_population import population_main

        return population_main(cfg, device)
    if pop_cfg.get("hparams"):
        warnings.warn(
            "algo.population.hparams is configured but algo.population.size is 1: the sweep is "
            "IGNORED and this trains one member at the run config's scalars. Set "
            "algo.population.size=P (or algo=ppo_anakin_population) to train the population.",
            UserWarning,
        )
    device = torch.device(device)
    algo = cfg.algo
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    env, obs_key = anakin_env(cfg)
    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    cfg["spaces"] = dotdict(env.spaces(obs_key))
    actions_dim = (int(env.action_shape[0]),) if env.is_continuous else (int(env.n_actions),)
    logger.log_hyperparams(cfg)
    write_run_config(log_dir, plain(cfg))
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))

    seed = int(cfg.seed)
    train_gen = torch.Generator(device=device).manual_seed(seed)
    rollout_gen = torch.Generator(device=device).manual_seed(seed + 1)
    reset_gen = torch.Generator(device=device).manual_seed(seed + 2)
    if state is not None:
        if state.get("rng") is not None:
            train_gen.set_state(state["rng"])
        if state.get("rollout_rng") is not None:
            rollout_gen.set_state(state["rollout_rng"])
        algo["per_rank_batch_size"] = int(state["batch_size"])
    agent, _ = build_agent(cfg, actions_dim, env.is_continuous, cfg.spaces.obs, device,
                           state["agent"] if state is not None else None)
    player = PPOPlayer(agent)
    optimizer = make_optimizer(cfg, agent)
    if state is not None:
        optimizer.load_state_dict(state["optimizer"])
    # optax's injected learning rate is a float32 array: the rate Adam takes is the float32 one
    optimizer.set_lr(float(np.float32(algo.optimizer.lr)))

    num_envs = int(cfg.env.num_envs)
    T = int(algo.rollout_steps)
    policy_steps_per_iter = num_envs * T
    total_iters = int(algo.total_steps) // policy_steps_per_iter if not bool(cfg.get("dry_run", False)) else 1
    start_iter = int(state["iter_num"]) + 1 if state is not None else 1
    policy_step = int(state["iter_num"]) * policy_steps_per_iter if state is not None else 0
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    train_step = int(state.get("train_step", 0)) if state is not None else 0
    last_train = int(state.get("last_train", 0)) if state is not None else 0
    log_level = int(cfg.metric.get("log_level", 1))
    log_every = int(cfg.metric.get("log_every", 5000))
    if log_level > 0 and log_every % policy_steps_per_iter != 0:
        warnings.warn(f"The metric.log_every parameter ({log_every}) is not a multiple of the "
                      f"policy_steps_per_iter value ({policy_steps_per_iter}).")
    ferry_episodes = True  # the port's summary keeps every finished episode, whatever the log level
    iters_per_block = resolve_iters_per_block(cfg, total_iters, policy_steps_per_iter, ferry_episodes)
    sentinel_cfg = (cfg.get("fault") or {}).get("sentinel") or {}
    guard = bool(sentinel_cfg.get("enabled", True))
    sentinel = DivergenceSentinel(sentinel_cfg)
    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)

    benv = BatchedDeviceEnv(env, num_envs)
    env_params = env.default_params(device)
    env_state, obs = benv.reset(env_params, generator=reset_gen)
    carry = AnakinCarry(env_state, obs, torch.zeros(num_envs, device=device),
                        torch.zeros(num_envs, dtype=torch.int32, device=device))
    block = make_anakin_block(agent, optimizer, cfg, benv, obs_key, guard=guard)

    lr0 = lr = float(algo.optimizer.lr)
    clip0, ent0 = float(algo.clip_coef), float(algo.ent_coef)
    clip_coef, ent_coef = clip0, ent0
    summary: Dict[str, Any] = {
        "start_iter": start_iter, "iterations": 0, "blocks": 0, "iters_per_block": iters_per_block, "losses": [],
        "episodes": [], "block_s": [], "checkpoint": None, "device": str(device), "test_reward": None,
        "test_steps": None, "skipped": [],
    }
    iter_num = start_iter - 1
    while iter_num < total_iters:
        block_iters = min(iters_per_block, total_iters - iter_num)
        t0 = time.perf_counter()
        with timer("Time/train_time", SumMetric):
            coefs = torch.tensor([clip_coef, ent_coef], dtype=torch.float32).to(device)
            carry, metrics = dispatch_block(block, carry, block_iters, env_params, coefs[0], coefs[1],
                                            rollout_gen=rollout_gen, train_gen=train_gen)
        summary["block_s"].append(time.perf_counter() - t0)
        summary["blocks"] += 1
        _log_episodes(summary, aggregator if log_level > 0 else None, metrics, block_iters, policy_step,
                      policy_steps_per_iter)
        tripped = False
        for i in range(block_iters):
            iter_num += 1
            policy_step += policy_steps_per_iter
            train_step += 1
            losses = [float(metrics[k][i]) for k in ("pg", "v", "ent")]
            summary["losses"].append(losses)
            if guard:
                summary["skipped"].append(float(metrics["bad"][i]))
                tripped = sentinel.observe(float(metrics["bad"][i])) or tripped
            if aggregator is not None and log_level > 0:
                for name, value in zip(LOSS_NAMES, losses):
                    aggregator.update(name, value)
        summary["iterations"] += block_iters
        if tripped:
            def rollback(good: Dict[str, Any]) -> None:
                agent.load_state_dict(good["agent"])
                optimizer.load_state_dict(good["optimizer"])
                if good.get("rng") is not None:
                    train_gen.set_state(good["rng"])
                if good.get("rollout_rng") is not None:
                    rollout_gen.set_state(good["rollout_rng"])

            manager.wait()  # the newest save must be published before the rollback looks for it
            sentinel.recover(ckpt_dir, rollback)
        if log_level > 0:
            logger.log_dict({"Info/learning_rate": lr, "Info/clip_coef": clip_coef, "Info/ent_coef": ent_coef},
                            policy_step)
            if guard and sentinel.total_skipped:
                logger.log_dict({"Fault/skipped_updates": sentinel.total_skipped}, policy_step)
            if policy_step - last_log >= log_every or iter_num == total_iters:
                print(f"policy_step={policy_step} " + " ".join(
                    f"{n.split('/')[-1]}={v:.6g}" for n, v in zip(LOSS_NAMES, summary["losses"][-1])), flush=True)
                if aggregator is not None:
                    logger.log_dict(aggregator.compute(), policy_step)
                    aggregator.reset()
                log_block_rates(logger, policy_step, train_step - last_train, policy_step - last_log)
                last_log = policy_step
                last_train = train_step
        # annealing at block granularity, as in JAX (identical when off)
        if algo.anneal_lr:
            lr = polynomial_decay(iter_num, initial=lr0, final=0.0, max_decay_steps=total_iters)
            optimizer.set_lr(float(np.float32(lr)))
        if algo.anneal_clip_coef:
            clip_coef = polynomial_decay(iter_num, initial=clip0, final=0.0, max_decay_steps=total_iters)
        if algo.anneal_ent_coef:
            ent_coef = polynomial_decay(iter_num, initial=ent0, final=0.0, max_decay_steps=total_iters)
        if (int(cfg.checkpoint.every) > 0 and policy_step - last_checkpoint >= int(cfg.checkpoint.every)) or (
            iter_num == total_iters and cfg.checkpoint.get("save_last", False)
        ):
            last_checkpoint = policy_step
            ckpt_state = {
                "agent": agent.state_dict(),
                "optimizer": optimizer.state_dict(),
                "scheduler": None,
                "iter_num": iter_num,
                "batch_size": int(algo.per_rank_batch_size),
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
                "train_step": train_step,
                "last_train": last_train,
                "rng": train_gen.get_state(),
                "rollout_rng": rollout_gen.get_state(),
            }
            path = os.path.join(ckpt_dir, f"ckpt_{policy_step}_0.ckpt")
            summary["checkpoint"] = str(manager.save(path, ckpt_state, step=policy_step, config=plain(cfg)))

    manager.close()
    if algo.get("run_test", True):
        summary["test_reward"], summary["test_steps"] = test(player, cfg, device)
    logger.close()
    block_s = sum(summary["block_s"])
    summary.update(
        policy_steps=policy_step,
        log_dir=log_dir,
        env_steps_per_s=summary["iterations"] * policy_steps_per_iter / block_s if block_s > 0 else None,
        rollbacks=sentinel.rollbacks,
        checkpoint_timings=manager.timings,
        **{"Fault/skipped_updates": sentinel.total_skipped},
    )
    return summary
