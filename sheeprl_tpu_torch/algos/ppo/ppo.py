"""PPO coupled training (counterpart of ``sheeprl_tpu/algos/ppo/ppo.py``,
one device).

Each iteration, in the JAX package's order: ``rollout_steps`` env steps with
one policy forward each (the truncation bootstrap ``r += gamma * V(final
obs)`` on the envs the time limit cut; a continuous action goes to the env
raw, as the JAX loop sends it, and the env clips it), GAE on the device with the
bootstrap value of the last observation (the CUDA ``gae`` kernel on the
card), then ``update_epochs`` passes over the flattened rollout in
minibatches, each a clipped-surrogate + value + entropy loss and one Adam
step. The losses stay on the device through the update; the loop reads them
once per iteration. Random draws come from an explicit ``torch.Generator``:
the actions' Gumbel noise and each epoch's permutation, which the update
also takes as an argument, so a test can feed the permutations JAX's keys
give.

With ``fault.sentinel.enabled`` (the default) each minibatch is guarded, as
the JAX package's ``guard=True`` step is: a step whose loss or gradients
hold a NaN or an Inf leaves the parameters, Adam's moments and its step
count as they were (:class:`~sheeprl_tpu_torch.ops.guard.StateGuard`, a
select on the device, no host read), and the update counts it. The
:class:`~sheeprl_tpu_torch.fault.DivergenceSentinel` reads the count with
the losses once per iteration and warns, rolls back to the last complete
checkpoint or aborts. Checkpoints go through the
:class:`~sheeprl_tpu_torch.fault.CheckpointManager` (manifest,
``checkpoint.keep_last``, ``checkpoint.async_save``).

The run writes into its own directory (``utils.logger.get_log_dir``): its
``config.json``, checkpoints and, at ``metric.log_level`` 1, the JAX loop's
metrics in ``metrics.jsonl`` at the same steps: ``Info/*`` every iteration,
the aggregated ``Rewards/rew_avg``, ``Game/ep_len_avg`` and ``Loss/*`` and
the ``Time/sps_*`` rates every ``metric.log_every`` policy steps. The losses
reach the aggregator from the iteration's one read of the device.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, build_agent, forward_with_actions
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.utils import action_spec, prepare_obs, test
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.data import ReplayBuffer
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import CheckpointManager, DivergenceSentinel, NaNInjector, load_resume_state
from sheeprl_tpu_torch.ops.guard import StateGuard, finite_guard
from sheeprl_tpu_torch.ops.kernels import gae
from sheeprl_tpu_torch.optim import ClippedOptimizer, build_optimizer
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric, build_aggregator
from sheeprl_tpu_torch.utils.profiler import TraceProfiler
from sheeprl_tpu_torch.utils.timer import log_timers, timer
from sheeprl_tpu_torch.utils.utils import polynomial_decay

__all__ = ["LOSS_NAMES", "draw_permutations", "make_optimizer", "make_train_step", "main"]

LOSS_NAMES = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")


def make_optimizer(cfg: Any, agent: PPOAgent) -> ClippedOptimizer:
    return build_optimizer(agent.parameters(), cfg.algo.optimizer, cfg.algo.max_grad_norm)


def draw_permutations(epochs: int, batch: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One permutation of the ``batch`` rows per epoch, ``(epochs, batch)``."""
    return torch.stack([torch.randperm(batch, generator=generator, device=device) for _ in range(epochs)])


def make_train_step(agent: PPOAgent, optimizer: ClippedOptimizer, cfg: Any, local_batch: int,
                    guard: bool = False) -> Callable:
    """The update (JAX ``make_local_train`` on one device): ``train(data,
    clip_coef, ent_coef, perms=None, generator=None) -> (losses, skipped)``. ``data``
    holds the flattened rollout, ``(local_batch, ...)`` tensors on the
    agent's device, rows in (t, n) order; ``perms`` is ``(update_epochs,
    local_batch)``, else drawn from ``generator``. Each epoch's permutation
    is padded cyclically to whole minibatches (``jnp.resize``), not cut into
    a ragged last one. The agent and optimizer are updated in place;
    ``losses`` is the ``(3,)`` mean of :data:`LOSS_NAMES` over every
    minibatch of every epoch, ``skipped`` the 0-dim float count of the
    minibatches the guard undid (0 unguarded), both left on the device.

    ``guard=True`` (JAX ``guard=True``): a minibatch whose gradients or loss
    are not all finite leaves the parameters and the optimizer's state as
    they were."""
    algo = cfg.algo
    mb_size = int(algo.per_rank_batch_size)
    n_mb = max(1, -(-local_batch // mb_size))
    padded = n_mb * mb_size
    if padded != local_batch:
        warnings.warn(
            f"The batch ({local_batch}) is not divisible by per_rank_batch_size ({mb_size}): the last minibatch of "
            f"every epoch repeats {padded - local_batch} rows from the start of the epoch's permutation, as the JAX "
            "package pads it"
        )
    epochs = int(algo.update_epochs)
    clip_vloss = bool(algo.clip_vloss)
    normalize_adv = bool(algo.normalize_advantages)
    vf_coef = float(algo.vf_coef)
    reduction = str(algo.loss_reduction)
    cnn_keys, mlp_keys = list(algo.cnn_keys.encoder), list(algo.mlp_keys.encoder)
    params = list(agent.parameters())
    state_guard = StateGuard(lambda: params + optimizer.state_tensors()) if guard else None

    def minibatch_step(batch: Dict[str, torch.Tensor], clip_coef: torch.Tensor, ent_coef: torch.Tensor):
        obs = {k: batch[k].to(torch.float32) / 255.0 - 0.5 for k in cnn_keys}
        obs.update({k: batch[k].to(torch.float32) for k in mlp_keys})
        actions = torch.split(batch["actions"], list(agent.actions_dim), dim=-1)
        advantages = batch["advantages"]
        if normalize_adv:  # population std, as jnp.std
            advantages = (advantages - advantages.mean()) / (advantages.std(unbiased=False) + 1e-8)
        new_logprobs, entropy, new_values = forward_with_actions(agent, obs, actions)
        pg = policy_loss(new_logprobs, batch["logprobs"], advantages, clip_coef, reduction)
        v = value_loss(new_values, batch["values"], batch["returns"], clip_coef, clip_vloss, reduction)
        ent = entropy_loss(entropy, reduction)
        loss = pg + vf_coef * v + ent_coef * ent
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        ok = finite_guard([*grads, loss]) if guard else None
        optimizer.step(grads)
        if guard:
            state_guard.select(ok)
        return torch.stack([pg, v, ent]).detach(), ok

    def train(
        data: Dict[str, torch.Tensor],
        clip_coef: "torch.Tensor | float",
        ent_coef: "torch.Tensor | float",
        perms: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        device = data["actions"].device
        if perms is None:
            perms = draw_permutations(epochs, local_batch, generator, device)
        clip_coef = torch.as_tensor(clip_coef, dtype=torch.float32, device=device)
        ent_coef = torch.as_tensor(ent_coef, dtype=torch.float32, device=device)
        cyclic = torch.arange(padded, device=device) % local_batch
        idx = perms.to(device)[:, cyclic].reshape(epochs, n_mb, mb_size)
        total = torch.zeros(3, dtype=torch.float32, device=device)
        skipped = torch.zeros((), dtype=torch.float32, device=device)
        if guard:
            state_guard.snapshot()
        for e in range(epochs):
            for m in range(n_mb):
                rows = idx[e, m]
                losses, ok = minibatch_step({k: v[rows] for k, v in data.items()}, clip_coef, ent_coef)
                total += losses
                if guard:
                    skipped += (~ok).to(torch.float32)
        return total / (epochs * n_mb), skipped

    return train


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The coupled loop: roll out, GAE, update, anneal, checkpoint; a greedy
    test episode at the end with ``algo.run_test``. Returns a summary of the
    run (counters, each iteration's losses, the finished episodes, host
    seconds per phase, the last checkpoint's path, ``Fault/skipped_updates``,
    ``Fault/env_restarts``, the sentinel's rollbacks and the manager's save
    timings)."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    algo = cfg.algo
    cnn_keys, mlp_keys = list(algo.cnn_keys.encoder), list(algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    if not obs_keys:
        raise RuntimeError("set at least one of algo.cnn_keys.encoder and algo.mlp_keys.encoder")
    num_envs = int(cfg.env.num_envs)
    rollout_steps = int(algo.rollout_steps)
    seed = int(cfg.seed)
    if int(cfg.buffer.size) < rollout_steps:
        raise ValueError(f"The size of the buffer ({cfg.buffer.size}) cannot be lower than the rollout steps ({rollout_steps})")

    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    envs = make_vector_env(cfg, seed)
    cfg["spaces"] = dotdict(envs.spaces)
    actions_dim, is_continuous = action_spec(cfg.spaces)
    logger.log_hyperparams(cfg)
    write_run_config(log_dir, plain(cfg))  # the run directory's config.json
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))

    generator = torch.Generator(device=device).manual_seed(seed)
    if state is not None and state.get("rng") is not None:
        generator.set_state(state["rng"])
    agent, player = build_agent(
        cfg, actions_dim, is_continuous, cfg.spaces.obs, device, state["agent"] if state is not None else None,
        generator,
    )
    optimizer = make_optimizer(cfg, agent)
    if state is not None:
        optimizer.load_state_dict(state["optimizer"])
        algo["per_rank_batch_size"] = int(state["batch_size"])

    rb = ReplayBuffer(int(cfg.buffer.size), num_envs, obs_keys, memmap=bool(cfg.buffer.get("memmap", False)),
                      memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
                      memmap_mode=str(cfg.buffer.get("memmap_mode", "r+")))

    policy_steps_per_iter = num_envs * rollout_steps
    start_iter = int(state["iter_num"]) + 1 if state is not None else 1
    policy_step = int(state["iter_num"]) * policy_steps_per_iter if state is not None else 0
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    train_step = int(state.get("train_step", 0)) if state is not None else 0
    last_train = int(state.get("last_train", 0)) if state is not None else 0
    total_iters = int(algo.total_steps) // policy_steps_per_iter if not bool(cfg.get("dry_run", False)) else 1
    log_level = int(cfg.metric.get("log_level", 1))
    log_every = int(cfg.metric.get("log_every", 5000))
    action_repeat = int(cfg.env.get("action_repeat", 1) or 1)
    if log_level > 0 and log_every % policy_steps_per_iter != 0:
        warnings.warn(f"The metric.log_every parameter ({log_every}) is not a multiple of the "
                      f"policy_steps_per_iter value ({policy_steps_per_iter}).")
    if int(cfg.checkpoint.every) % policy_steps_per_iter != 0:
        warnings.warn(f"The checkpoint.every parameter ({cfg.checkpoint.every}) is not a multiple of the "
                      f"policy_steps_per_iter value ({policy_steps_per_iter}).")
    gamma, gae_lambda = float(algo.gamma), float(algo.gae_lambda)
    sentinel_cfg = (cfg.get("fault") or {}).get("sentinel") or {}
    guard = bool(sentinel_cfg.get("enabled", True))
    sentinel = DivergenceSentinel(sentinel_cfg)
    nan_injector = NaNInjector(cfg)
    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)
    train_fn = make_train_step(agent, optimizer, cfg, policy_steps_per_iter, guard=guard)

    lr = lr0 = float(algo.optimizer.lr)
    clip_coef0, ent_coef0 = float(algo.clip_coef), float(algo.ent_coef)
    clip_coef, ent_coef = clip_coef0, ent_coef0

    reset_obs = envs.reset(seed=seed)[0]
    next_obs = {k: np.asarray(reset_obs[k]) for k in obs_keys}
    step_data: Dict[str, np.ndarray] = {k: next_obs[k][np.newaxis] for k in obs_keys}
    summary: Dict[str, Any] = {
        "start_iter": start_iter, "iterations": 0, "losses": [], "episodes": [], "rollout_s": [], "gae_s": [],
        "update_s": [], "checkpoint": None, "device": str(device), "test_reward": None,
        "test_steps": None, "skipped": [],
    }
    heads = sum(actions_dim) if is_continuous else len(actions_dim)  # the env's action columns
    profiler = TraceProfiler(cfg.metric.get("profiler"), log_dir, device)
    for iter_num in range(start_iter, total_iters + 1):
        profiler.tick(iter_num)
        t0 = time.perf_counter()
        for _ in range(rollout_steps):
            policy_step += num_envs
            # the policy's forward is inside: the copy of its actions to the
            # host waits for the card
            with timer("Time/env_interaction_time", SumMetric):
                obs_t = prepare_obs(next_obs, cnn_keys, num_envs, device)
                env_actions, buf_actions, logprobs, values = player.rollout_step(obs_t)
                # one copy to the host per step: the env's actions and what the buffer keeps
                packed = torch.cat([env_actions.to(torch.float32), buf_actions, logprobs, values], dim=-1).cpu().numpy()
                real_actions = packed[:, :heads] if is_continuous else packed[:, :heads].astype(np.int64)
                obs, rewards, terminated, truncated, info = envs.step(real_actions)
                rewards = np.asarray(rewards, dtype=np.float32)
                truncated_envs = np.nonzero(truncated)[0]
                if len(truncated_envs) > 0 and "final_obs" in info:
                    final = {k: np.stack([info["final_obs"][i][k] for i in truncated_envs]) for k in obs_keys}
                    vals = player.get_values(prepare_obs(final, cnn_keys, len(truncated_envs), device)).float().cpu().numpy()
                    rewards[truncated_envs] += gamma * vals.reshape(rewards[truncated_envs].shape)
            step_data["dones"] = np.logical_or(terminated, truncated).reshape(1, num_envs, -1).astype(np.uint8)
            step_data["values"] = packed[None, :, -1:]
            step_data["actions"] = packed[None, :, heads:-2]
            step_data["logprobs"] = packed[None, :, -2:-1]
            step_data["rewards"] = rewards.reshape(1, num_envs, -1)
            rb.add(step_data)

            next_obs = {k: np.asarray(obs[k]) for k in obs_keys}
            for k in obs_keys:
                step_data[k] = next_obs[k][np.newaxis]
            for i, ep_rew, ep_len in info.get("episodes", ()):
                summary["episodes"].append((policy_step, i, ep_rew, ep_len))
                if log_level > 0:
                    if aggregator is not None:
                        aggregator.update("Rewards/rew_avg", ep_rew)
                        aggregator.update("Game/ep_len_avg", ep_len)
                    print(f"Rank-0: policy_step={policy_step}, reward_env_{i}={ep_rew}", flush=True)
        t1 = time.perf_counter()

        # GAE on the device, bootstrapped with the value of the last observation
        local = rb.to_numpy()
        next_values = player.get_values(prepare_obs(next_obs, cnn_keys, num_envs, device))
        on_device = {k: torch.from_numpy(v).to(device) for k, v in local.items()}
        returns, advantages = gae(
            on_device["rewards"], on_device["values"], on_device["dones"], next_values, gamma, gae_lambda
        )
        t2 = time.perf_counter()

        flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in on_device.items()}
        flat["returns"] = returns.reshape(-1, *returns.shape[2:])
        flat["advantages"] = advantages.reshape(-1, *advantages.shape[2:])
        if nan_injector:
            nan_injector.poison(flat, "advantages", iter_num)
        # the update's one read waits for the card: the timer holds its device time
        with timer("Time/train_time", SumMetric):
            losses, skipped = train_fn(flat, clip_coef, ent_coef, generator=generator)
            losses = torch.cat([losses, skipped.reshape(1)]).cpu().tolist()  # the one read
        t3 = time.perf_counter()
        train_step += 1
        skipped = losses.pop()
        if aggregator is not None:
            for name, value in zip(LOSS_NAMES, losses):
                aggregator.update(name, value)
        if guard:
            summary["skipped"].append(skipped)
            if sentinel.observe(skipped):
                def rollback(good: Dict[str, Any]) -> None:
                    agent.load_state_dict(good["agent"])
                    optimizer.load_state_dict(good["optimizer"])
                    if good.get("rng") is not None:
                        generator.set_state(good["rng"])

                manager.wait()  # the newest save must be published before the rollback looks for it
                sentinel.recover(ckpt_dir, rollback)
        summary["losses"].append(losses)
        summary["rollout_s"].append(t1 - t0)
        summary["gae_s"].append(t2 - t1)
        summary["update_s"].append(t3 - t2)
        summary["iterations"] += 1
        if log_level > 0:
            logger.log_dict({"Info/learning_rate": lr, "Info/clip_coef": clip_coef, "Info/ent_coef": ent_coef},
                            policy_step)
            if envs.env_restarts:
                logger.log_dict({"Fault/env_restarts": envs.env_restarts}, policy_step)
            if guard and sentinel.total_skipped:
                logger.log_dict({"Fault/skipped_updates": sentinel.total_skipped}, policy_step)
            if policy_step - last_log >= log_every or iter_num == total_iters:
                print(f"policy_step={policy_step} " + " ".join(
                    f"{n.split('/')[-1]}={v:.6g}" for n, v in zip(LOSS_NAMES, losses)), flush=True)
                if aggregator is not None:
                    logger.log_dict(aggregator.compute(), policy_step)
                    aggregator.reset()
                log_timers(logger, policy_step, train_step - last_train, (policy_step - last_log) * action_repeat)
                last_log = policy_step
                last_train = train_step

        if algo.anneal_lr:
            lr = polynomial_decay(iter_num, initial=lr0, final=0.0, max_decay_steps=total_iters)
            optimizer.set_lr(lr)
        if algo.anneal_clip_coef:
            clip_coef = polynomial_decay(iter_num, initial=clip_coef0, final=0.0, max_decay_steps=total_iters)
        if algo.anneal_ent_coef:
            ent_coef = polynomial_decay(iter_num, initial=ent_coef0, final=0.0, max_decay_steps=total_iters)

        if (int(cfg.checkpoint.every) > 0 and policy_step - last_checkpoint >= int(cfg.checkpoint.every)) or (
            iter_num == total_iters and cfg.checkpoint.get("save_last", False)
        ):
            last_checkpoint = policy_step
            ckpt_state = {
                "agent": agent.state_dict(),
                "optimizer": optimizer.state_dict(),
                "iter_num": iter_num,
                "batch_size": int(algo.per_rank_batch_size),
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
                "train_step": train_step,
                "last_train": last_train,
                "rng": generator.get_state(),
            }
            path = os.path.join(ckpt_dir, f"ckpt_{policy_step}_0.ckpt")
            summary["checkpoint"] = str(manager.save(path, ckpt_state, step=policy_step, config=plain(cfg)))

    manager.close()
    envs.close()
    profiler.close(total_iters + 1)
    summary["profiler"] = profiler.trace_path
    if algo.get("run_test", True):
        summary["test_reward"], summary["test_steps"] = test(player, cfg, device)
    logger.close()
    env_s = sum(summary["rollout_s"])
    summary.update(
        policy_steps=policy_step,
        log_dir=log_dir,
        env_steps_per_s=summary["iterations"] * policy_steps_per_iter / env_s if env_s > 0 else None,
        rollbacks=sentinel.rollbacks,
        checkpoint_timings=manager.timings,
        **{"Fault/skipped_updates": sentinel.total_skipped, "Fault/env_restarts": envs.env_restarts},
    )
    return summary
