"""A2C coupled training (counterpart of ``sheeprl_tpu/algos/a2c/a2c.py``,
one device).

Each iteration, in the JAX package's order: ``rollout_steps`` env steps with
one policy forward each (the truncation bootstrap ``r += gamma * V(final
obs)`` on the envs the time limit cut; a continuous action goes to the env
raw), GAE on the device with the bootstrap value of the last observation
(the CUDA ``gae`` kernel on the card), then ONE optimizer step: the
gradients of every minibatch of one permutation of the rollout are summed,
padded rows weighted 0, clipped by global norm and applied by RMSprop
(:func:`make_train_step`). The losses stay on the device through the update;
the loop reads them once per iteration.

As JAX's A2C, the loop has no in-step guard and no divergence sentinel.
Data-parallel (``run --pod W``) it runs as the PPO loop does
(:mod:`sheeprl_tpu_torch.algos.ppo.ppo`): each rank its own envs, rollout,
GAE and permutation, the summed minibatch gradients mean-reduced over the
group before the one clipped step, the losses the group's means, rank 0
alone writing, the heartbeat and the drain at each iteration's end.
Checkpoints go through the
:class:`~sheeprl_tpu_torch.fault.CheckpointManager`, the rollout lives in
the run's :class:`~sheeprl_tpu_torch.data.ReplayBuffer` (memmapped under the
run directory with ``buffer.memmap``), and at ``metric.log_level`` 1 the
JAX loop's metrics go to ``metrics.jsonl``.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.a2c.agent import A2CAgent, build_agent, forward_with_actions
from sheeprl_tpu_torch.algos.a2c.utils import action_spec, prepare_obs, test
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.data import ReplayBuffer
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import CheckpointManager, load_resume_state
from sheeprl_tpu_torch.ops.kernels import gae
from sheeprl_tpu_torch.algos.ppo.ppo import last10, param_digest, rank_generator
from sheeprl_tpu_torch.optim import ClippedOptimizer, build_optimizer
from sheeprl_tpu_torch.parallel import pod as pod_runtime
from sheeprl_tpu_torch.parallel.comm import all_reduce_mean, broadcast_flag, pmean_grads
from sheeprl_tpu_torch.parallel.fabric import global_rank, world_size
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric, build_aggregator
from sheeprl_tpu_torch.utils.timer import log_timers, timer

__all__ = ["LOSS_NAMES", "make_optimizer", "make_train_step", "main"]

LOSS_NAMES = ("Loss/policy_loss", "Loss/value_loss")


def make_optimizer(cfg: Any, agent: A2CAgent) -> ClippedOptimizer:
    return build_optimizer(agent.parameters(), cfg.algo.optimizer, cfg.algo.max_grad_norm)


def make_train_step(agent: A2CAgent, optimizer: ClippedOptimizer, cfg: Any, local_batch: int) -> Callable:
    """The update (JAX ``make_train_step`` on one device): ``train(data,
    perm=None, generator=None) -> losses``. ``data`` holds the flattened
    rollout, ``(local_batch, ...)`` tensors on the agent's device; ``perm``
    is one ``(local_batch,)`` permutation, else drawn from ``generator``. The
    permutation is padded with row 0 to whole minibatches of
    ``per_rank_batch_size``, the padded rows weighted 0; each minibatch's
    gradient of ``policy + value`` loss (``loss_reduction`` ``sum``, or
    ``mean`` over its real rows) is added to the running sum in minibatch
    order, and the sum takes one clipped optimizer step. ``losses`` is the
    ``(2,)`` mean of :data:`LOSS_NAMES` over the minibatches, on the device.
    In a group of W > 1 processes the sum is mean-reduced over the group
    before the step (JAX's ``pmean_grads`` of the scanned sum), and
    ``losses`` is the group's mean."""
    algo = cfg.algo
    mb_size = int(algo.per_rank_batch_size)
    n_mb = max(1, -(-local_batch // mb_size))
    padded = n_mb * mb_size
    reduction = str(algo.loss_reduction).lower()
    if reduction not in ("sum", "mean"):
        raise ValueError(f"Unrecognized loss_reduction: {algo.loss_reduction}")
    mlp_keys = list(algo.mlp_keys.encoder)
    params = list(agent.parameters())

    def minibatch_grads(batch: Dict[str, torch.Tensor], weight: torch.Tensor):
        obs = {k: batch[k].to(torch.float32) for k in mlp_keys}
        actions = torch.split(batch["actions"], list(agent.actions_dim), dim=-1)
        w = weight[:, None]
        logprobs, _, values = forward_with_actions(agent, obs, actions)
        pg_elem = -(logprobs * batch["advantages"]) * w
        v_elem = ((values - batch["returns"]) ** 2) * w
        if reduction == "mean":
            denom = torch.clamp(w.sum(), min=1.0)
            pg, v = pg_elem.sum() / denom, v_elem.sum() / denom
        else:
            pg, v = pg_elem.sum(), v_elem.sum()
        grads = torch.autograd.grad(pg + v, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)], pg.detach(), v.detach()

    def train(data: Dict[str, torch.Tensor], perm: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        device = data["actions"].device
        if perm is None:
            perm = torch.randperm(local_batch, generator=generator, device=device)
        perm = perm.to(device)
        idx = torch.cat([perm, torch.zeros(padded - local_batch, dtype=perm.dtype, device=device)])
        weights = torch.cat([torch.ones(local_batch, device=device), torch.zeros(padded - local_batch, device=device)])
        idx, weights = idx.reshape(n_mb, mb_size), weights.reshape(n_mb, mb_size)
        acc, losses = None, []
        for m in range(n_mb):
            grads, pg, v = minibatch_grads({k: t[idx[m]] for k, t in data.items()}, weights[m])
            if acc is None:
                acc = grads
            else:
                torch._foreach_add_(acc, grads)
            losses.append(torch.stack([pg, v]))
        optimizer.step(pmean_grads(acc))
        return all_reduce_mean(torch.stack(losses).mean(dim=0))

    return train


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The coupled loop: roll out, GAE, one accumulated update, checkpoint;
    a greedy test episode at the end with ``algo.run_test``. Returns a
    summary of the run (counters, each iteration's losses, the finished
    episodes, host seconds per phase, the last checkpoint's path and the
    manager's save timings)."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    algo = cfg.algo
    obs_keys = list(algo.mlp_keys.encoder)
    if not obs_keys:
        raise RuntimeError("You should specify at least one MLP key for the encoder: `algo.mlp_keys.encoder=[state]`")
    num_envs = int(cfg.env.num_envs)
    rollout_steps = int(algo.rollout_steps)
    seed = int(cfg.seed)
    if int(cfg.buffer.size) < rollout_steps:
        raise ValueError(f"The size of the buffer ({cfg.buffer.size}) cannot be lower than the rollout steps ({rollout_steps})")
    rank, world = global_rank(), world_size()

    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir, rank)
    print(f"Log dir: {log_dir}", flush=True)
    envs = make_vector_env(cfg, seed, rank=rank)
    cfg["spaces"] = dotdict(envs.spaces)
    for k in obs_keys:
        if len(cfg.spaces.obs[k]["shape"]) > 1:
            raise ValueError("Only environments with vector-only observations are supported by the A2C agent. "
                             f"The observation with key '{k}' has shape {tuple(cfg.spaces.obs[k]['shape'])}.")
    actions_dim, is_continuous = action_spec(cfg.spaces)
    logger.log_hyperparams(cfg)
    if rank == 0:
        write_run_config(log_dir, plain(cfg))
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))

    generator = torch.Generator(device=device).manual_seed(seed)
    if state is not None and state.get("rng") is not None:
        generator.set_state(state["rng"])
    agent, player = build_agent(cfg, actions_dim, is_continuous, cfg.spaces.obs, device,
                                state["agent"] if state is not None else None, generator)
    optimizer = make_optimizer(cfg, agent)
    if state is not None:
        optimizer.load_state_dict(state["optimizer"])

    memmap = bool(cfg.buffer.get("memmap", False))
    rb = ReplayBuffer(int(cfg.buffer.size), num_envs, obs_keys, memmap=memmap,
                      memmap_dir=os.path.join(log_dir, "memmap_buffer", f"rank_{rank}"),
                      memmap_mode=str(cfg.buffer.get("memmap_mode", "r+")))

    world_envs = num_envs * world  # the counters count every rank's envs
    policy_steps_per_iter = world_envs * rollout_steps
    start_iter = int(state["iter_num"]) + 1 if state is not None else 1
    policy_step = int(state["iter_num"]) * policy_steps_per_iter if state is not None else 0
    last_log = int(state.get("last_log", 0)) if state is not None else 0
    last_checkpoint = int(state.get("last_checkpoint", 0)) if state is not None else 0
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
    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)
    train_fn = make_train_step(agent, optimizer, cfg, num_envs * rollout_steps)

    reset_obs = envs.reset(seed=seed + rank * num_envs)[0]
    next_obs = {k: np.asarray(reset_obs[k]) for k in obs_keys}
    step_data: Dict[str, np.ndarray] = {k: next_obs[k][np.newaxis] for k in obs_keys}
    summary: Dict[str, Any] = {
        "start_iter": start_iter, "iterations": 0, "losses": [], "episodes": [], "rollout_s": [], "gae_s": [],
        "update_s": [], "checkpoint": None, "device": str(device), "test_reward": None, "test_steps": None,
        "rank": rank, "world_size": world, "drained": False,
    }
    heads = sum(actions_dim) if is_continuous else len(actions_dim)  # the env's action columns
    for iter_num in range(start_iter, total_iters + 1):
        t0 = time.perf_counter()
        for _ in range(rollout_steps):
            policy_step += world_envs
            with timer("Time/env_interaction_time", SumMetric):
                obs_t = prepare_obs(next_obs, (), num_envs, device)
                env_actions, buf_actions, _, values = player.rollout_step(obs_t)
                # one copy to the host per step: the env's actions and what the buffer keeps
                packed = torch.cat([env_actions.to(torch.float32), buf_actions, values], dim=-1).cpu().numpy()
                real_actions = packed[:, :heads] if is_continuous else packed[:, :heads].astype(np.int64)
                obs, rewards, terminated, truncated, info = envs.step(real_actions)
                rewards = np.asarray(rewards, dtype=np.float32)
                truncated_envs = np.nonzero(truncated)[0]
                if len(truncated_envs) > 0 and "final_obs" in info:
                    final = {k: np.stack([info["final_obs"][i][k] for i in truncated_envs]) for k in obs_keys}
                    vals = player.get_values(prepare_obs(final, (), len(truncated_envs), device)).float().cpu().numpy()
                    rewards[truncated_envs] += gamma * vals.reshape(rewards[truncated_envs].shape)
            step_data["dones"] = np.logical_or(terminated, truncated).reshape(1, num_envs, -1).astype(np.uint8)
            step_data["values"] = packed[None, :, -1:]
            step_data["actions"] = packed[None, :, heads:-1]
            step_data["rewards"] = rewards.reshape(1, num_envs, -1)
            if memmap:  # the JAX loop allocates these keys in the memmapped buffer too
                step_data["returns"] = np.zeros_like(step_data["rewards"])
                step_data["advantages"] = np.zeros_like(step_data["rewards"])
            rb.add(step_data, validate_args=cfg.buffer.get("validate_args", False))

            next_obs = {k: np.asarray(obs[k]) for k in obs_keys}
            for k in obs_keys:
                step_data[k] = next_obs[k][np.newaxis]
            for i, ep_rew, ep_len in info.get("episodes", ()):
                summary["episodes"].append((policy_step, i, ep_rew, ep_len))
                if log_level > 0:
                    if aggregator is not None:
                        aggregator.update("Rewards/rew_avg", ep_rew)
                        aggregator.update("Game/ep_len_avg", ep_len)
                    print(f"Rank-{rank}: policy_step={policy_step}, reward_env_{i}={ep_rew}", flush=True)
        t1 = time.perf_counter()

        # GAE on the device, bootstrapped with the value of the last observation
        local = rb.to_numpy()
        next_values = player.get_values(prepare_obs(next_obs, (), num_envs, device))
        on_device = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in local.items()}
        returns, advantages = gae(
            on_device["rewards"], on_device["values"], on_device["dones"], next_values, gamma, gae_lambda
        )
        t2 = time.perf_counter()

        flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in on_device.items()}
        flat["returns"] = returns.reshape(-1, *returns.shape[2:])
        flat["advantages"] = advantages.reshape(-1, *advantages.shape[2:])
        with timer("Time/train_time", SumMetric):
            perm_gen = generator if world == 1 else rank_generator(seed, rank, iter_num, device)
            losses = train_fn(flat, generator=perm_gen).cpu().tolist()  # the one read
        t3 = time.perf_counter()
        train_step += 1
        if aggregator is not None:
            for name, value in zip(LOSS_NAMES, losses):
                aggregator.update(name, value)
        summary["losses"].append(losses)
        summary["rollout_s"].append(t1 - t0)
        summary["gae_s"].append(t2 - t1)
        summary["update_s"].append(t3 - t2)
        summary["iterations"] += 1
        if log_level > 0 and (policy_step - last_log >= log_every or iter_num == total_iters):
            if rank == 0:
                print(f"policy_step={policy_step} " + " ".join(
                    f"{n.split('/')[-1]}={v:.6g}" for n, v in zip(LOSS_NAMES, losses)), flush=True)
            if aggregator is not None:
                logger.log_dict(aggregator.compute(), policy_step)
                aggregator.reset()
            log_timers(logger, policy_step, train_step - last_train, (policy_step - last_log) * action_repeat)
            last_log = policy_step
            last_train = train_step

        pod_runtime.beat_step(policy_step)
        drain_now = broadcast_flag(pod_runtime.drain_requested())
        if (int(cfg.checkpoint.every) > 0 and policy_step - last_checkpoint >= int(cfg.checkpoint.every)) or (
            iter_num == total_iters and cfg.checkpoint.get("save_last", False)
        ) or drain_now:
            last_checkpoint = policy_step
            ckpt_state = {
                "agent": agent.state_dict(),
                "optimizer": optimizer.state_dict(),
                "iter_num": iter_num,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
                "train_step": train_step,
                "last_train": last_train,
                "rng": generator.get_state(),
            }
            if rank == 0:  # every rank holds the same state; rank 0 writes it
                path = os.path.join(ckpt_dir, f"ckpt_{policy_step}_{rank}.ckpt")
                summary["checkpoint"] = str(manager.save(path, ckpt_state, step=policy_step, config=plain(cfg)))
        if drain_now:
            print(f"Rank-{rank}: drain requested — checkpointed at policy_step={policy_step}, exiting", flush=True)
            summary["drained"] = True
            break

    manager.close()
    envs.close()
    if algo.get("run_test", True) and rank == 0:
        summary["test_reward"], summary["test_steps"] = test(player, cfg, device)
    logger.close()
    env_s = sum(summary["rollout_s"])
    summary.update(
        policy_steps=policy_step,
        log_dir=log_dir,
        env_steps_per_s=summary["iterations"] * policy_steps_per_iter / env_s if env_s > 0 else None,
        checkpoint_timings=manager.timings,
        last10=last10(summary["episodes"]),
        param_digest=param_digest(agent) if world > 1 else None,
    )
    return summary
