"""DroQ coupled training (counterpart of ``sheeprl_tpu/algos/droq/droq.py``,
one device a process, the host replay buffer).

Each iteration, in the JAX package's order: one env step of ``num_envs``
envs (uniform random actions until ``learning_starts``, then the actor's
samples), the transition stored, then the train call the ``Ratio`` grants
(its prefill counted in policy steps, as the JAX DroQ counts it): G critic
steps on G sampled batches, each the TD update of the dropout ensemble
against the target ensemble (dropout live in both) followed by the target
EMA, then ONE actor step and ONE entropy-coefficient step on a separately
sampled batch. The actor regresses the ensemble's mean Q, not its minimum.

Under ``run --pod N`` (a ``torch.distributed`` group of N processes, one
device each) every rank steps its own ``env.num_envs`` envs (env ``i`` of
rank ``r`` seeded ``seed + r * num_envs + i``) and counts its own policy
steps, as the JAX loop counts one process's envs, so every rank's ``Ratio``
grants the same steps; each trains on ``per_rank_batch_size // N`` rows of
its own data (a batch that N does not divide raises JAX's ``ValueError``),
and the steps mean-reduce their gradients and losses over the group. Its
draws: the generators are re-seeded at the run's start, fresh or resumed,
from (seed, rank, start iteration) (``parallel/fabric.py:rank_seed``), where
JAX folds the rank into its key; at one process nothing is re-seeded. Rank 0
alone logs, writes the config, runs the test episode and checkpoints, its
buffer included, as JAX's ``CheckpointCallback._save`` does; every rank
resumes from that checkpoint. Each iteration beats the pod's heartbeat and
broadcasts rank 0's drain flag.

Random numbers (the Gaussian noise and the dropout masks) come from an
explicit ``torch.Generator`` or are passed in (:func:`draw_noise` gives
their shapes), so a test can feed JAX's draws and masks. The losses stay on
the device until a log point reads them. The JAX DroQ runs no finite guard
and no sentinel, and neither does this one.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.droq.agent import DroQAgent, build_agent
from sheeprl_tpu_torch.algos.ppo.ppo import last10, param_digest
from sheeprl_tpu_torch.algos.sac.loss import critic_loss, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.sac import LOSS_NAMES, RING_KEYS, _to_device, make_optimizers
from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.data import ReplayBuffer
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import CheckpointManager, load_resume_state
from sheeprl_tpu_torch.parallel import pod as pod_runtime
from sheeprl_tpu_torch.parallel.comm import all_reduce_mean, broadcast_flag, pmean_grads
from sheeprl_tpu_torch.parallel.fabric import global_rank, rank_seed, world_size
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric, build_aggregator
from sheeprl_tpu_torch.utils.timer import log_timers, timer
from sheeprl_tpu_torch.utils.utils import Ratio

__all__ = ["draw_noise", "make_train_step", "main"]


def draw_noise(agent: DroQAgent, G: int, B: int, generator: Optional[torch.Generator], device) -> Dict[str, Any]:
    """One train call's draws: ``next`` ``(G, B, A)`` normals for the TD
    target's actions, ``target_masks`` and ``online_masks`` ``(G, 2, n, B,
    hidden)`` dropout masks for each critic step's target and online
    passes, ``actor`` ``(B, A)`` normals and ``actor_masks`` ``(2, n, B,
    hidden)`` for the actor step (masks None without dropout)."""
    critic = agent.critic

    def masks(g: int):
        if critic.dropout <= 0.0:
            return None
        return torch.stack([critic.draw_masks(B, generator, device) for _ in range(g)])

    return {
        "next": torch.randn((G, B, agent.action_dim), generator=generator, device=device),
        "target_masks": masks(G),
        "online_masks": masks(G),
        "actor": torch.randn((B, agent.action_dim), generator=generator, device=device),
        "actor_masks": critic.draw_masks(B, generator, device),
    }


def make_train_step(agent: DroQAgent, optimizers, cfg: Any) -> Callable:
    """The train call (JAX ``make_train_step`` on one device):
    ``train(critic_data, actor_data, noise=None, generator=None) -> losses``.
    ``critic_data`` holds ``(G, B, ...)`` and ``actor_data`` ``(B, ...)``
    float32 tensors of :data:`RING_KEYS` on the agent's device; ``noise`` is
    a :func:`draw_noise` dict, else drawn from ``generator``. Returns the
    ``(3,)`` tensor of :data:`LOSS_NAMES`: the critic loss's mean over the G
    steps, the actor's and the entropy coefficient's loss, on the device.

    Under a data-parallel group the batches are this rank's share, each
    critic step's gradients and the actor's and the entropy coefficient's
    are mean-reduced before their optimizer steps (JAX ``droq.py:68,94,102``),
    and the three losses are the group's means (``:106-108``)."""
    actor_opt, critic_opt, alpha_opt = optimizers
    actor_params, critic_params = list(agent.actor.parameters()), list(agent.critic.parameters())
    gamma = float(cfg.algo.gamma)

    def train(critic_data: Dict[str, torch.Tensor], actor_data: Dict[str, torch.Tensor],
              noise: Optional[Dict[str, Any]] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        G, B = critic_data["actions"].shape[:2]
        device = critic_data["actions"].device
        if noise is None:
            noise = draw_noise(agent, G, B, generator, device)

        def masks(name: str, g: int):
            return None if noise[name] is None else noise[name][g]

        qf_total = torch.zeros((), dtype=torch.float32, device=device)
        for g in range(G):
            batch = {k: critic_data[k][g] for k in RING_KEYS}
            td_target = agent.next_target_q_droq(batch["next_observations"], batch["rewards"], batch["terminated"],
                                                 gamma, noise["next"][g], masks("target_masks", g))
            q = agent.critic(batch["observations"], batch["actions"], masks("online_masks", g))
            qf_loss = critic_loss(q, td_target)
            critic_opt.step(pmean_grads(torch.autograd.grad(qf_loss, critic_params)))
            agent.ema()  # after every critic step
            qf_total += qf_loss.detach()

        obs = actor_data["observations"]
        alpha = torch.exp(agent.log_alpha.detach())
        actions, logp = agent.sample_action(obs, noise["actor"])
        mean_q = torch.mean(agent.critic(obs, actions, noise["actor_masks"]), dim=-1, keepdim=True)
        actor_loss = policy_loss(alpha, logp, mean_q)
        actor_opt.step(pmean_grads(torch.autograd.grad(actor_loss, actor_params)))

        alpha_loss = entropy_loss(agent.log_alpha, logp.detach(), agent.target_entropy)
        alpha_opt.step(pmean_grads(torch.autograd.grad(alpha_loss, [agent.log_alpha])))
        return all_reduce_mean(torch.stack([qf_total / G, actor_loss.detach(), alpha_loss.detach()]))

    return train


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The coupled loop on the host buffer: act, store, train, log,
    checkpoint; a greedy test episode at the end with ``algo.run_test``.
    Returns a summary of the run (counters, the losses of every log point,
    the finished episodes, the last checkpoint's path)."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    algo = cfg.algo
    if list(algo.cnn_keys.encoder):
        warnings.warn("DroQ algorithm cannot allow to use images as observations, the CNN keys will be ignored")
        algo.cnn_keys["encoder"] = []
    mlp_keys = list(algo.mlp_keys.encoder)
    if not mlp_keys:
        raise RuntimeError("You should specify at least one MLP key for the encoder: `mlp_keys.encoder=[state]`")
    sample_next_obs = bool(cfg.buffer.get("sample_next_obs", False))
    num_envs = int(cfg.env.num_envs)
    seed = int(cfg.seed)
    rank, world = global_rank(), world_size()

    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir, rank)
    print(f"Log dir: {log_dir}", flush=True)
    envs = make_vector_env(cfg, seed, rank=rank)
    cfg["spaces"] = dotdict(envs.spaces)
    action_space = cfg.spaces.actions
    if not action_space.get("continuous", False):
        raise ValueError("Only continuous action space is supported for the DroQ agent")
    for k in mlp_keys:
        if len(cfg.spaces.obs[k].shape) > 1:
            raise ValueError("Only environments with vector-only observations are supported by the DroQ agent. "
                             f"The observation with key '{k}' has shape {tuple(cfg.spaces.obs[k].shape)}.")
    logger.log_hyperparams(cfg)
    if rank == 0:
        write_run_config(log_dir, plain(cfg))
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))
    obs_dim = int(sum(np.prod(cfg.spaces.obs[k].shape) for k in mlp_keys))
    low, high = np.asarray(action_space.low, np.float32), np.asarray(action_space.high, np.float32)

    generator = torch.Generator(device=device).manual_seed(seed)
    if state is not None and state.get("rng") is not None:
        generator.set_state(state["rng"])
    agent, player = build_agent(cfg, obs_dim, action_space, device, state["agent"] if state is not None else None,
                                generator)
    optimizers = make_optimizers(cfg, agent)
    if state is not None:
        for opt, name in zip(optimizers, ("actor_optimizer", "qf_optimizer", "alpha_optimizer")):
            opt.load_state_dict(state[name])
        algo["per_rank_batch_size"] = int(state["batch_size"])
    batch_size = int(algo.per_rank_batch_size)
    if batch_size % world != 0:
        raise ValueError(f"per_rank_batch_size ({batch_size}) must be divisible by the number of devices ({world})")
    local_batch = batch_size // world  # each rank trains on its share, drawn from its own data
    dry_run = bool(cfg.get("dry_run", False))
    train_fn = make_train_step(agent, optimizers, cfg)

    rb = ReplayBuffer(int(cfg.buffer.size) // num_envs if not dry_run else 1, num_envs, ("observations",),
                      memmap=bool(cfg.buffer.get("memmap", False)),
                      memmap_dir=os.path.join(log_dir, "memmap_buffer", f"rank_{rank}"),
                      memmap_mode=str(cfg.buffer.get("memmap_mode", "r+")))
    rb.seed(seed)
    if state is not None and cfg.buffer.checkpoint and state.get("rb") is not None:
        rb.load_state_dict(state["rb"])

    start_iter = int(state["iter_num"]) + 1 if state is not None else 1
    policy_step = int(state["iter_num"]) * num_envs if state is not None else 0
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    total_iters = int(algo.total_steps) // num_envs if not dry_run else 1
    learning_starts = int(algo.get("learning_starts", 0)) // num_envs if not dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    if state is not None:
        learning_starts += start_iter
        prefill_steps += start_iter
    ratio = Ratio(float(algo.replay_ratio), pretrain_steps=int(algo.per_rank_pretrain_steps))
    if state is not None:
        ratio.load_state_dict(state["ratio"])
    log_level = int(cfg.metric.get("log_level", 1))
    log_every = int(cfg.metric.get("log_every", 5000))
    action_repeat = int(cfg.env.get("action_repeat", 1) or 1)
    train_step = int(state.get("train_step", 0)) if state is not None else 0
    last_train = int(state.get("last_train", 0)) if state is not None else 0
    if log_level > 0 and log_every % num_envs != 0:
        warnings.warn(f"The metric.log_every parameter ({log_every}) is not a multiple of the "
                      f"policy_steps_per_iter value ({num_envs}).")
    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)

    action_rng = np.random.default_rng(seed if world == 1 else [seed, rank])
    if world > 1:
        # each rank's own draws from here on, whatever checkpoint it resumed
        # (every rank of a restarted pod reads rank 0's); the buffer keeps its rows
        generator.manual_seed(rank_seed(seed, rank, start_iter))
        rb.seed(rank_seed(seed + 1, rank, start_iter))
    obs = envs.reset(seed=seed + rank * num_envs)[0]
    summary: Dict[str, Any] = {"start_iter": start_iter, "iterations": 0, "gradient_steps": 0, "train_calls": 0,
                               "losses": [], "episodes": [], "train_s": [], "checkpoint": None, "device": str(device),
                               "test_reward": None, "test_steps": None, "rank": rank, "world_size": world,
                               "drained": False}
    pending: List[torch.Tensor] = []

    def read_losses() -> None:
        if pending:
            rows = torch.stack(pending).cpu().tolist()
            pending.clear()
            summary["losses"].extend(rows)
            if aggregator is not None:
                for row in rows:
                    for name, value in zip(LOSS_NAMES, row):
                        aggregator.update(name, value)

    t_loop = time.perf_counter()
    for iter_num in range(start_iter, total_iters + 1):
        policy_step += num_envs
        with timer("Time/env_interaction_time", SumMetric):
            if iter_num <= learning_starts:
                actions = action_rng.uniform(low, high, size=(num_envs, len(low))).astype(np.float32)
            else:
                actions = player(prepare_obs(obs, mlp_keys, num_envs, device)).float().cpu().numpy()
            next_obs, rewards, terminated, truncated, infos = envs.step(actions)
        for i, ep_rew, ep_len in infos.get("episodes", ()):
            summary["episodes"].append((policy_step, i, ep_rew, ep_len))
            if log_level > 0:
                if aggregator is not None:
                    aggregator.update("Rewards/rew_avg", ep_rew)
                    aggregator.update("Game/ep_len_avg", ep_len)
                print(f"Rank-{rank}: policy_step={policy_step}, reward_env_{i}={ep_rew}", flush=True)

        step_data = {
            "terminated": np.asarray(terminated, dtype=np.uint8).reshape(1, num_envs, -1),
            "truncated": np.asarray(truncated, dtype=np.uint8).reshape(1, num_envs, -1),
            "actions": actions.astype(np.float32).reshape(1, num_envs, -1),
            "observations": prepare_obs(obs, mlp_keys, num_envs).numpy()[np.newaxis],
            "rewards": np.asarray(rewards, dtype=np.float32).reshape(1, num_envs, -1),
        }
        if not sample_next_obs:
            real_next_obs = {k: np.array(next_obs[k]) for k in mlp_keys}
            for i, final in enumerate(infos.get("final_obs", ())):
                if final is not None:  # the episode's last observation, not the reset one
                    for k in mlp_keys:
                        real_next_obs[k][i] = final[k]
            step_data["next_observations"] = prepare_obs(real_next_obs, mlp_keys, num_envs).numpy()[np.newaxis]
        rb.add(step_data, validate_args=cfg.buffer.get("validate_args", False))
        obs = next_obs

        if iter_num >= learning_starts:
            # the JAX DroQ counts its prefill in policy steps here
            granted = ratio(policy_step - prefill_steps * num_envs)
            if granted > 0:
                t0 = time.perf_counter()
                with timer("Time/replay_path_time", SumMetric):
                    critic_data = _to_device(rb.sample(local_batch, granted, sample_next_obs=sample_next_obs), device)
                    actor_data = {k: v[0] for k, v in _to_device(
                        rb.sample(local_batch, 1, sample_next_obs=sample_next_obs), device).items()}
                with timer("Time/train_time", SumMetric):
                    pending.append(train_fn(critic_data, actor_data, generator=generator))
                summary["train_s"].append(time.perf_counter() - t0)
                summary["gradient_steps"] += granted
                summary["train_calls"] += 1
                train_step += 1

        if policy_step - last_log >= log_every or iter_num == total_iters:
            read_losses()
            if log_level > 0:
                if aggregator is not None:
                    logger.log_dict(aggregator.compute(), policy_step)
                    aggregator.reset()
                logger.log_dict({"Params/replay_ratio": summary["gradient_steps"] / policy_step}, policy_step)
                log_timers(logger, policy_step, train_step - last_train, (policy_step - last_log) * action_repeat)
                last_train = train_step
            last_log = policy_step

        summary["iterations"] += 1
        # the pod's heartbeat, and rank 0's drain flag on every rank
        pod_runtime.beat_step(policy_step)
        drain_now = broadcast_flag(pod_runtime.drain_requested())
        if (int(cfg.checkpoint.every) > 0 and policy_step - last_checkpoint >= int(cfg.checkpoint.every)) or (
            iter_num == total_iters and cfg.checkpoint.get("save_last", False)
        ) or drain_now:
            last_checkpoint = policy_step
            ckpt_state = {
                "agent": agent.state_dict(),
                "qf_optimizer": optimizers[1].state_dict(),
                "actor_optimizer": optimizers[0].state_dict(),
                "alpha_optimizer": optimizers[2].state_dict(),
                "ratio": ratio.state_dict(),
                "iter_num": iter_num,
                "batch_size": batch_size,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
                "train_step": train_step,
                "last_train": last_train,
                "rng": generator.get_state(),
            }
            if rank == 0:  # rank 0 alone writes, its buffer included (JAX CheckpointCallback._save)
                if cfg.buffer.checkpoint:
                    ckpt_state["rb"] = rb.checkpoint_state_dict()
                path = os.path.join(ckpt_dir, f"ckpt_{policy_step}_0.ckpt")
                summary["checkpoint"] = str(manager.save(path, ckpt_state, step=policy_step, config=plain(cfg)))
        if drain_now:
            print(f"Rank-{rank}: drain requested — checkpointed at policy_step={policy_step}, exiting", flush=True)
            summary["drained"] = True
            break

    manager.close()
    read_losses()
    loop_s = time.perf_counter() - t_loop
    envs.close()
    if algo.get("run_test", True) and rank == 0:
        summary["test_reward"], summary["test_steps"] = test(player, cfg, device)
    logger.close()
    steps = policy_step - (start_iter - 1) * num_envs
    summary.update(policy_steps=policy_step, log_dir=log_dir,
                   loop_steps_per_s=steps / loop_s if loop_s > 0 else None, env_steps_per_s=steps / loop_s if loop_s > 0
                   else None, last10=last10(summary["episodes"]),
                   param_digest=param_digest(agent) if world > 1 else None,
                   checkpoint_timings=manager.timings, **{"Fault/env_restarts": envs.env_restarts})
    return summary
