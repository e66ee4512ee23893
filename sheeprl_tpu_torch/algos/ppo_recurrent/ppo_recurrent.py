"""Recurrent PPO coupled training (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/ppo_recurrent.py``, one device).

Each iteration, in the JAX package's order:

- ``rollout_steps`` env steps with one T=1 policy forward each, carrying
  the LSTM pair; each step stores the pair it started from (``prev_hx``,
  ``prev_cx``) and the previous action it was fed (``prev_actions``, zeroed
  where an episode ended). After the step the pair resets where the episode
  ended (``reset_recurrent_state_on_done``). The truncation bootstrap
  ``r += gamma * V(final obs)`` runs from the step's own, pre-reset pair and
  its own unmasked actions.
- GAE on the device (the CUDA ``gae`` kernel on the card), bootstrapped
  with the value of the last observation from the reset pair and the last,
  unmasked actions, as the JAX loop computes it.
- The rollout is chunked on the host into per-episode sequences of
  ``per_rank_sequence_length`` with a mask (:func:`utils.chunk_sequences`),
  their count right-padded with masked sequences to ``8 * 2**k``
  (``_bucket``, the quantum ``per_rank_num_batches``), so which sequences
  share a minibatch is the JAX loop's.
- ``update_epochs`` passes over a permutation of the padded sequences in
  ``per_rank_num_batches`` minibatches: each re-runs the LSTM over its
  ``(SL, mb)`` sequences from their stored first pair, masked-mean PPO
  losses, one clipped Adam step (:func:`make_train_step`).

Random draws come from an explicit ``torch.Generator``: the actions and
each epoch's permutation, which the update also takes as an argument. As
JAX's recurrent PPO, the loop has no in-step guard and no sentinel; its
checkpoints, run directory and metrics are the PPO loop's.

Data-parallel (``run --pod W``) it runs as the PPO loop does
(:mod:`sheeprl_tpu_torch.algos.ppo.ppo`): each rank steps its own envs and
runs GAE on its own rollout; the ranks then gather every rank's rollout
(envs in rank order), chunk it as one, pad the sequence count to the
quantum ``W * per_rank_num_batches`` and each takes its contiguous
``S_pad / W`` sequences, as the JAX step shards the padded sequences over
``dp``; each minibatch's gradients are mean-reduced over the group before
the clipped step, with a permutation of the rank's own.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.ppo import draw_permutations, last10, param_digest, rank_generator
from sheeprl_tpu_torch.algos.ppo.utils import action_spec
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import RecurrentPPOAgent, build_agent, forward_with_actions
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import chunk_sequences, pad_sequences, prepare_obs, test
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.data import ReplayBuffer
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import CheckpointManager, load_resume_state
from sheeprl_tpu_torch.ops.kernels import gae
from sheeprl_tpu_torch.optim import ClippedOptimizer, build_optimizer
from sheeprl_tpu_torch.parallel import pod as pod_runtime
from sheeprl_tpu_torch.parallel.comm import all_gather_rows, all_reduce_mean, broadcast_flag, pmean_grads
from sheeprl_tpu_torch.parallel.fabric import global_rank, world_size
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric, build_aggregator
from sheeprl_tpu_torch.utils.timer import log_timers, timer
from sheeprl_tpu_torch.utils.utils import polynomial_decay

__all__ = ["LOSS_NAMES", "make_optimizer", "make_train_step", "prepare_update", "gather_envs", "main"]

LOSS_NAMES = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")


def make_optimizer(cfg: Any, agent: RecurrentPPOAgent) -> ClippedOptimizer:
    return build_optimizer(agent.trainable_parameters(), cfg.algo.optimizer, cfg.algo.max_grad_norm)


def make_train_step(agent: RecurrentPPOAgent, optimizer: ClippedOptimizer, cfg: Any, s_local: int) -> Callable:
    """The update (JAX ``make_train_step`` on one device) over ``s_local``
    padded sequences: ``train(data, clip_coef, ent_coef, perms=None,
    generator=None) -> losses``. ``data`` holds :func:`prepare_update`'s
    tensors on the agent's device, time-major ``(SL, s_local, ...)``;
    ``perms`` is ``(update_epochs, s_local)``, else drawn from
    ``generator``. Each epoch takes minibatches of ``s_local //
    per_rank_num_batches`` sequences in permutation order; each minibatch's
    losses are means over its own mask. ``losses`` is the ``(3,)`` mean of
    :data:`LOSS_NAMES` over every minibatch of every epoch, on the device.
    In a group of W > 1 processes each minibatch's gradients are
    mean-reduced over the group before the step and ``losses`` is the
    group's mean."""
    algo = cfg.algo
    nb = max(1, int(algo.per_rank_num_batches))
    mb = max(1, s_local // nb)
    n_mb = s_local // mb
    epochs = int(algo.update_epochs)
    clip_vloss = bool(algo.clip_vloss)
    normalize_adv = bool(algo.normalize_advantages)
    vf_coef = float(algo.vf_coef)
    cnn_keys = list(algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(algo.mlp_keys.encoder)
    params = agent.trainable_parameters()

    def minibatch_step(batch: Dict[str, torch.Tensor], clip_coef: torch.Tensor, ent_coef: torch.Tensor):
        w = batch["mask"][..., None]  # (SL, mb, 1)
        wsum = torch.clamp(w.sum(), min=1.0)
        obs = {k: batch[k] / 255.0 - 0.5 if k in cnn_keys else batch[k] for k in obs_keys}
        actions = torch.split(batch["actions"], list(agent.actions_dim), dim=-1)
        advantages = batch["advantages"]
        if normalize_adv:
            mean = (advantages * w).sum() / wsum
            var = (((advantages - mean) ** 2) * w).sum() / wsum
            advantages = (advantages - mean) / (torch.sqrt(var) + 1e-8)
        new_logprobs, entropy, new_values = forward_with_actions(
            agent, obs, batch["prev_actions"], batch["prev_hx"][0], batch["prev_cx"][0], actions
        )
        ratio = torch.exp(new_logprobs - batch["logprobs"])
        pg1 = -advantages * ratio
        pg2 = -advantages * torch.clamp(ratio, 1.0 - clip_coef, 1.0 + clip_coef)
        pg = (torch.maximum(pg1, pg2) * w).sum() / wsum
        if clip_vloss:
            v_clipped = batch["values"] + torch.clamp(new_values - batch["values"], -clip_coef, clip_coef)
            v_elem = torch.maximum((new_values - batch["returns"]) ** 2, (v_clipped - batch["returns"]) ** 2)
            v = 0.5 * (v_elem * w).sum() / wsum
        else:
            v = ((new_values - batch["returns"]) ** 2 * w).sum() / wsum
        ent = -(entropy * w).sum() / wsum
        loss = pg + vf_coef * v + ent_coef * ent
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        optimizer.step(pmean_grads([torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]))
        return torch.stack([pg, v, ent]).detach()

    def train(data: Dict[str, torch.Tensor], clip_coef: "torch.Tensor | float", ent_coef: "torch.Tensor | float",
              perms: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        device = data["mask"].device
        if perms is None:
            perms = draw_permutations(epochs, s_local, generator, device)
        clip_coef = torch.as_tensor(clip_coef, dtype=torch.float32, device=device)
        ent_coef = torch.as_tensor(ent_coef, dtype=torch.float32, device=device)
        idx = perms.to(device)[:, : n_mb * mb].reshape(epochs, n_mb, mb)
        total = torch.zeros(3, dtype=torch.float32, device=device)
        for e in range(epochs):
            for m in range(n_mb):
                total += minibatch_step({k: v[:, idx[e, m]] for k, v in data.items()}, clip_coef, ent_coef)
        return all_reduce_mean(total / (epochs * n_mb))

    return train


def prepare_update(local: Dict[str, np.ndarray], returns: np.ndarray, advantages: np.ndarray, rollout_steps: int,
                   num_envs: int, seq_len: int, quantum: int, device, rank: int = 0,
                   world: int = 1) -> Dict[str, torch.Tensor]:
    """The rollout ``(T, N, ...)`` with its returns and advantages ->
    chunked, padded sequences (:func:`~.utils.chunk_sequences`,
    :func:`~.utils.pad_sequences`) as tensors on ``device``; with ``world``
    > 1, rank ``rank``'s contiguous ``S_pad / world`` of them (``quantum`` a
    multiple of ``world``)."""
    local = dict(local, returns=returns, advantages=advantages)
    padded, mask = chunk_sequences(local, rollout_steps, num_envs, seq_len)
    out = pad_sequences(padded, mask, quantum)
    s_local = out["mask"].shape[1] // world
    return {k: torch.from_numpy(np.ascontiguousarray(v[:, rank * s_local:(rank + 1) * s_local])).to(device)
            for k, v in out.items()}


def gather_envs(local: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every rank's ``(T, N, ...)`` arrays joined on the env axis in rank
    order, ``(T, W * N, ...)``: the rollout of the group's envs, which the
    JAX loop holds whole."""
    return {k: np.moveaxis(all_gather_rows(torch.from_numpy(np.ascontiguousarray(np.moveaxis(v, 1, 0)))).numpy(), 0, 1)
            for k, v in local.items()}


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The coupled loop: roll out with the LSTM pair, GAE, chunk and bucket,
    update, anneal, checkpoint; a greedy test episode at the end with
    ``algo.run_test``. Returns a summary of the run (counters, each
    iteration's losses and padded sequence count, the finished episodes,
    host seconds per phase, the last checkpoint's path and the manager's
    save timings)."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    algo = cfg.algo
    cnn_keys, mlp_keys = list(algo.cnn_keys.encoder), list(algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    if not obs_keys:
        raise RuntimeError("You should specify at least one CNN keys or MLP keys from the cli: "
                           "`algo.cnn_keys.encoder=[rgb]` or `algo.mlp_keys.encoder=[state]`")
    num_envs = int(cfg.env.num_envs)
    rollout_steps = int(algo.rollout_steps)
    seed = int(cfg.seed)
    rank, world = global_rank(), world_size()

    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir, rank)
    print(f"Log dir: {log_dir}", flush=True)
    envs = make_vector_env(cfg, seed, rank=rank)
    cfg["spaces"] = dotdict(envs.spaces)
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
        algo["per_rank_batch_size"] = int(state["batch_size"])

    # the rollout storage holds exactly one rollout, as the JAX loop's
    rb = ReplayBuffer(rollout_steps, num_envs, obs_keys, memmap=bool(cfg.buffer.get("memmap", False)),
                      memmap_dir=os.path.join(log_dir, "memmap_buffer", f"rank_{rank}"),
                      memmap_mode=str(cfg.buffer.get("memmap_mode", "r+")))

    world_envs = num_envs * world  # the counters count every rank's envs
    policy_steps_per_iter = world_envs * rollout_steps
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
    seq_len = int(algo.per_rank_sequence_length)
    quantum = world * max(1, int(algo.per_rank_num_batches))
    gamma, gae_lambda = float(algo.gamma), float(algo.gae_lambda)
    reset_on_done = bool(algo.get("reset_recurrent_state_on_done", True))
    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)
    train_fns: Dict[int, Callable] = {}

    lr = lr0 = float(algo.optimizer.lr)
    clip_coef0, ent_coef0 = float(algo.clip_coef), float(algo.ent_coef)
    clip_coef, ent_coef = clip_coef0, ent_coef0

    reset_obs = envs.reset(seed=seed + rank * num_envs)[0]
    next_obs = {k: np.asarray(reset_obs[k]) for k in obs_keys}
    step_data: Dict[str, np.ndarray] = {k: next_obs[k][np.newaxis] for k in obs_keys}
    states = player.reset_states(num_envs, device)
    n_actions = int(sum(actions_dim))
    prev_actions = np.zeros((1, num_envs, n_actions), dtype=np.float32)
    summary: Dict[str, Any] = {
        "start_iter": start_iter, "iterations": 0, "losses": [], "sequences": [], "episodes": [], "rollout_s": [],
        "gae_s": [], "update_s": [], "checkpoint": None, "device": str(device), "test_reward": None,
        "test_steps": None, "rank": rank, "world_size": world, "drained": False,
    }
    heads = n_actions if is_continuous else len(actions_dim)  # the env's action columns
    hidden = agent.rnn.hidden_size
    for iter_num in range(start_iter, total_iters + 1):
        t0 = time.perf_counter()
        for _ in range(rollout_steps):
            policy_step += world_envs
            with timer("Time/env_interaction_time", SumMetric):
                obs_t = prepare_obs(next_obs, cnn_keys, num_envs, device)
                acts, logprobs, values, new_states = player(obs_t, torch.from_numpy(prev_actions).to(device), states)
                acts_cat = torch.cat(acts, dim=-1)[0]
                env_act = acts_cat if is_continuous else torch.stack([a[0].argmax(dim=-1) for a in acts], dim=-1)
                # one copy to the host per step: the env's actions, what the buffer keeps and the pair it started from
                packed = torch.cat([env_act.to(torch.float32), acts_cat, logprobs[0], values[0], states[0], states[1]],
                                   dim=-1).cpu().numpy()
                real_actions = packed[:, :heads] if is_continuous else packed[:, :heads].astype(np.int64)
                actions_np = packed[None, :, heads:heads + n_actions]
                obs, rewards, terminated, truncated, info = envs.step(real_actions)
                rewards = np.asarray(rewards, dtype=np.float32)
                truncated_envs = np.nonzero(truncated)[0]
                if len(truncated_envs) > 0 and "final_obs" in info:
                    final = {k: np.stack([info["final_obs"][i][k] for i in truncated_envs]) for k in obs_keys}
                    rows = torch.from_numpy(truncated_envs).to(device)
                    vals, _ = player.get_values(prepare_obs(final, cnn_keys, len(truncated_envs), device),
                                                torch.from_numpy(actions_np[:, truncated_envs]).to(device),
                                                (new_states[0][rows], new_states[1][rows]))
                    rewards[truncated_envs] += gamma * vals.float().cpu().numpy().reshape(rewards[truncated_envs].shape)
                dones = np.logical_or(terminated, truncated).reshape(1, num_envs, -1).astype(np.float32)

            off = heads + n_actions
            step_data["dones"] = dones
            step_data["values"] = packed[None, :, off + 1:off + 2]
            step_data["actions"] = actions_np
            step_data["rewards"] = rewards.reshape(1, num_envs, -1)
            step_data["logprobs"] = packed[None, :, off:off + 1]
            step_data["prev_hx"] = packed[None, :, off + 2:off + 2 + hidden]
            step_data["prev_cx"] = packed[None, :, off + 2 + hidden:]
            step_data["prev_actions"] = prev_actions.copy()
            rb.add(step_data, validate_args=cfg.buffer.get("validate_args", False))

            prev_actions = ((1 - dones) * actions_np).astype(np.float32)
            next_obs = {k: np.asarray(obs[k]) for k in obs_keys}
            for k in obs_keys:
                step_data[k] = next_obs[k][np.newaxis]
            if reset_on_done:
                keep = torch.from_numpy(1.0 - dones[0]).to(device)
                states = tuple(keep * s for s in new_states)
            else:
                states = new_states
            for i, ep_rew, ep_len in info.get("episodes", ()):
                summary["episodes"].append((policy_step, i, ep_rew, ep_len))
                if log_level > 0:
                    if aggregator is not None:
                        aggregator.update("Rewards/rew_avg", ep_rew)
                        aggregator.update("Game/ep_len_avg", ep_len)
                    print(f"Rank-{rank}: policy_step={policy_step}, reward_env_{i}={ep_rew}", flush=True)
        t1 = time.perf_counter()

        # GAE on the device, bootstrapped from the reset pair and the last, unmasked actions
        local = {k: np.asarray(v) for k, v in rb.to_numpy().items()}
        next_values, _ = player.get_values(prepare_obs(next_obs, cnn_keys, num_envs, device),
                                           torch.from_numpy(actions_np).to(device), states)
        rewards_t, values_t, dones_t = (torch.from_numpy(np.ascontiguousarray(local[k])).to(device)
                                        for k in ("rewards", "values", "dones"))
        returns, advantages = gae(rewards_t, values_t, dones_t, next_values[0], gamma, gae_lambda)
        returns, advantages = returns.cpu().numpy(), advantages.cpu().numpy()
        t2 = time.perf_counter()

        if world > 1:  # the group's rollout, chunked as one and sharded by sequence
            gathered = gather_envs(dict(local, returns=returns, advantages=advantages))
            returns, advantages = gathered.pop("returns"), gathered.pop("advantages")
            data = prepare_update(gathered, returns, advantages, rollout_steps, world_envs, seq_len, quantum, device,
                                  rank, world)
        else:
            data = prepare_update(local, returns, advantages, rollout_steps, num_envs, seq_len, quantum, device)
        s_pad = int(data["mask"].shape[1])  # this rank's padded sequences
        if s_pad not in train_fns:
            train_fns[s_pad] = make_train_step(agent, optimizer, cfg, s_pad)
        with timer("Time/train_time", SumMetric):
            perm_gen = generator if world == 1 else rank_generator(seed, rank, iter_num, device)
            losses = train_fns[s_pad](data, clip_coef, ent_coef, generator=perm_gen).cpu().tolist()  # the one read
        t3 = time.perf_counter()
        train_step += 1
        if aggregator is not None:
            for name, value in zip(LOSS_NAMES, losses):
                aggregator.update(name, value)
        summary["losses"].append(losses)
        summary["sequences"].append(s_pad)
        summary["rollout_s"].append(t1 - t0)
        summary["gae_s"].append(t2 - t1)
        summary["update_s"].append(t3 - t2)
        summary["iterations"] += 1
        if log_level > 0:
            logger.log_dict({"Info/learning_rate": lr, "Info/clip_coef": clip_coef, "Info/ent_coef": ent_coef},
                            policy_step)
            if policy_step - last_log >= log_every or iter_num == total_iters:
                if rank == 0:
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
                "batch_size": int(algo.per_rank_batch_size),
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
        summary["test_reward"], summary["test_steps"] = test(agent, cfg, device)
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
