"""PPO with a decoupled player and trainer (counterpart of
``sheeprl_tpu/algos/ppo/ppo_decoupled.py``, one device).

One **player** thread, on a CUDA stream of its own, does the env steps, the
policy forward of each step on the newest parameter snapshot (a copy the
trainer published, :class:`~sheeprl_tpu_torch.parallel.pipeline.ParamServer`)
and ``gae`` (the CUDA kernel, once per iteration), then hands the flattened
rollout to the **trainer** through a queue of two. The trainer (the calling
thread) waits on the rollout's event, runs the PPO update of
``algos/ppo/ppo.py`` and publishes the new parameters for the player's next
rollout: JAX's one-iteration policy lag. Periodic checkpoints are saved by
the player, from a state the trainer copied to the host when it asked
(JAX's ``on_checkpoint_player``); the last one by the trainer after the
player has ended (``on_checkpoint_trainer``). The player's draws come from a
generator seeded ``seed`` (JAX's ``PRNGKey(seed)``), the trainer's from one
seeded ``seed + 1``; a checkpoint holds the trainer's (``rng``) and a resume
continues it.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import warnings
from typing import Any, Dict, List

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import PPOPlayer, build_agent
from sheeprl_tpu_torch.algos.ppo.ppo import LOSS_NAMES, make_optimizer, make_train_step
from sheeprl_tpu_torch.algos.ppo.utils import action_spec, prepare_obs, test
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.data import ReplayBuffer
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import CheckpointManager, load_resume_state
from sheeprl_tpu_torch.ops.kernels import gae
from sheeprl_tpu_torch.parallel.pipeline import ParamServer, StagedItem, side_stream, stream_id
from sheeprl_tpu_torch.utils.checkpoint import finalize_host, stage_to_host, write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, build_aggregator
from sheeprl_tpu_torch.utils.utils import polynomial_decay

__all__ = ["main", "host_copy"]

#: how long the trainer waits for the player's next rollout before it checks the player is alive
_POLL_S = 1.0


def host_copy(state: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of ``state`` on the host, taken now on the current stream: what
    a checkpoint request hands another thread while training goes on."""
    return finalize_host(stage_to_host(state, copy_host=True))


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The decoupled loop; returns a summary (counters, losses, episodes,
    host seconds per update, the last checkpoint)."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    algo = cfg.algo
    cnn_keys, mlp_keys = list(algo.cnn_keys.encoder), list(algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    if not obs_keys:
        raise RuntimeError("set at least one of algo.cnn_keys.encoder and algo.mlp_keys.encoder")
    num_envs, T, seed = int(cfg.env.num_envs), int(algo.rollout_steps), int(cfg.seed)
    if int(cfg.buffer.size) < T:
        raise ValueError(f"The size of the buffer ({cfg.buffer.size}) cannot be lower than the rollout steps ({T})")

    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    envs = make_vector_env(cfg, seed)
    cfg["spaces"] = dotdict(envs.spaces)
    actions_dim, is_continuous = action_spec(cfg.spaces)
    logger.log_hyperparams(cfg)
    write_run_config(log_dir, plain(cfg))
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))

    trainer_gen = torch.Generator(device=device).manual_seed(seed + 1)
    if state is not None and state.get("rng") is not None:
        trainer_gen.set_state(state["rng"])
    agent, _ = build_agent(cfg, actions_dim, is_continuous, cfg.spaces.obs, device,
                           state["agent"] if state is not None else None)
    optimizer = make_optimizer(cfg, agent)
    if state is not None:
        optimizer.load_state_dict(state["optimizer"])
        algo["per_rank_batch_size"] = int(state["batch_size"])
    rb = ReplayBuffer(int(cfg.buffer.size), num_envs, obs_keys, memmap=bool(cfg.buffer.get("memmap", False)),
                      memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
                      memmap_mode=str(cfg.buffer.get("memmap_mode", "r+")))

    policy_steps_per_iter = num_envs * T
    start_iter = int(state["iter_num"]) + 1 if state is not None else 1
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    total_iters = int(algo.total_steps) // policy_steps_per_iter if not bool(cfg.get("dry_run", False)) else 1
    log_level = int(cfg.metric.get("log_level", 1))
    log_every = int(cfg.metric.get("log_every", 5000))
    if int(cfg.checkpoint.every) % policy_steps_per_iter != 0:
        warnings.warn(f"The checkpoint.every parameter ({cfg.checkpoint.every}) is not a multiple of the "
                      f"policy_steps_per_iter value ({policy_steps_per_iter}).")
    gamma, gae_lambda = float(algo.gamma), float(algo.gae_lambda)
    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)
    train_fn = make_train_step(agent, optimizer, cfg, policy_steps_per_iter)

    param_server = ParamServer(agent)
    param_server.publish()
    rollout_q: "queue.Queue" = queue.Queue(maxsize=2)
    ckpt_q: "queue.Queue" = queue.Queue()
    stop = threading.Event()
    player_errors: List[BaseException] = []
    streams = {"trainer": stream_id(device), "player": None}
    heads = sum(actions_dim) if is_continuous else len(actions_dim)

    def save(req: Dict[str, Any]) -> None:
        manager.save(req["path"], req["state"], step=req["step"], config=plain(cfg))

    def handoff(item: Any) -> bool:
        while not stop.is_set():
            try:
                rollout_q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def player_fn() -> None:
        policy_step = (start_iter - 1) * policy_steps_per_iter
        generator = torch.Generator(device=device).manual_seed(seed)
        try:
            _, stream_ctx = side_stream(device)
            with stream_ctx, torch.no_grad():
                streams["player"] = stream_id(device)
                reset_obs = envs.reset(seed=seed)[0]
                next_obs = {k: np.asarray(reset_obs[k]) for k in obs_keys}
                step_data: Dict[str, np.ndarray] = {k: next_obs[k][np.newaxis] for k in obs_keys}
                for iter_num in range(start_iter, total_iters + 1):
                    version, snap = param_server.pull()
                    try:
                        player = PPOPlayer(snap, generator)
                        episodes = []
                        for _ in range(T):
                            policy_step += num_envs
                            env_act, buf_act, logprobs, values = player.rollout_step(
                                prepare_obs(next_obs, cnn_keys, num_envs, device))
                            packed = torch.cat([env_act.to(torch.float32), buf_act, logprobs, values], dim=-1).cpu().numpy()
                            real = packed[:, :heads] if is_continuous else packed[:, :heads].astype(np.int64)
                            obs, rewards, terminated, truncated, info = envs.step(real)
                            rewards = np.asarray(rewards, dtype=np.float32)
                            truncated_envs = np.nonzero(truncated)[0]
                            if len(truncated_envs) > 0 and "final_obs" in info:
                                final = {k: np.stack([info["final_obs"][i][k] for i in truncated_envs]) for k in obs_keys}
                                vals = player.get_values(prepare_obs(final, cnn_keys, len(truncated_envs), device))
                                rewards[truncated_envs] += gamma * vals.float().cpu().numpy().reshape(
                                    rewards[truncated_envs].shape)
                            step_data["dones"] = np.logical_or(terminated, truncated).reshape(1, num_envs, -1).astype(np.uint8)
                            step_data["values"] = packed[None, :, -1:]
                            step_data["actions"] = packed[None, :, heads:-2]
                            step_data["logprobs"] = packed[None, :, -2:-1]
                            step_data["rewards"] = rewards.reshape(1, num_envs, -1)
                            rb.add(step_data, validate_args=cfg.buffer.get("validate_args", False))
                            next_obs = {k: np.asarray(obs[k]) for k in obs_keys}
                            for k in obs_keys:
                                step_data[k] = next_obs[k][np.newaxis]
                            episodes += [(policy_step, i, ep_rew, ep_len) for i, ep_rew, ep_len in info.get("episodes", ())]
                        # GAE on the player's stream (JAX: the player's jitted gae); a copy
                        # of the buffer, which the next rollout refills while this one trains
                        local = {k: torch.from_numpy(np.array(v)).to(device, non_blocking=False)
                                 for k, v in rb.to_numpy().items()}
                        next_values = player.get_values(prepare_obs(next_obs, cnn_keys, num_envs, device))
                        returns, advantages = gae(local["rewards"], local["values"], local["dones"], next_values,
                                                  gamma, gae_lambda)
                        flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in local.items()}
                        flat["returns"] = returns.reshape(-1, *returns.shape[2:])
                        flat["advantages"] = advantages.reshape(-1, *advantages.shape[2:])
                        item = {"iter_num": iter_num, "policy_step": policy_step, "episodes": episodes,
                                "data": StagedItem.record(flat)}
                    finally:
                        param_server.release(version)
                    if not handoff(item):
                        return
                    while not ckpt_q.empty():  # the player saves what the trainer asked for
                        save(ckpt_q.get_nowait())
        except BaseException as e:  # noqa: BLE001 - the trainer re-raises it
            player_errors.append(e)
        finally:
            handoff(None)

    lr = lr0 = float(algo.optimizer.lr)
    clip_coef0, ent_coef0 = float(algo.clip_coef), float(algo.ent_coef)
    clip_coef, ent_coef = clip_coef0, ent_coef0
    summary: Dict[str, Any] = {
        "start_iter": start_iter, "iterations": 0, "losses": [], "episodes": [], "update_s": [],
        "checkpoint": None, "device": str(device), "test_reward": None, "test_steps": None,
    }
    player_thread = threading.Thread(target=player_fn, name="ppo-player", daemon=True)
    player_thread.start()
    last_item = None
    try:
        while True:
            try:
                item = rollout_q.get(timeout=_POLL_S)
            except queue.Empty:
                if not player_thread.is_alive() and rollout_q.empty():
                    break
                continue
            if item is None:
                break
            last_item = item
            iter_num, policy_step = item["iter_num"], item["policy_step"]
            t0 = time.perf_counter()
            data = item["data"].wait()
            losses, _ = train_fn(data, clip_coef, ent_coef, generator=trainer_gen)
            losses = losses.cpu().tolist()
            param_server.publish()  # the player's next rollout acts on these
            summary["update_s"].append(time.perf_counter() - t0)
            summary["losses"].append(losses)
            summary["iterations"] += 1
            summary["episodes"] += item["episodes"]
            if aggregator is not None:
                for name, value in zip(LOSS_NAMES, losses):
                    aggregator.update(name, value)
            for step, i, ep_rew, ep_len in item["episodes"]:
                if log_level > 0:
                    if aggregator is not None:
                        aggregator.update("Rewards/rew_avg", ep_rew)
                        aggregator.update("Game/ep_len_avg", ep_len)
                    print(f"Rank-0: policy_step={step}, reward_env_{i}={ep_rew}", flush=True)
            if policy_step - last_log >= log_every or iter_num == total_iters:
                if log_level > 0:
                    if aggregator is not None:
                        logger.log_dict(aggregator.compute(), policy_step)
                        aggregator.reset()
                    logger.log_dict({"Info/learning_rate": lr, "Info/clip_coef": clip_coef,
                                     "Info/ent_coef": ent_coef}, policy_step)
                last_log = policy_step
            if algo.anneal_lr:
                lr = polynomial_decay(iter_num, initial=lr0, final=0.0, max_decay_steps=total_iters)
                optimizer.set_lr(lr)
            if algo.anneal_clip_coef:
                clip_coef = polynomial_decay(iter_num, initial=clip_coef0, final=0.0, max_decay_steps=total_iters)
            if algo.anneal_ent_coef:
                ent_coef = polynomial_decay(iter_num, initial=ent_coef0, final=0.0, max_decay_steps=total_iters)
            if int(cfg.checkpoint.every) > 0 and policy_step - last_checkpoint >= int(cfg.checkpoint.every):
                last_checkpoint = policy_step
                path = os.path.join(ckpt_dir, f"ckpt_{policy_step}_0.ckpt")
                ckpt_q.put({"path": path, "step": policy_step, "state": host_copy({
                    "agent": agent.state_dict(), "optimizer": optimizer.state_dict(), "scheduler": None,
                    "iter_num": iter_num, "batch_size": int(algo.per_rank_batch_size), "last_log": last_log,
                    "last_checkpoint": last_checkpoint, "rng": trainer_gen.get_state()})})
                summary["checkpoint"] = path
    finally:
        stop.set()
        while player_thread.is_alive():
            try:  # unblock a player waiting on a full queue
                rollout_q.get_nowait()
            except queue.Empty:
                pass
            player_thread.join(timeout=_POLL_S)
    if player_errors:
        raise player_errors[0]
    while not ckpt_q.empty():  # requests made after the player's last rollout
        save(ckpt_q.get_nowait())
    if cfg.checkpoint.get("save_last", False) and last_item is not None:
        path = os.path.join(ckpt_dir, f"ckpt_{last_item['policy_step']}_0.ckpt")
        summary["checkpoint"] = str(manager.save(path, {
            "agent": agent.state_dict(), "optimizer": optimizer.state_dict(), "scheduler": None,
            "iter_num": last_item["iter_num"], "batch_size": int(algo.per_rank_batch_size), "last_log": last_log,
            "last_checkpoint": last_checkpoint, "rng": trainer_gen.get_state()}, step=last_item["policy_step"],
            config=plain(cfg)))
    manager.close()
    envs.close()
    if algo.get("run_test", True):
        summary["test_reward"], summary["test_steps"] = test(PPOPlayer(agent), cfg, device)
    logger.close()
    summary.update(policy_steps=last_item["policy_step"] if last_item else (start_iter - 1) * policy_steps_per_iter,
                   log_dir=log_dir, streams=streams)
    return summary
