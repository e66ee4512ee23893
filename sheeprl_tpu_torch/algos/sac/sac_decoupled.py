"""SAC with a decoupled player and trainer (counterpart of
``sheeprl_tpu/algos/sac/sac_decoupled.py``, one device; JAX deprecates it
for ``sac_sebulba`` and keeps it as the host-sampling fallback).

The **player** thread, on a CUDA stream of its own, owns the host
``ReplayBuffer`` and the ``Ratio`` governor: it steps the envs (uniform
random actions until ``learning_starts``, then the newest published actor's
samples), stores each transition, samples the ``G`` batches the governor
grants, uploads them in one copy and hands them to the **trainer** through a
queue of two. The trainer (the calling thread) runs the coupled loop's host
update (``algos/sac/sac.py:make_train_step``: G gradient steps, each a
critic, EMA, actor and entropy update) and publishes the actor. Periodic
checkpoints are saved by the player with its buffer and governor attached
(JAX's ``on_checkpoint_player``), from a state the trainer copied to the host
when it asked; the last one by the trainer after the player has ended.
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

from sheeprl_tpu_torch.algos.ppo.ppo_decoupled import host_copy
from sheeprl_tpu_torch.algos.sac.agent import SACPlayer, build_agent
from sheeprl_tpu_torch.algos.sac.sac import LOSS_NAMES, _to_device, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.sac.sac_sebulba import make_act_step
from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.data import ReplayBuffer
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import CheckpointManager, load_resume_state
from sheeprl_tpu_torch.parallel.pipeline import ParamServer, StagedItem, side_stream, stream_id
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, build_aggregator
from sheeprl_tpu_torch.utils.utils import Ratio

__all__ = ["main"]

_POLL_S = 1.0


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The decoupled loop; returns a summary (counters, losses, episodes,
    gradient steps, the last checkpoint)."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    algo = cfg.algo
    if list(algo.cnn_keys.encoder):
        warnings.warn("SAC algorithm cannot allow to use images as observations, the CNN keys will be ignored")
        algo.cnn_keys["encoder"] = []
    mlp_keys = list(algo.mlp_keys.encoder)
    if not mlp_keys:
        raise RuntimeError("You should specify at least one MLP key for the encoder: `mlp_keys.encoder=[state]`")
    sample_next_obs = bool(cfg.buffer.get("sample_next_obs", False))
    num_envs, seed = int(cfg.env.num_envs), int(cfg.seed)
    dry_run = bool(cfg.get("dry_run", False))

    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    envs = make_vector_env(cfg, seed)
    cfg["spaces"] = dotdict(envs.spaces)
    action_space = cfg.spaces.actions
    if not action_space.get("continuous", False):
        raise ValueError("Only continuous action space is supported for the SAC agent")
    logger.log_hyperparams(cfg)
    write_run_config(log_dir, plain(cfg))
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))
    obs_dim = int(sum(np.prod(cfg.spaces.obs[k]["shape"]) for k in mlp_keys))
    act_dim = int(np.prod(action_space["shape"]))
    low, high = np.asarray(action_space["low"], np.float32), np.asarray(action_space["high"], np.float32)

    trainer_gen = torch.Generator(device=device).manual_seed(seed + 1)
    if state is not None and state.get("rng") is not None:
        trainer_gen.set_state(state["rng"])
    agent, _ = build_agent(cfg, obs_dim, action_space, device, state["agent"] if state is not None else None)
    optimizers = make_optimizers(cfg, agent)
    if state is not None:
        for opt, name in zip(optimizers, ("actor_optimizer", "qf_optimizer", "alpha_optimizer")):
            opt.load_state_dict(state[name])
        algo["per_rank_batch_size"] = int(state["batch_size"])
    batch_size = int(algo.per_rank_batch_size)

    buffer_size = int(cfg.buffer.size) // num_envs if not dry_run else 1
    rb = ReplayBuffer(buffer_size, num_envs, ("observations",), memmap=bool(cfg.buffer.get("memmap", False)),
                      memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
                      memmap_mode=str(cfg.buffer.get("memmap_mode", "r+")))
    rb.seed(seed)
    if state is not None and cfg.buffer.checkpoint and state.get("rb") is not None:
        rb.load_state_dict(state["rb"])

    policy_steps_per_iter = num_envs
    start_iter = int(state["iter_num"]) + 1 if state is not None else 1
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    total_iters = int(algo.total_steps) // policy_steps_per_iter if not dry_run else 1
    learning_starts = int(algo.get("learning_starts", 0)) // policy_steps_per_iter if not dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    if state is not None:
        learning_starts += start_iter
        prefill_steps += start_iter
    ratio = Ratio(float(algo.replay_ratio), pretrain_steps=int(algo.per_rank_pretrain_steps))
    if state is not None:
        ratio.load_state_dict(state["ratio"])
    ema_modulus = int(algo.critic.target_network_frequency) // policy_steps_per_iter + 1
    log_level = int(cfg.metric.get("log_level", 1))
    log_every = int(cfg.metric.get("log_every", 5000))
    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)
    train_fn = make_train_step(agent, optimizers, cfg)
    act_fn = make_act_step(agent)

    param_server = ParamServer(agent.actor)
    param_server.publish()
    batch_q: "queue.Queue" = queue.Queue(maxsize=2)
    ckpt_q: "queue.Queue" = queue.Queue()
    stop = threading.Event()
    player_errors: List[BaseException] = []
    streams = {"trainer": stream_id(device), "player": None}

    def save(req: Dict[str, Any], with_buffer: bool) -> None:
        ckpt = dict(req["state"])
        ckpt["ratio"] = ratio.state_dict()
        if with_buffer and cfg.buffer.checkpoint:
            ckpt["rb"] = rb.checkpoint_state_dict()
        manager.save(req["path"], ckpt, step=req["step"], config=plain(cfg))

    def handoff(item: Any) -> bool:
        while not stop.is_set():
            try:
                batch_q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def player_fn() -> None:
        policy_step = (start_iter - 1) * policy_steps_per_iter
        generator = torch.Generator(device=device).manual_seed(seed)
        action_rng = np.random.default_rng(seed)
        try:
            _, stream_ctx = side_stream(device)
            with stream_ctx, torch.no_grad():
                streams["player"] = stream_id(device)
                obs = envs.reset(seed=seed)[0]
                episodes: List = []
                for iter_num in range(start_iter, total_iters + 1):
                    policy_step += policy_steps_per_iter
                    if iter_num <= learning_starts:
                        actions = action_rng.uniform(low, high, size=(num_envs, act_dim)).astype(np.float32)
                    else:
                        version, actor = param_server.pull()
                        try:
                            noise = torch.randn((num_envs, act_dim), generator=generator, device=device)
                            actions = act_fn(actor, prepare_obs(obs, mlp_keys, num_envs, device),
                                             noise).float().cpu().numpy()
                        finally:
                            param_server.release(version)
                    next_obs, rewards, terminated, truncated, infos = envs.step(actions)
                    episodes += [(policy_step, i, r, n) for i, r, n in infos.get("episodes", ())]
                    step_data = {
                        "terminated": np.asarray(terminated, dtype=np.uint8).reshape(1, num_envs, -1),
                        "truncated": np.asarray(truncated, dtype=np.uint8).reshape(1, num_envs, -1),
                        "actions": actions.reshape(1, num_envs, -1),
                        "observations": prepare_obs(obs, mlp_keys, num_envs).numpy()[np.newaxis],
                        "rewards": np.asarray(rewards, dtype=np.float32).reshape(1, num_envs, -1),
                    }
                    if not sample_next_obs:
                        real_next_obs = {k: np.array(next_obs[k]) for k in mlp_keys}
                        for i, final in enumerate(infos.get("final_obs", ())):
                            if final is not None:
                                for k in mlp_keys:
                                    real_next_obs[k][i] = final[k]
                        step_data["next_observations"] = prepare_obs(real_next_obs, mlp_keys, num_envs).numpy()[np.newaxis]
                    rb.add(step_data, validate_args=cfg.buffer.get("validate_args", False))
                    obs = next_obs
                    # the player samples and ships the granted batches (JAX: sac_decoupled.py:281-299)
                    if iter_num >= learning_starts:
                        granted = ratio(policy_step - prefill_steps + policy_steps_per_iter)
                        if granted > 0:
                            data = _to_device(rb.sample(batch_size, granted, sample_next_obs=sample_next_obs), device)
                            item = {"iter_num": iter_num, "policy_step": policy_step, "granted": granted,
                                    "episodes": episodes, "data": StagedItem.record(data)}
                            episodes = []
                            if not handoff(item):
                                return
                    while not ckpt_q.empty():  # the player saves what the trainer asked for, with its buffer
                        save(ckpt_q.get_nowait(), True)
        except BaseException as e:  # noqa: BLE001 - the trainer re-raises it
            player_errors.append(e)
        finally:
            handoff(None)

    summary: Dict[str, Any] = {
        "start_iter": start_iter, "iterations": 0, "gradient_steps": 0, "train_calls": 0, "losses": [],
        "episodes": [], "train_s": [], "checkpoint": None, "device": str(device), "test_reward": None,
        "test_steps": None,
    }
    player_thread = threading.Thread(target=player_fn, name="sac-player", daemon=True)
    player_thread.start()
    last_item = None
    try:
        while True:
            try:
                item = batch_q.get(timeout=_POLL_S)
            except queue.Empty:
                if not player_thread.is_alive() and batch_q.empty():
                    break
                continue
            if item is None:
                break
            last_item = item
            iter_num, policy_step = item["iter_num"], item["policy_step"]
            t0 = time.perf_counter()
            losses, _ = train_fn(item["data"].wait(), iter_num % ema_modulus == 0, generator=trainer_gen)
            losses = losses.cpu().tolist()
            param_server.publish()
            summary["train_s"].append(time.perf_counter() - t0)
            summary["losses"].append(losses)
            summary["gradient_steps"] += item["granted"]
            summary["train_calls"] += 1
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
                if log_level > 0 and aggregator is not None:
                    logger.log_dict(aggregator.compute(), policy_step)
                    aggregator.reset()
                last_log = policy_step
            if int(cfg.checkpoint.every) > 0 and policy_step - last_checkpoint >= int(cfg.checkpoint.every):
                last_checkpoint = policy_step
                path = os.path.join(ckpt_dir, f"ckpt_{policy_step}_0.ckpt")
                ckpt_q.put({"path": path, "step": policy_step, "state": host_copy({
                    "agent": agent.state_dict(), "qf_optimizer": optimizers[1].state_dict(),
                    "actor_optimizer": optimizers[0].state_dict(), "alpha_optimizer": optimizers[2].state_dict(),
                    "iter_num": iter_num, "batch_size": batch_size, "last_log": last_log,
                    "last_checkpoint": last_checkpoint, "rng": trainer_gen.get_state()})})
                summary["checkpoint"] = path
    finally:
        stop.set()
        while player_thread.is_alive():
            try:
                batch_q.get_nowait()
            except queue.Empty:
                pass
            player_thread.join(timeout=_POLL_S)
    if player_errors:
        raise player_errors[0]
    while not ckpt_q.empty():
        save(ckpt_q.get_nowait(), True)
    policy_steps = total_iters * policy_steps_per_iter
    if cfg.checkpoint.get("save_last", False) and last_item is not None:
        path = os.path.join(ckpt_dir, f"ckpt_{last_item['policy_step']}_0.ckpt")
        save({"path": path, "step": last_item["policy_step"], "state": {
            "agent": agent.state_dict(), "qf_optimizer": optimizers[1].state_dict(),
            "actor_optimizer": optimizers[0].state_dict(), "alpha_optimizer": optimizers[2].state_dict(),
            "iter_num": last_item["iter_num"], "batch_size": batch_size, "last_log": last_log,
            "last_checkpoint": last_checkpoint, "rng": trainer_gen.get_state()}}, True)
        summary["checkpoint"] = path
    manager.close()
    envs.close()
    if algo.get("run_test", True):
        summary["test_reward"], summary["test_steps"] = test(SACPlayer(agent), cfg, device)
    logger.close()
    summary.update(iterations=total_iters - start_iter + 1, policy_steps=policy_steps, log_dir=log_dir, streams=streams)
    return summary
