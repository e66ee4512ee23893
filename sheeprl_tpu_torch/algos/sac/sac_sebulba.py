"""SAC on the Sebulba pipeline over the device-resident replay ring
(counterpart of ``sheeprl_tpu/algos/sac/sac_sebulba.py``, one device).

- **Actors** (``algo.sebulba.num_actor_threads``), each on a CUDA stream of
  its own: uniform random actions until the rows produced by all actors
  pass ``learning_starts``, then the squashed-Gaussian sample of the newest
  actor snapshot (:func:`make_act_step`, its noise drawn per block from the
  actor's generator). Every ``algo.sebulba.rollout_block`` env steps an
  actor packs its transitions (the real final observation of a truncated
  env as its next one) into ONE blob
  (:meth:`~sheeprl_tpu_torch.replay.DeviceReplayBuffer.pack_rows`), uploads
  it from its own thread and queues it with the snapshot's version.
- **Learner** (the calling thread, the ring's only writer): per blob, one
  append (:meth:`~sheeprl_tpu_torch.replay.DeviceReplayBuffer.make_append_step`),
  then the ``Ratio`` governor's grant for each consumed env-step row, drained
  in ``grad_max``-step append-free train dispatches
  (``make_resident_train_step(..., append=False)``: with
  ``buffer.priority.enabled`` each gradient step draws through the
  ``sumtree_sample`` kernel and writes |TD| priorities back), publishing the
  actor every ``publish_every`` dispatches.

The ring is the storage tier: one over ``buffer.hbm_budget_gb`` raises.
Checkpoints hold JAX's keys and the ring (``rb``: storage, head, the
sum-tree, ``max_p`` and the ring's draw generator); ``resume_from=latest``
restores them and both generators (``rng``: the learner's, ``actor_rng``:
the base actor generator's). The sentinel, supervision, chaos points
(``sac_sebulba.actor{N}.step``) and the ``SAC_SEBULBA_STATS`` line of
``SHEEPRL_SEBULBA_DEBUG`` are ``ppo_sebulba``'s.
"""

from __future__ import annotations

import math
import os
import queue as _queue
import threading
import time
import warnings
from functools import partial
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.agent import LOG_STD_MAX, LOG_STD_MIN, build_agent, squashed_gaussian_sample
from sheeprl_tpu_torch.algos.sac.sac import (
    LOSS_NAMES,
    _ring_specs,
    make_optimizers,
    make_resident_train_step,
    restore_train_state,
)
from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import CheckpointManager, DivergenceSentinel, load_resume_state
from sheeprl_tpu_torch.fault.inject import arm_from_cfg, fault_point
from sheeprl_tpu_torch.parallel import partition
from sheeprl_tpu_torch.parallel.pipeline import (
    ParamServer,
    PipelineStats,
    RolloutQueue,
    StagedItem,
    fold_seed,
    side_stream,
    staleness_bound,
    stream_id,
    supervised_actor_pool,
)
from sheeprl_tpu_torch.replay import DeviceReplayBuffer, DeviceReplayState, resolve_device_resident
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, build_aggregator
from sheeprl_tpu_torch.utils.utils import Ratio

__all__ = ["main", "make_act_step"]


def make_act_step(agent) -> Callable:
    """The actor's program, forward and squashed-Gaussian sample only, on
    the published actor module: ``act(actor, obs, noise) -> actions`` (the
    agent's action bounds; ``noise`` standard normal ``(B, act_dim)``)."""
    scale, bias = agent.action_scale, agent.action_bias

    def act(actor, obs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        mean, log_std = actor(obs)
        std = torch.exp(torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX))
        return squashed_gaussian_sample(mean, std, scale, bias, noise)[0]

    return act


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The Sebulba loop on the ring; returns a summary (counters, losses,
    episodes, gradient steps, the pipeline's stats, the ring's metrics, the
    last checkpoint, the fault counters)."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    algo = cfg.algo
    if list(algo.cnn_keys.encoder):
        warnings.warn("SAC algorithm cannot allow to use images as observations, the CNN keys will be ignored")
        algo.cnn_keys["encoder"] = []
    if bool(cfg.buffer.get("sample_next_obs", False)):
        raise ValueError("buffer.sample_next_obs stores no explicit next observation; the device-resident ring "
                         "sac_sebulba streams into needs one: disable it or use the coupled host tier.")
    mlp_keys = list(algo.mlp_keys.encoder)
    if not mlp_keys:
        raise RuntimeError("You should specify at least one MLP key for the encoder: `mlp_keys.encoder=[state]`")
    seb = algo.get("sebulba") or {}
    num_actors = max(1, int(seb.get("num_actor_threads", 2)))
    queue_depth = max(1, int(seb.get("queue_depth", 2)))
    publish_every = max(1, int(seb.get("publish_every", 1)))
    block = max(1, int(seb.get("rollout_block", 8)))
    actor_device, learner_device = partition(device, seb.get("actor_devices", "auto"))
    num_envs, seed = int(cfg.env.num_envs), int(cfg.seed)
    dry_run = bool(cfg.get("dry_run", False))

    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    actor_envs = [make_vector_env(cfg, seed + a * num_envs) for a in range(num_actors)]
    cfg["spaces"] = dotdict(actor_envs[0].spaces)
    action_space = cfg.spaces.actions
    if not action_space.get("continuous", False):
        raise ValueError("Only continuous action space is supported for the SAC agent")
    for k in mlp_keys:
        if len(cfg.spaces.obs[k]["shape"]) > 1:
            raise ValueError("Only environments with vector-only observations are supported by the SAC agent. "
                             f"The observation with key '{k}' has shape {tuple(cfg.spaces.obs[k]['shape'])}.")
    logger.log_hyperparams(cfg)
    write_run_config(log_dir, plain(cfg))
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))
    obs_dim = int(sum(np.prod(cfg.spaces.obs[k]["shape"]) for k in mlp_keys))
    act_dim = int(np.prod(action_space["shape"]))
    low, high = np.asarray(action_space["low"], np.float32), np.asarray(action_space["high"], np.float32)

    learner_gen = torch.Generator(device=learner_device).manual_seed(seed)
    actor_base = torch.Generator().manual_seed(seed + 2)
    if state is not None and state.get("rng") is not None:
        learner_gen.set_state(state["rng"])
    if state is not None and state.get("actor_rng") is not None:
        actor_base.set_state(state["actor_rng"])
    actor_base_state = actor_base.get_state()
    agent, player = build_agent(cfg, obs_dim, action_space, learner_device,
                                state["agent"] if state is not None else None, learner_gen)
    optimizers = make_optimizers(cfg, agent)
    if state is not None:
        for opt, name in zip(optimizers, ("actor_optimizer", "qf_optimizer", "alpha_optimizer")):
            opt.load_state_dict(state[name])
        algo["per_rank_batch_size"] = int(state["batch_size"])
    batch_size = int(algo.per_rank_batch_size)

    policy_steps_per_iter = num_envs
    start_iter = int(state["iter_num"]) + 1 if state is not None else 1
    policy_step = int(state["iter_num"]) * num_envs if state is not None else 0
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
    log_level = int(cfg.metric.get("log_level", 1))
    log_every = int(cfg.metric.get("log_every", 5000))

    # the ring on the learner's device is the storage tier: no host twin to spill to
    buffer_size = int(cfg.buffer.size) // num_envs if not dry_run else block
    block = min(block, buffer_size)
    specs = _ring_specs(obs_dim, act_dim)
    per_cfg = cfg.buffer.priority
    prioritized = bool(per_cfg.enabled)
    use_device, reason = resolve_device_resident("auto", specs, buffer_size, num_envs,
                                                 float(cfg.buffer.hbm_budget_gb), prioritized)
    if not use_device:
        raise RuntimeError(f"sac_sebulba streams transitions straight into the device-resident replay ring, but "
                           f"{reason}. Lower buffer.size, raise buffer.hbm_budget_gb, or run the coupled tier (sac).")
    if log_level > 0:
        print(f"Replay: device ring on the learner's device ({reason})", flush=True)
    # one dispatch's steps: the steady grant of one consumed block
    grad_max = max(1, int(math.ceil(float(algo.replay_ratio) * num_envs * block)))
    drb = DeviceReplayBuffer(specs, buffer_size, num_envs, device=learner_device, prioritized=prioritized,
                             per_alpha=float(per_cfg.alpha), per_eps=float(per_cfg.eps), seed=seed + 29,
                             stage_rows=block)
    if state is not None and cfg.buffer.checkpoint and state.get("rb") is not None:
        drb.load_state_dict(DeviceReplayState.from_dict(state["rb"]))

    sentinel_cfg = (cfg.get("fault") or {}).get("sentinel") or {}
    guard = bool(sentinel_cfg.get("enabled", True))
    sentinel = DivergenceSentinel(sentinel_cfg)
    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)
    append_fn = drb.make_append_step()
    train_fn = make_resident_train_step(agent, optimizers, cfg, drb, guard=guard, append=False)
    beta0 = float(per_cfg.beta)

    stats = PipelineStats()
    rollout_q = RolloutQueue(queue_depth, stats=stats)
    param_server = ParamServer(agent.actor, publish_every=publish_every, stats=stats)
    param_server.publish()  # version 1: the initial or restored actor
    supervisor, handoff_deadline = supervised_actor_pool((cfg.get("fault") or {}).get("supervisor"),
                                                         "sac-sebulba-actors", stats)
    arm_from_cfg(cfg)
    bound = staleness_bound(queue_depth, num_actors, publish_every)
    # the first grant after the prefill replays its whole backlog: a one-off
    # staleness transient on random-action rows
    prefill_publishes = int(np.ceil(float(algo.replay_ratio) * int(algo.get("learning_starts", 0))
                                    / max(1, publish_every * grad_max)))
    # the prefill is global: actors act randomly until every actor's rows pass learning_starts
    produced_lock = threading.Lock()
    produced = {"iters": start_iter - 1}
    act_fn = make_act_step(agent)
    actor_streams: set = set()  # the streams the actors worked on (CUDA handles)

    def actor_fn(aid: int, ctx) -> None:
        envs = actor_envs[aid]  # re-homed with fresh envs before a restart
        chaos_point = f"sac_sebulba.actor{aid}.step"
        try:
            _, stream_ctx = side_stream(actor_device)
            with stream_ctx, torch.no_grad():
                actor_streams.add(stream_id(actor_device))
                actor_seed = fold_seed(actor_base_state, aid, ctx.generation)
                generator = torch.Generator(device=actor_device).manual_seed(actor_seed)
                action_rng = np.random.default_rng(actor_seed)
                obs = envs.reset(seed=seed + aid * num_envs)[0]
                rows: List[Dict[str, np.ndarray]] = []
                episodes: List = []
                while not ctx.cancelled:
                    version, actor = param_server.pull()
                    try:
                        noise = torch.randn((block, num_envs, act_dim), generator=generator, device=actor_device)
                        for t in range(block):
                            if ctx.cancelled:
                                return
                            ctx.beat()
                            fault_point(chaos_point)
                            with produced_lock:
                                produced["iters"] += 1
                                my_iter = produced["iters"]
                            flat_obs = prepare_obs(obs, mlp_keys, num_envs).numpy()
                            if my_iter <= learning_starts:
                                actions = action_rng.uniform(low, high, size=(num_envs, act_dim)).astype(np.float32)
                            else:
                                actions = act_fn(actor, torch.from_numpy(flat_obs).to(actor_device),
                                                 noise[t]).float().cpu().numpy()
                            next_obs, rewards, terminated, truncated, infos = envs.step(actions)
                            episodes += [(ep_rew, ep_len) for _, ep_rew, ep_len in infos.get("episodes", ())]
                            real_next_obs = {k: np.array(next_obs[k]) for k in mlp_keys}
                            for i, final in enumerate(infos.get("final_obs", ())):
                                if final is not None:  # the episode's last observation, not the reset one
                                    for k in mlp_keys:
                                        real_next_obs[k][i] = final[k]
                            rows.append({
                                "observations": flat_obs,
                                "next_observations": prepare_obs(real_next_obs, mlp_keys, num_envs).numpy(),
                                "actions": actions.reshape(num_envs, -1),
                                "rewards": np.asarray(rewards, dtype=np.float32).reshape(num_envs, -1),
                                "terminated": np.asarray(terminated, dtype=np.float32).reshape(num_envs, -1),
                            })
                            obs = next_obs
                    finally:
                        param_server.release(version)
                    if ctx.cancelled:  # never ship a block past the stop
                        return
                    # pack and upload on the actor's thread and stream: the learner sees a blob on the card
                    blob = drb.pack_rows(rows).to(learner_device, non_blocking=True)
                    item = {"blob": StagedItem.record({"blob": blob}), "count": len(rows), "version": version,
                            "episodes": episodes, "actor_id": aid}
                    rows, episodes = [], []
                    if not rollout_q.put(item, stop_event=ctx, beat=ctx.beat):
                        return
        finally:  # a crash reaches the supervisor (restart, degrade or abort)
            try:
                envs.close()
            except Exception:
                pass

    def rehome(aid: int, ctx) -> None:
        actor_envs[aid] = make_vector_env(cfg, seed + aid * num_envs)

    ema_modulus = int(algo.critic.target_network_frequency) // policy_steps_per_iter + 1
    ema_backlog: List[float] = []
    iter_num = start_iter - 1
    train_step = int(state.get("train_step", 0)) if state is not None else 0
    summary: Dict[str, Any] = {
        "start_iter": start_iter, "iterations": 0, "gradient_steps": 0, "train_calls": 0, "losses": [],
        "episodes": [], "append_s": [], "train_s": [], "checkpoint": None, "device": str(device),
        "test_reward": None, "test_steps": None, "prioritized": prioritized, "grad_max": grad_max,
        "prefill_policy_steps": prefill_steps * policy_steps_per_iter, "staleness": [],
    }
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

    def checkpoint_state(it: int) -> Dict[str, Any]:
        out = {"agent": agent.state_dict(), "qf_optimizer": optimizers[1].state_dict(),
               "actor_optimizer": optimizers[0].state_dict(), "alpha_optimizer": optimizers[2].state_dict(),
               "ratio": ratio.state_dict(), "iter_num": it, "batch_size": batch_size, "last_log": last_log,
               "last_checkpoint": last_checkpoint, "train_step": train_step, "rng": learner_gen.get_state(),
               "actor_rng": actor_base_state}
        if cfg.buffer.checkpoint:
            out["rb"] = drb.state_dict(live=True).to_dict()
        return out

    for a in range(num_actors):
        supervisor.spawn(name=f"sac-sebulba-actor-{a}", target=partial(actor_fn, a), on_restart=partial(rehome, a))
    pool_metrics: Dict[str, float] = {}
    try:
        while iter_num < total_iters:
            supervisor.check()
            try:
                item = rollout_q.get(timeout=0.5, deadline_s=handoff_deadline(), diagnose=supervisor.describe)
            except _queue.Empty:
                continue
            count = int(item["count"])
            staleness = param_server.version - item["version"]
            stats.observe_staleness(staleness)
            summary["staleness"].append(staleness)
            t0 = time.perf_counter()
            append_fn(item["blob"].wait()["blob"], count)  # the learner is the ring's only writer
            drb.note_append(count)
            summary["append_s"].append(time.perf_counter() - t0)
            stats.add("env_steps", count * num_envs)
            for _ in range(count):  # the coupled loop's grant accounting, one Ratio call per row
                iter_num += 1
                policy_step += policy_steps_per_iter
                summary["iterations"] += 1
                if iter_num >= learning_starts:
                    granted = ratio(policy_step - prefill_steps + policy_steps_per_iter)
                    ema_backlog.extend([1.0 if iter_num % ema_modulus == 0 else 0.0] * granted)
            t1 = time.perf_counter()
            while ema_backlog:  # drain the grant at the learner's own cadence
                chunk = min(grad_max, len(ema_backlog))
                beta = beta0 + (1.0 - beta0) * min(1.0, policy_step / max(1, int(algo.total_steps))) if prioritized else 0.0
                losses, skipped = train_fn(drb.make_ctl_job(ema_backlog[:chunk], beta))
                del ema_backlog[:chunk]
                pending.append(losses)
                summary["gradient_steps"] += chunk
                summary["train_calls"] += 1
                stats.add("grad_steps", chunk)
                train_step += 1
                param_server.maybe_publish(train_step)
                if guard and sentinel.observe(float(skipped)):
                    manager.wait()
                    sentinel.recover(ckpt_dir, lambda good: restore_train_state(agent, optimizers, learner_gen, good))
                    param_server.publish()  # actors never keep acting on diverged weights
            summary["train_s"].append(time.perf_counter() - t1)
            for ep_rew, ep_len in item["episodes"]:
                summary["episodes"].append((policy_step, item["actor_id"], ep_rew, ep_len))
                if log_level > 0:
                    if aggregator is not None:
                        aggregator.update("Rewards/rew_avg", ep_rew)
                        aggregator.update("Game/ep_len_avg", ep_len)
                    print(f"Rank-0: policy_step={policy_step}, reward_env_{item['actor_id']}={ep_rew}", flush=True)

            if policy_step - last_log >= log_every or iter_num >= total_iters:
                read_losses()
                if log_level > 0:
                    if aggregator is not None:
                        logger.log_dict(aggregator.compute(), policy_step)
                        aggregator.reset()
                    pipe = stats.snapshot()
                    pipe["Pipeline/queue_depth"] = rollout_q.qsize()
                    pipe.update(supervisor.metrics("Pipeline/", "actor"))
                    logger.log_dict(pipe, policy_step)
                    logger.log_dict(drb.metrics(), policy_step)
                    if guard and sentinel.total_skipped:
                        logger.log_dict({"Fault/skipped_updates": sentinel.total_skipped}, policy_step)
                    if policy_step > 0:
                        logger.log_dict({"Params/replay_ratio": summary["gradient_steps"] / policy_step}, policy_step)
                last_log = policy_step

            if (int(cfg.checkpoint.every) > 0 and policy_step - last_checkpoint >= int(cfg.checkpoint.every)) or (
                iter_num >= total_iters and cfg.checkpoint.get("save_last", False)
            ):
                last_checkpoint = policy_step
                path = os.path.join(ckpt_dir, f"ckpt_{policy_step}_0.ckpt")
                summary["checkpoint"] = str(manager.save(path, checkpoint_state(iter_num), step=policy_step,
                                                         config=plain(cfg)))
    finally:
        pool_metrics = supervisor.metrics("Pipeline/", "actor")
        supervisor.request_stop()
        rollout_q.drain()
        supervisor.join()
        rollout_q.drain()
        manager.close()
    read_losses()
    if os.environ.get("SHEEPRL_SEBULBA_DEBUG"):
        print("SAC_SEBULBA_STATS", {**stats.snapshot(), **pool_metrics, "staleness_max": stats.max_staleness_seen,
                                    "policy_steps": policy_step, "grad_steps": summary["gradient_steps"],
                                    "prefill_policy_steps": prefill_steps * policy_steps_per_iter}, flush=True)
    if stats.max_staleness_seen > 2 * bound + prefill_publishes:
        warnings.warn(f"Pipeline params staleness reached {stats.max_staleness_seen} publishes (steady-state bound "
                      f"{bound} + prefill transient {prefill_publishes}): actors cannot keep up with the learner; "
                      "raise algo.sebulba.num_actor_threads or publish_every.")
    if algo.get("run_test", True):
        summary["test_reward"], summary["test_steps"] = test(player, cfg, device)
    logger.close()
    summary.update(
        policy_steps=policy_step,
        log_dir=log_dir,
        replay=drb.metrics(),
        streams={"learner": stream_id(learner_device), "actors": sorted(actor_streams, key=str)},
        governor_offset=prefill_steps - policy_steps_per_iter,
        pipeline={**stats.snapshot(), **pool_metrics, "staleness_hist": dict(stats.staleness_hist),
                  "staleness_max": stats.max_staleness_seen, "staleness_bound": bound,
                  "prefill_publishes": prefill_publishes, "snapshots": param_server.snapshots},
        rollbacks=sentinel.rollbacks,
        checkpoint_timings=manager.timings,
        **{"Fault/skipped_updates": sentinel.total_skipped,
           "Fault/env_restarts": sum(e.env_restarts for e in actor_envs)},
    )
    return summary
