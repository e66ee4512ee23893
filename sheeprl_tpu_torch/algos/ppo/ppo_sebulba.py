"""PPO on the Sebulba pipeline (counterpart of
``sheeprl_tpu/algos/ppo/ppo_sebulba.py``, one device): supervised actor
threads step host envs and the learner trains on their finished rollouts.

- **Actors** (``algo.sebulba.num_actor_threads``), each on a CUDA stream of
  its own: every rollout pulls the newest parameter snapshot from the
  :class:`~sheeprl_tpu_torch.parallel.pipeline.ParamServer`, steps
  ``env.num_envs * env_groups`` envs ``rollout_steps`` times through
  :func:`make_act_step` (forward and sample only; the truncation bootstrap
  ``r += gamma * V(final obs)`` under the same snapshot), writes the rows
  straight into host slabs, one per group of ``env.num_envs`` columns,
  uploads each slab in one copy, recomputes the log-probs and values of the
  whole trajectory in one forward (:func:`make_traj_step`) and runs ``gae``
  (the CUDA kernel, one launch per group, on the actor's stream), then
  queues the flattened item with the snapshot's version.
- **Learner** (the calling thread): takes items from the bounded
  :class:`~sheeprl_tpu_torch.parallel.pipeline.RolloutQueue`, waits on each
  item's event, runs the PPO update of ``algos/ppo/ppo.py`` on it with one
  step of runahead (the previous update is waited for before the next is
  queued), and publishes a snapshot every ``publish_every`` updates.
  Staleness is observed against :func:`staleness_bound`.

Actor draws come from a generator per actor seeded from the base actor
generator's state, the actor's id and its generation (``fold_seed``, JAX's
``fold_in``); :func:`make_act_step` and :func:`make_traj_step` take their
draws as arguments. Checkpoints keep JAX's keys (``rng``: the learner's
generator state, ``actor_rng``: the base actor generator's); a resume
continues the learner's stream exactly. The divergence sentinel skips or
rolls back as in ``ppo`` and a rollback re-publishes. The actor pool runs
under the :class:`~sheeprl_tpu_torch.fault.supervisor.Supervisor`
(``fault.supervisor.*``; chaos points ``ppo_sebulba.actor{N}.step``);
shutdown stops, drains and joins under its budget.
``SHEEPRL_SEBULBA_DEBUG`` prints the ``SEBULBA_STATS`` line at the end.
"""

from __future__ import annotations

import copy
import os
import queue as _queue
import time
import warnings
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import build_agent, draw_actions, env_actions, forward_with_actions
from sheeprl_tpu_torch.algos.ppo.ppo import LOSS_NAMES, make_optimizer, make_train_step
from sheeprl_tpu_torch.algos.ppo.utils import action_spec, prepare_obs, test
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import CheckpointManager, DivergenceSentinel, NaNInjector, load_resume_state
from sheeprl_tpu_torch.fault.inject import arm_from_cfg, fault_point
from sheeprl_tpu_torch.ops.kernels import gae
from sheeprl_tpu_torch.parallel import partition
from sheeprl_tpu_torch.parallel.pipeline import (
    DoubleBufferedStager,
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
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, build_aggregator
from sheeprl_tpu_torch.utils.utils import polynomial_decay

__all__ = ["main", "make_act_step", "make_traj_step", "draw_act_noise", "finish_item"]

_TINY = float(np.finfo(np.float32).tiny)


def make_act_step(is_continuous: bool) -> Callable:
    """The actor's per-step program, forward and sample only:
    ``act(agent, obs, draws) -> env actions`` (each head's index ``(B,
    heads)``, or the continuous ``(B, dims)``). ``draws`` holds one
    ``(B, d)`` tensor of Gumbel-max uniforms per discrete head (JAX: the
    step key for one head, ``split(key, n_heads)`` for several), or one
    ``(B, dims)`` standard normal for the continuous head."""

    def act(agent, obs: Dict[str, torch.Tensor], draws: Sequence[torch.Tensor]) -> torch.Tensor:
        actor_outs, _ = agent(obs)
        if is_continuous:
            acts, _ = draw_actions(actor_outs, True, noise=draws[0])
        else:
            acts, _ = draw_actions(actor_outs, False, uniforms=list(draws))
        return env_actions(acts, is_continuous)

    return act


def make_traj_step(cnn_keys: Sequence[str], mlp_keys: Sequence[str], is_continuous: bool, n_heads: int,
                   head_split: Sequence[int]) -> Callable:
    """The whole trajectory's log-probs and values under one snapshot:
    ``traj(agent, obs_flat, actions_flat) -> (logprob, values)``, each
    ``(T*N, 1)``, with the update's normalization (pixels ``x / 255 - 0.5``)
    and the concatenated one-hots split at ``head_split`` (JAX's
    ``jnp.split`` indices)."""
    cnn_keys, mlp_keys = list(cnn_keys), list(mlp_keys)

    def traj(agent, obs_flat: Dict[str, torch.Tensor], actions_flat: torch.Tensor):
        obs = {k: obs_flat[k].to(torch.float32) / 255.0 - 0.5 for k in cnn_keys}
        obs.update({k: obs_flat[k].to(torch.float32) for k in mlp_keys})
        if is_continuous or n_heads == 1:
            actions = [actions_flat]
        else:
            actions = list(torch.tensor_split(actions_flat, list(head_split), dim=-1))
        logprob, _, values = forward_with_actions(agent, obs, actions)
        return logprob, values

    return traj


def draw_act_noise(generator: Optional[torch.Generator], steps: int, batch: int, actions_dim: Sequence[int],
                   is_continuous: bool, device: "torch.device | str") -> List[torch.Tensor]:
    """One rollout's draws for :func:`make_act_step`, ``(steps, batch, d)``
    per head: uniforms in [tiny, 1) (``jax.random.categorical``'s interval)
    or standard normals."""
    if is_continuous:
        return [torch.randn((steps, batch, int(sum(actions_dim))), generator=generator, device=device)]
    return [torch.rand((steps, batch, int(d)), generator=generator, device=device).clamp_(min=_TINY)
            for d in actions_dim]


def finish_item(agent, traj_fn: Callable, slab: Dict[str, torch.Tensor], next_values: torch.Tensor,
                obs_keys: Sequence[str], gamma: float, gae_lambda: float) -> Dict[str, torch.Tensor]:
    """A finished rollout slab ``(T, N, ...)`` on the device -> the
    flattened learner item ``(T*N, ...)``: the trajectory's log-probs and
    values under the acting snapshot ``agent`` (:func:`make_traj_step`),
    then ``gae`` (one launch of the CUDA kernel on a CUDA slab) with the
    bootstrap ``next_values`` ``(N, 1)``; ``rewards`` already hold the
    truncation bootstrap."""
    T, N = slab["rewards"].shape[:2]
    flat = {k: v.reshape(T * N, *v.shape[2:]) for k, v in slab.items()}
    logprobs, values = traj_fn(agent, {k: flat[k] for k in obs_keys}, flat["actions"])
    returns, advantages = gae(slab["rewards"], values.reshape(T, N, 1), slab["dones"], next_values, gamma,
                              gae_lambda)
    flat["logprobs"], flat["values"] = logprobs, values
    flat["returns"] = returns.reshape(T * N, 1)
    flat["advantages"] = advantages.reshape(T * N, 1)
    return flat


def _actor_envs(cfg: Any, seed: int, num_envs: int):
    env_cfg = copy.deepcopy(cfg)
    env_cfg.env["num_envs"] = num_envs
    return make_vector_env(env_cfg, seed)


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The Sebulba loop; returns a summary of the run (counters, losses,
    episodes, the pipeline's stats and staleness, host seconds per update,
    the last checkpoint, the fault counters)."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    algo = cfg.algo
    cnn_keys, mlp_keys = list(algo.cnn_keys.encoder), list(algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    if not obs_keys:
        raise RuntimeError("set at least one of algo.cnn_keys.encoder and algo.mlp_keys.encoder")
    seb = algo.get("sebulba") or {}
    num_actors = max(1, int(seb.get("num_actor_threads", 2)))
    queue_depth = max(1, int(seb.get("queue_depth", 2)))
    publish_every = max(1, int(seb.get("publish_every", 1)))
    env_groups = max(1, int(seb.get("env_groups", 1)))
    actor_device, learner_device = partition(device, seb.get("actor_devices", "auto"))
    num_envs = int(cfg.env.num_envs)
    batch_envs = num_envs * env_groups
    seed = int(cfg.seed)
    T = int(algo.rollout_steps)

    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    # one vector batch per actor; sub-env seeds disjoint across actors
    actor_envs = [_actor_envs(cfg, seed + a * batch_envs, batch_envs) for a in range(num_actors)]
    cfg["spaces"] = dotdict(actor_envs[0].spaces)
    actions_dim, is_continuous = action_spec(cfg.spaces)
    logger.log_hyperparams(cfg)
    write_run_config(log_dir, plain(cfg))
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))

    learner_gen = torch.Generator(device=learner_device).manual_seed(seed + 1)
    actor_base = torch.Generator().manual_seed(seed + 2)
    if state is not None and state.get("rng") is not None:
        learner_gen.set_state(state["rng"])  # continue the learner's stream exactly
    if state is not None and state.get("actor_rng") is not None:
        actor_base.set_state(state["actor_rng"])
    actor_base_state = actor_base.get_state()
    agent, player = build_agent(cfg, actions_dim, is_continuous, cfg.spaces.obs, learner_device,
                                state["agent"] if state is not None else None, learner_gen)
    optimizer = make_optimizer(cfg, agent)
    if state is not None:
        optimizer.load_state_dict(state["optimizer"])
        algo["per_rank_batch_size"] = int(state["batch_size"])

    policy_steps_per_iter = num_envs * T
    start_iter = int(state["iter_num"]) + 1 if state is not None else 1
    policy_step = int(state["iter_num"]) * policy_steps_per_iter if state is not None else 0
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    total_iters = int(algo.total_steps) // policy_steps_per_iter if not bool(cfg.get("dry_run", False)) else 1
    log_level = int(cfg.metric.get("log_level", 1))
    log_every = int(cfg.metric.get("log_every", 5000))
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

    stats = PipelineStats()
    rollout_q = RolloutQueue(queue_depth, stats=stats)
    param_server = ParamServer(agent, publish_every=publish_every, stats=stats)
    param_server.publish()  # version 1: the initial or restored weights
    supervisor, handoff_deadline = supervised_actor_pool((cfg.get("fault") or {}).get("supervisor"),
                                                         "ppo-sebulba-actors", stats)
    arm_from_cfg(cfg)
    # each actor's rollout slices into env_groups items
    bound = staleness_bound(queue_depth, num_actors * env_groups, publish_every)

    n_heads = 1 if is_continuous else len(actions_dim)
    act_width = int(sum(actions_dim))
    head_split = np.cumsum(np.asarray(actions_dim[:-1], dtype=np.int64)).tolist()
    act_fn = make_act_step(is_continuous)
    traj_fn = make_traj_step(cnn_keys, mlp_keys, is_continuous, n_heads, head_split)
    eye_rows = [np.eye(int(d), dtype=np.float32) for d in actions_dim] if not is_continuous else None
    obs_specs = {k: (tuple(cfg.spaces.obs[k]["shape"]), np.dtype(cfg.spaces.obs[k].get("dtype", "float32")))
                 for k in obs_keys}
    template: Dict[str, Tuple[tuple, Any]] = {
        **{k: ((T, num_envs, *shape), dtype) for k, (shape, dtype) in obs_specs.items()},
        "actions": ((T, num_envs, act_width), np.float32),
        "rewards": ((T, num_envs, 1), np.float32),
        "dones": ((T, num_envs, 1), np.uint8),
    }
    groups = [(g * num_envs, (g + 1) * num_envs) for g in range(env_groups)]
    actor_streams: set = set()  # the streams the actors worked on (CUDA handles)

    def rollout(aid: int, ctx, envs, stager, generator, next_obs, local_iter: int):
        """One rollout under one snapshot; False when cancelled."""
        version, snap = param_server.pull()
        try:
            slabs = [stager.acquire(template) for _ in groups]
            ep_infos: List[List[Tuple[float, float]]] = [[] for _ in groups]
            noise = draw_act_noise(generator, T, batch_envs, actions_dim, is_continuous, actor_device)
            for t in range(T):
                if ctx.cancelled:  # a superseded generation exits mid-rollout, shipping nothing
                    return False
                ctx.beat()
                fault_point(f"ppo_sebulba.actor{aid}.step")
                for g, (lo, hi) in enumerate(groups):
                    for k in obs_keys:
                        slabs[g][k][t] = next_obs[k][lo:hi]
                actions = act_fn(snap, prepare_obs(next_obs, cnn_keys, batch_envs, actor_device),
                                 [n[t] for n in noise])
                real = actions.float().cpu().numpy() if is_continuous else actions.cpu().numpy()
                for g, (lo, hi) in enumerate(groups):
                    if is_continuous:
                        slabs[g]["actions"][t] = real[lo:hi]
                    else:
                        off = 0
                        for h, eye in enumerate(eye_rows):
                            slabs[g]["actions"][t, :, off:off + eye.shape[0]] = eye[real[lo:hi, h]]
                            off += eye.shape[0]
                obs, rewards, terminated, truncated, info = envs.step(real)
                rewards = np.asarray(rewards, dtype=np.float32)
                truncated_envs = np.nonzero(truncated)[0]
                if len(truncated_envs) > 0 and "final_obs" in info:
                    final = {k: np.stack([info["final_obs"][i][k] for i in truncated_envs]) for k in obs_keys}
                    vals = snap(prepare_obs(final, cnn_keys, len(truncated_envs), actor_device))[1]
                    rewards[truncated_envs] += gamma * vals.float().cpu().numpy().reshape(rewards[truncated_envs].shape)
                dones = np.logical_or(terminated, truncated).reshape(batch_envs, 1)
                for g, (lo, hi) in enumerate(groups):
                    slabs[g]["dones"][t] = dones[lo:hi]
                    slabs[g]["rewards"][t] = rewards.reshape(batch_envs, 1)[lo:hi]
                next_obs.update({k: np.asarray(obs[k]) for k in obs_keys})
                for i, ep_rew, ep_len in info.get("episodes", ()):
                    ep_infos[i // num_envs].append((float(ep_rew), float(ep_len)))
            if ctx.cancelled:  # never ship a rollout past the stop
                return False
            next_values = snap(prepare_obs(next_obs, cnn_keys, batch_envs, actor_device))[1]
            for g, (lo, hi) in enumerate(groups):
                on_device = stager.upload(slabs[g])  # one copy on the actor's stream
                flat = finish_item(snap, traj_fn, on_device, next_values[lo:hi], obs_keys, gamma, gae_lambda)
                if nan_injector:
                    nan_injector.poison(flat, "advantages", local_iter)
                item = {"actor_id": aid, "data": StagedItem.record(flat), "ep_infos": ep_infos[g], "version": version}
                if not rollout_q.put(item, stop_event=ctx, beat=ctx.beat):
                    return False
            return True
        finally:
            param_server.release(version)

    def actor_fn(aid: int, ctx) -> None:
        envs = actor_envs[aid]  # re-homed with fresh envs before a restart
        try:
            _, stream_ctx = side_stream(actor_device)
            with stream_ctx, torch.no_grad():
                actor_streams.add(stream_id(actor_device))
                # the ring covers every slab live at once: queued items, the
                # learner's one in training and its next, this rollout's groups
                stager = DoubleBufferedStager(actor_device, slots=queue_depth + env_groups + 3)
                generator = torch.Generator(device=actor_device).manual_seed(
                    fold_seed(actor_base_state, aid, ctx.generation))
                reset_obs = envs.reset(seed=seed + aid * batch_envs)[0]
                next_obs = {k: np.asarray(reset_obs[k]) for k in obs_keys}
                local_iter = 0
                while not ctx.cancelled:
                    local_iter += 1
                    if not rollout(aid, ctx, envs, stager, generator, next_obs, local_iter):
                        return
        finally:  # a crash reaches the supervisor (restart, degrade or abort)
            try:
                envs.close()
            except Exception:
                pass

    def rehome(aid: int, ctx) -> None:
        actor_envs[aid] = _actor_envs(cfg, seed + aid * batch_envs, batch_envs)

    lr = lr0 = float(algo.optimizer.lr)
    clip_coef0, ent_coef0 = float(algo.clip_coef), float(algo.ent_coef)
    clip_coef, ent_coef = clip_coef0, ent_coef0
    train_step = int(state.get("train_step", 0)) if state is not None else 0
    iter_num = start_iter - 1
    summary: Dict[str, Any] = {
        "start_iter": start_iter, "iterations": 0, "losses": [], "episodes": [], "update_s": [], "wait_s": [],
        "checkpoint": None, "device": str(device), "test_reward": None, "test_steps": None, "skipped": [],
        "staleness": [], "versions": [],
    }
    pending: List[torch.Tensor] = []  # losses still on the device
    last_event: Optional[torch.cuda.Event] = None

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
        return {"agent": agent.state_dict(), "optimizer": optimizer.state_dict(), "scheduler": None, "iter_num": it,
                "batch_size": int(algo.per_rank_batch_size), "last_log": last_log,
                "last_checkpoint": last_checkpoint, "train_step": train_step, "rng": learner_gen.get_state(),
                "actor_rng": actor_base_state}

    for a in range(num_actors):
        supervisor.spawn(name=f"sebulba-actor-{a}", target=partial(actor_fn, a), on_restart=partial(rehome, a))
    pool_metrics: Dict[str, float] = {}
    in_flight = 0
    try:
        while iter_num < total_iters:
            supervisor.check()  # restart, degrade or abort: never a silent spin
            t0 = time.perf_counter()
            try:
                item = rollout_q.get(timeout=0.5, deadline_s=handoff_deadline(), diagnose=supervisor.describe)
            except _queue.Empty:
                continue
            t1 = time.perf_counter()
            iter_num += 1
            policy_step += policy_steps_per_iter
            staleness = param_server.version - item["version"]
            stats.observe_staleness(staleness)
            data = item["data"].wait()  # the learner's stream waits on the actor's
            if last_event is not None:
                last_event.synchronize()  # one step of runahead, never more
            losses, skipped = train_fn(data, clip_coef, ent_coef, generator=learner_gen)
            train_step += 1
            param_server.maybe_publish(train_step)
            if learner_device.type == "cuda":
                last_event = torch.cuda.Event()
                last_event.record()
            pending.append(losses)
            if guard:
                skipped = float(skipped)  # a read per update, as JAX's sentinel does
                summary["skipped"].append(skipped)
                if sentinel.observe(skipped):
                    def rollback(good: Dict[str, Any]) -> None:
                        agent.load_state_dict(good["agent"])
                        optimizer.load_state_dict(good["optimizer"])
                        if good.get("rng") is not None:
                            learner_gen.set_state(good["rng"])

                    manager.wait()
                    sentinel.recover(ckpt_dir, rollback)
                    param_server.publish()  # actors never keep acting on diverged weights
            for ep_rew, ep_len in item["ep_infos"]:
                summary["episodes"].append((policy_step, item["actor_id"], ep_rew, ep_len))
                if log_level > 0:
                    if aggregator is not None:
                        aggregator.update("Rewards/rew_avg", ep_rew)
                        aggregator.update("Game/ep_len_avg", ep_len)
                    print(f"Rank-0: policy_step={policy_step}, reward_env_{item['actor_id']}={ep_rew}", flush=True)
            summary["staleness"].append(staleness)
            summary["versions"].append(item["version"])
            summary["wait_s"].append(t1 - t0)
            summary["update_s"].append(time.perf_counter() - t1)
            summary["iterations"] += 1

            if policy_step - last_log >= log_every or iter_num == total_iters:
                read_losses()
                if log_level > 0:
                    if aggregator is not None:
                        logger.log_dict(aggregator.compute(), policy_step)
                        aggregator.reset()
                    pipe = stats.snapshot()
                    pipe["Pipeline/queue_depth"] = rollout_q.qsize()
                    pipe.update(supervisor.metrics("Pipeline/", "actor"))
                    logger.log_dict(pipe, policy_step)
                    logger.log_dict({"Info/learning_rate": lr, "Info/clip_coef": clip_coef,
                                     "Info/ent_coef": ent_coef}, policy_step)
                    if guard and sentinel.total_skipped:
                        logger.log_dict({"Fault/skipped_updates": sentinel.total_skipped}, policy_step)
                last_log = policy_step

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
                path = os.path.join(ckpt_dir, f"ckpt_{policy_step}_0.ckpt")
                summary["checkpoint"] = str(manager.save(path, checkpoint_state(iter_num), step=policy_step,
                                                         config=plain(cfg)))
    finally:
        # stop, drain, join under the supervisor's budget; a hung actor is
        # named and abandoned
        pool_metrics = supervisor.metrics("Pipeline/", "actor")
        supervisor.request_stop()
        drained = len(rollout_q.drain())
        supervisor.join()
        drained += len(rollout_q.drain())  # items put while the actors stopped
        # every item an actor finished: queued and drained, or turned away by the stop
        in_flight = drained + stats.rollouts_dropped
        manager.close()
    read_losses()
    if os.environ.get("SHEEPRL_SEBULBA_DEBUG"):
        print("SEBULBA_STATS", {**stats.snapshot(), **pool_metrics, "staleness_max": stats.max_staleness_seen,
                                "staleness_hist": dict(stats.staleness_hist)}, flush=True)
    if stats.max_staleness_seen > 2 * bound:
        warnings.warn(f"Pipeline params staleness reached {stats.max_staleness_seen} publishes (steady-state bound "
                      f"{bound}): actors cannot keep up with the learner; raise algo.sebulba.num_actor_threads, "
                      "env_groups or publish_every.")
    if algo.get("run_test", True):
        summary["test_reward"], summary["test_steps"] = test(player, cfg, device)
    logger.close()
    summary.update(
        policy_steps=policy_step,
        log_dir=log_dir,
        pipeline={**stats.snapshot(), **pool_metrics, "staleness_hist": dict(stats.staleness_hist),
                  "staleness_max": stats.max_staleness_seen, "staleness_bound": bound,
                  "snapshots": param_server.snapshots},
        items_in_flight_at_shutdown=in_flight,
        streams={"learner": stream_id(learner_device), "actors": sorted(actor_streams, key=str)},
        rollbacks=sentinel.rollbacks,
        checkpoint_timings=manager.timings,
        **{"Fault/skipped_updates": sentinel.total_skipped,
           "Fault/env_restarts": sum(e.env_restarts for e in actor_envs)},
    )
    return summary
