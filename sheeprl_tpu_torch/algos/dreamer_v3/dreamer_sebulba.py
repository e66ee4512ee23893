"""DreamerV3 on the Sebulba pipeline over the async per-env-head device
sequence ring (counterpart of ``sheeprl_tpu/algos/dreamer_v3/dreamer_sebulba.py``,
one device).

- **Actors** (``algo.sebulba.num_actor_threads``), each on a CUDA stream of
  its own, each stepping a vector env of ``env.num_envs`` envs: uniform
  random actions until the rows produced by all actors pass
  ``learning_starts``, then the RSSM player step of the newest snapshot
  whose copy has run (``ParamServer.pull(prefer_ready=True)``: a train
  dispatch takes seconds on the learner's stream, and the newest snapshot's
  copy waits behind it). :func:`make_act_step` first merges the initial
  states, derived from the live snapshot, and a zero action into the rows
  flagged ``is_first``, then encodes, advances the recurrent state through
  ``gru_gates_ln`` and samples the posterior and the actions with draws
  taken per block from the actor's generator. The recurrent, posterior and
  action carries stay on the actor's stream, float32. Every
  ``algo.sebulba.rollout_block`` env steps an actor has written its regular
  rows and ragged reset rows (the terminal observation of each done env)
  straight into a pinned host slab (:class:`~sheeprl_tpu_torch.replay.SeqBlobWriter`);
  it uploads the slab in one copy and queues the blob with its env columns'
  offset, their row counts and the snapshot's version.
- **Learner** (the calling thread, the ring's only writer): per blob, one
  ragged multi-head scatter at the actor's env columns
  (:meth:`~sheeprl_tpu_torch.replay.AsyncSequenceRing.append`, one
  ``ragged_ring_scatter_keys`` launch), then the ``Ratio`` governor's grant
  for each consumed row, drained in ``grad_max``-step append-free train
  dispatches while every env column holds a window
  (``make_train_step(..., ring={"decoupled": True, ...})``: windows drawn on
  the card against the live per-env heads, each RSSM step through
  ``gru_gates_ln``, the reward and critic heads through the two-hot
  kernels), publishing :func:`player_subset` after every ``publish_every``
  dispatches.

The ring is the storage tier: one over ``buffer.hbm_budget_gb``, or too
small for one worst-case block, raises by name. Each dispatch is guarded
(``fault.sentinel``): a non-finite step is undone, and the sentinel's
rollback re-publishes. Checkpoints hold the modules, optimizers,
``Moments``, ``Ratio``, both host generators (``rng``, ``actor_rng``) and
with ``buffer.checkpoint`` the ring (``rb``: storage, device heads, the
ring's generator); ``checkpoint.resume_from=latest`` restores them and
shifts ``learning_starts`` and the prefill by the resumed iteration, as JAX
does. Supervision, chaos points (``dreamer_sebulba.actor{N}.step``) and the
``DREAMER_SEBULBA_STATS`` line of ``SHEEPRL_SEBULBA_DEBUG`` are
``sac_sebulba``'s.
"""

from __future__ import annotations

import math
import os
import queue as _queue
import threading
import time
import warnings
from functools import partial
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    WorldModel,
    action_dims,
    actor_sample,
    build_training_agent,
    sample_stochastic,
)
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES, _uniform, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import DreamerV3Agent, posterior_step
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments, prepare_obs, test
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.data.ring import pack_burst_blob
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
from sheeprl_tpu_torch.replay import (
    AsyncSequenceRing,
    DeviceReplayState,
    SeqBlobWriter,
    resolve_device_resident,
)
from sheeprl_tpu_torch.utils.burst import dreamer_ring_keys
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, build_aggregator
from sheeprl_tpu_torch.utils.utils import Ratio

__all__ = ["main", "make_act_step", "player_subset", "draw_act_noise"]


def player_subset(world_model: WorldModel, actor: torch.nn.Module) -> DreamerV3Agent:
    """What the actors' player needs (what the ParamServer publishes): the
    encoder, the recurrent, representation and transition models, the
    learnable initial recurrent state and the actor, sharing the learner's
    tensors. Decoders, the reward and continue heads, the critics and the
    optimizers' state never reach an actor."""
    sub = WorldModel(
        world_model.encoder,
        world_model.recurrent_model,
        world_model.representation_model,
        world_model.transition_model,
        int(world_model.initial_recurrent_state.shape[0]),
        discrete=world_model.discrete,
        unimix=world_model.unimix,
        decoupled=world_model.decoupled,
    )
    sub.initial_recurrent_state = world_model.initial_recurrent_state
    return DreamerV3Agent(sub, actor)


def draw_act_noise(generator: torch.Generator, steps: int, n: int, stoch: int, actions_dim, continuous: bool,
                   device) -> Dict[str, Any]:
    """A block's draws for :func:`make_act_step`: ``posterior`` ``(steps, n,
    S*D)`` uniforms in ``[tiny, 1)``, and ``actions``, one ``(steps, n, A_i)``
    tensor of uniforms per discrete head, or one ``(steps, n, sum(A))`` tensor
    of standard normals for a continuous actor."""
    noise = {"posterior": _uniform((steps, n, stoch), generator, device)}
    if continuous:
        noise["actions"] = [torch.randn((steps, n, int(sum(actions_dim))), generator=generator, device=device)]
    else:
        noise["actions"] = [_uniform((steps, n, int(d)), generator, device) for d in actions_dim]
    return noise


def make_act_step(world_model: WorldModel, actor: torch.nn.Module) -> Callable:
    """The actors' per-step program: ``act(agent, obs, actions, rec, stoch,
    is_first, noise) -> (actions per head, their concatenation, rec',
    stoch')`` on the published :func:`player_subset` ``agent``. Rows flagged
    ``is_first`` (``(n, 1)``) first take the initial states of the live
    snapshot (``tanh`` of its initial recurrent state and the transition's
    mode there) and a zero action, so a reset of any subset of envs is the
    same program as no reset; then the encoder, the recurrent step
    (``gru_gates_ln`` on the card), the posterior sample and the actor's
    sample with ``noise`` (one step of :func:`draw_act_noise`). The carries
    come back float32 whatever the compute dtype (a one-hot or an action
    widens exactly), as a player's carry stays under ``bf16-mixed``.
    ``world_model`` and ``actor`` give the shapes only."""
    discrete = world_model.discrete

    def act(agent: DreamerV3Agent, obs: Dict[str, torch.Tensor], actions: torch.Tensor, rec: torch.Tensor,
            stoch: torch.Tensor, is_first: torch.Tensor, noise: Dict[str, Any]):
        wm = agent.world_model
        rec0, stoch0 = wm.get_initial_states(actions.shape[0])
        first = is_first > 0
        actions = torch.where(first, torch.zeros_like(actions), actions)
        rec = torch.where(first, rec0.to(rec.dtype), rec)
        stoch = torch.where(first, stoch0.to(stoch.dtype), stoch)
        rec, logits = posterior_step(agent, obs, actions, rec, stoch)
        stoch = sample_stochastic(logits, discrete, noise["posterior"])
        acts, _ = actor_sample(agent.actor, torch.cat([stoch, rec], dim=-1), noise["actions"])
        return acts, torch.cat(acts, dim=-1).float(), rec.float(), stoch.float()

    return act


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The Sebulba loop on the async ring; returns a summary (counters, each
    dispatch's mean metrics, episodes, gradient steps, act steps, the
    pipeline's stats, the ring's metrics, the last checkpoint, the fault
    counters)."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    algo = cfg.algo
    # these arguments cannot be changed (the coupled loop's constraints)
    cfg.env["frame_stack"] = -1
    if 2 ** int(np.log2(cfg.env.screen_size)) != cfg.env.screen_size:
        raise ValueError(f"The screen size must be a power of 2, got: {cfg.env.screen_size}")
    cnn_keys, mlp_keys = list(algo.cnn_keys.encoder), list(algo.mlp_keys.encoder)
    cnn_dec, mlp_dec = list(algo.cnn_keys.get("decoder", cnn_keys)), list(algo.mlp_keys.get("decoder", mlp_keys))
    if not set(cnn_keys) & set(cnn_dec) and not set(mlp_keys) & set(mlp_dec):
        raise RuntimeError("The CNN keys or the MLP keys of the encoder and decoder must not be disjointed")
    if set(cnn_dec) - set(cnn_keys):
        raise RuntimeError("The CNN keys of the decoder must be contained in the encoder ones")
    if set(mlp_dec) - set(mlp_keys):
        raise RuntimeError("The MLP keys of the decoder must be contained in the encoder ones")
    obs_keys = cnn_keys + mlp_keys
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
    cfg["spaces"] = dotdict(actor_envs[0].spaces)  # what serve and evaluation read off the run's config.json
    is_continuous, actions_dim = action_dims(cfg.spaces)
    if is_continuous:
        low = np.asarray(cfg.spaces.actions.low, np.float32)
        high = np.asarray(cfg.spaces.actions.high, np.float32)
    logger.log_hyperparams(cfg)
    write_run_config(log_dir, plain(cfg))
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))

    world_model, actor, critic, target_critic = build_training_agent(cfg, learner_device, state)
    optimizers = make_optimizers(cfg, world_model, actor, critic)
    moments_state = init_moments(learner_device)
    if state is not None:
        for name, opt in optimizers.items():
            opt.load_state_dict(state["optimizers"][name])
        moments_state = {k: v.to(learner_device) for k, v in state["moments"].items()}

    # one consumed regular row is one iteration of num_envs policy steps; the
    # ring spans num_actors * num_envs env columns
    ring_envs = num_actors * num_envs
    policy_steps_per_iter = num_envs
    start_iter = int(state["iter_num"]) + 1 if state is not None else 1
    policy_step = int(state["iter_num"]) * num_envs if state is not None else 0
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    total_iters = int(algo.total_steps) // policy_steps_per_iter if not dry_run else 1
    learning_starts = int(algo.get("learning_starts", 0)) // policy_steps_per_iter if not dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    if state is not None:
        algo["per_rank_batch_size"] = int(state["batch_size"])
        learning_starts += start_iter
        prefill_steps += start_iter
    ratio = Ratio(float(algo.replay_ratio), pretrain_steps=int(algo.per_rank_pretrain_steps))
    if state is not None:
        ratio.load_state_dict(state["ratio"])
    batch_size = int(algo.per_rank_batch_size)
    seq_len = int(algo.per_rank_sequence_length)
    log_level = int(cfg.metric.get("log_level", 1))
    log_every = int(cfg.metric.get("log_every", 5000))

    # -- the async sequence ring on the learner's device, the only storage tier
    ring_keys = dreamer_ring_keys(cfg.spaces.obs, cnn_keys, mlp_keys, actions_dim, with_is_first=True)
    buffer_size = max(int(cfg.buffer.size) // ring_envs, seq_len) if not dry_run else max(2 * block, seq_len)
    # a block stages at most `block` regular rows and `block` ragged reset
    # rows: a ring that cannot hold one worst-case block is a config error
    stage_rows = 2 * block
    if stage_rows > buffer_size:
        raise ValueError(
            f"the sequence ring holds {buffer_size} rows per env column (buffer.size={cfg.buffer.size} "
            f"over {ring_envs} env columns) but one rollout block can stage up to {stage_rows} rows "
            f"(2 x algo.sebulba.rollout_block={block}); raise buffer.size or lower rollout_block"
        )
    use_device, resident_reason = resolve_device_resident(
        "auto", ring_keys, buffer_size, ring_envs, float(cfg.buffer.get("hbm_budget_gb", 4.0)),
        sequence={"seq_len": seq_len, "batch_size": batch_size},
    )
    if not use_device:  # no host tier to spill to
        raise RuntimeError(
            f"dreamer_sebulba streams sequence heads straight into the device-resident ring, but "
            f"{resident_reason.split(';')[0]}. "
            "Lower buffer.size, raise buffer.hbm_budget_gb, or run the coupled `algo=dreamer_v3`."
        )
    if log_level > 0:
        print(f"Replay: async device sequence ring, {ring_envs} env columns ({resident_reason})", flush=True)
    ring = AsyncSequenceRing(ring_keys, buffer_size, ring_envs, num_envs, seq_len, stage_rows,
                             device=learner_device, seed=seed + 31)
    if state is not None and cfg.buffer.get("checkpoint", False) and state.get("rb") is not None:
        saved = state["rb"]
        if not (isinstance(saved, dict) and saved.get("kind") == "sequence"):
            raise RuntimeError(
                f"dreamer_sebulba can only resume its own sequence-ring checkpoints, got {type(saved)}"
            )
        ring.load_state_dict(DeviceReplayState.from_dict(saved))

    sentinel_cfg = (cfg.get("fault") or {}).get("sentinel") or {}
    guard = bool(sentinel_cfg.get("enabled", True))
    sentinel = DivergenceSentinel(sentinel_cfg)
    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)
    # one dispatch's steps: the steady grant of one consumed block (bigger
    # backlogs drain over several dispatches)
    grad_max = max(1, int(math.ceil(float(algo.replay_ratio) * num_envs * block)))
    train_fn, ctl_layout = make_train_step(
        world_model, actor, critic, target_critic, optimizers, cfg, guard=guard,
        ring={"capacity": buffer_size, "n_envs": ring_envs, "grad_chunk": grad_max, "seq_len": seq_len,
              "batch_size": batch_size, "decoupled": True},
    )

    # host generators: rng is the family's checkpoint slot (the ring's
    # generator owns the train draws); actor_rng seeds the actors' streams
    rng = torch.Generator().manual_seed(seed)
    actor_base = torch.Generator().manual_seed(seed + 2)
    if state is not None and state.get("rng") is not None:
        rng.set_state(state["rng"])
    if state is not None and state.get("actor_rng") is not None:
        actor_base.set_state(state["actor_rng"])
    actor_base_state = actor_base.get_state()

    stats = PipelineStats()
    rollout_q = RolloutQueue(queue_depth, stats=stats)
    param_server = ParamServer(player_subset(world_model, actor), publish_every=publish_every, stats=stats)
    param_server.publish()  # version 1: the initial or restored weights
    supervisor, handoff_deadline = supervised_actor_pool((cfg.get("fault") or {}).get("supervisor"),
                                                         "dreamer-sebulba-actors", stats)
    arm_from_cfg(cfg)
    bound = staleness_bound(queue_depth, num_actors, publish_every)
    prefill_publishes = int(np.ceil(float(algo.replay_ratio) * int(algo.get("learning_starts", 0))
                                    / max(1, publish_every * grad_max)))
    # the prefill is global: actors act randomly until the rows produced by
    # every actor pass learning_starts; act_steps counts the player steps
    produced_lock = threading.Lock()
    produced = {"iters": start_iter - 1, "act_steps": 0}
    act_fn = make_act_step(world_model, actor)
    rec_size = int(algo.world_model.recurrent_model.recurrent_state_size)
    stoch_flat = int(algo.world_model.stochastic_size) * int(algo.world_model.discrete_size)
    act_dim_sum = int(np.sum(actions_dim))
    clip_rewards = bool(cfg.env.get("clip_rewards", False))
    actor_streams: set = set()

    def actor_fn(aid: int, ctx) -> None:
        envs = actor_envs[aid]  # re-homed with fresh envs before a restart
        chaos_point = f"dreamer_sebulba.actor{aid}.step"
        env_offset = aid * num_envs
        try:
            _, stream_ctx = side_stream(actor_device)
            with stream_ctx, torch.no_grad():
                actor_streams.add(stream_id(actor_device))
                # the generation folded in: a restarted actor draws a fresh stream
                actor_seed = fold_seed(actor_base_state, aid, ctx.generation)
                generator = torch.Generator(device=actor_device).manual_seed(actor_seed)
                action_rng = np.random.default_rng(actor_seed)
                obs = envs.reset(seed=seed + aid * num_envs)[0]
                writer = SeqBlobWriter(ring, env_offset)
                ones_mask = np.ones(num_envs, np.int32)
                # row t = (obs_t, action_t, reward_{t-1}, terminated_{t-1}, is_first_t)
                prev_rewards = np.zeros((num_envs, 1), np.float32)
                prev_term = np.zeros((num_envs, 1), np.float32)
                is_first_vec = np.ones((num_envs, 1), np.float32)
                # the policy carry: zeros and a sticky first flag, which the act
                # step's merge turns into the live snapshot's initial states
                actions_carry = torch.zeros((num_envs, act_dim_sum), device=actor_device)
                rec_carry = torch.zeros((num_envs, rec_size), device=actor_device)
                stoch_carry = torch.zeros((num_envs, stoch_flat), device=actor_device)
                policy_first = np.ones((num_envs, 1), np.float32)
                episodes: List[Tuple[float, int]] = []
                while not ctx.cancelled:
                    # newest-ready-wins: never queue a block behind a train dispatch
                    version, agent = param_server.pull(prefer_ready=True)
                    try:
                        noise = draw_act_noise(generator, block, num_envs, stoch_flat, actions_dim, is_continuous,
                                               actor_device)
                        for t in range(block):
                            if ctx.cancelled:
                                return
                            ctx.beat()
                            fault_point(chaos_point)
                            with produced_lock:
                                produced["iters"] += 1
                                my_iter = produced["iters"]
                            if my_iter <= learning_starts and state is None:
                                if is_continuous:
                                    actions = action_rng.uniform(low, high, size=(num_envs, len(low))).astype(np.float32)
                                    real_actions = actions
                                else:
                                    real_actions = action_rng.integers(0, actions_dim, size=(num_envs, len(actions_dim)))
                                    actions = np.concatenate([np.eye(d, dtype=np.float32)[real_actions[:, i]]
                                                              for i, d in enumerate(actions_dim)], axis=-1)
                            else:
                                prepared = prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys=cnn_keys,
                                                       num_envs=num_envs)
                                _, actions_carry, rec_carry, stoch_carry = act_fn(
                                    agent, {k: torch.from_numpy(v).to(actor_device) for k, v in prepared.items()},
                                    actions_carry, rec_carry, stoch_carry,
                                    torch.from_numpy(policy_first).to(actor_device),
                                    {"posterior": noise["posterior"][t], "actions": [u[t] for u in noise["actions"]]},
                                )
                                with produced_lock:
                                    produced["act_steps"] += 1
                                policy_first = np.zeros((num_envs, 1), np.float32)
                                # one copy to the host for every head
                                actions = actions_carry.cpu().numpy()
                                if is_continuous:
                                    real_actions = actions
                                else:
                                    parts = np.split(actions, np.cumsum(actions_dim)[:-1], axis=-1)
                                    real_actions = np.stack([p.argmax(axis=-1) for p in parts], axis=-1)

                            # the regular all-envs row, written straight into the blob
                            row = writer.row(ones_mask)
                            for k in obs_keys:
                                row[k][...] = np.asarray(obs[k]).reshape(row[k].shape)
                            row["actions"][...] = np.asarray(actions, np.float32).reshape(num_envs, -1)
                            row["rewards"][...] = prev_rewards
                            row["terminated"][...] = prev_term
                            row["is_first"][...] = is_first_vec

                            next_obs, rewards, terminated, truncated, infos = envs.step(real_actions)
                            dones = np.logical_or(terminated, truncated)
                            is_first_vec = np.zeros((num_envs, 1), np.float32)
                            episodes += [(ep_rew, ep_len) for _, ep_rew, ep_len in infos.get("episodes", ())]
                            obs = next_obs
                            prev_rewards = np.asarray(rewards, np.float32).reshape(num_envs, 1)
                            if clip_rewards:
                                prev_rewards = np.tanh(prev_rewards)
                            prev_term = np.asarray(terminated, np.float32).reshape(num_envs, 1)

                            dones_idxes = np.nonzero(dones)[0].tolist()
                            if dones_idxes:
                                # the ragged reset row: only the done envs advance their heads,
                                # each with its episode's last observation
                                mask = np.zeros(num_envs, np.int32)
                                mask[dones_idxes] = 1
                                rrow = writer.row(mask)
                                final_obs = infos.get("final_obs", [None] * num_envs)
                                for e in dones_idxes:
                                    fo = final_obs[e]
                                    for k in obs_keys:
                                        rrow[k][e] = np.asarray(fo[k] if fo is not None else next_obs[k][e]).reshape(
                                            rrow[k].shape[1:])
                                rrow["actions"][dones_idxes] = 0.0
                                rrow["rewards"][dones_idxes] = prev_rewards[dones_idxes]
                                rrow["terminated"][dones_idxes] = prev_term[dones_idxes]
                                rrow["is_first"][dones_idxes] = 0.0
                                prev_rewards[dones_idxes] = 0.0
                                prev_term[dones_idxes] = 0.0
                                is_first_vec[dones_idxes] = 1.0
                                policy_first[dones_idxes] = 1.0
                    finally:
                        param_server.release(version)
                    if ctx.cancelled:  # never ship a block past the stop
                        return
                    # the upload on the actor's thread and stream: the learner sees a blob on the card
                    blob, local_counts = writer.ship()
                    env_counts = np.zeros(ring_envs, np.int64)
                    env_counts[env_offset:env_offset + num_envs] = local_counts
                    item = {"blob": StagedItem.record({"blob": blob}), "env_offset": env_offset,
                            "env_counts": env_counts, "steps": block, "version": version, "episodes": episodes,
                            "actor_id": aid}
                    episodes = []
                    if not rollout_q.put(item, stop_event=ctx, beat=ctx.beat):
                        return
        finally:  # a crash reaches the supervisor (restart, degrade or abort)
            try:
                envs.close()
            except Exception:
                pass

    def rehome(aid: int, ctx) -> None:
        # the replacement acts on fresh envs with a zeroed carry, which its
        # sticky first flags re-initialise from a fresh snapshot
        actor_envs[aid] = make_vector_env(cfg, seed + aid * num_envs)

    iter_num = start_iter - 1
    grant_backlog = 0
    train_step = int(state.get("train_step", 0)) if state is not None else 0
    # this run's gradient steps: a resumed run starts again at 0, so its
    # first step copies the critic into the target critic, as JAX's loop does
    carry = (moments_state, torch.zeros((), dtype=torch.int64, device=learner_device))
    summary: Dict[str, Any] = {
        "start_iter": start_iter, "iterations": 0, "gradient_steps": 0, "train_calls": 0, "metrics": [],
        "episodes": [], "append_s": [], "dispatch_host_s": [], "checkpoint": None, "device": str(device),
        "test_reward": None, "test_steps": None, "grad_max": grad_max,
        "prefill_policy_steps": prefill_steps * policy_steps_per_iter, "staleness": [],
    }
    metric_names = METRIC_NAMES + (("Fault/skipped_fraction",) if guard else ())
    pending: List[torch.Tensor] = []

    def read_metrics() -> None:
        if pending:
            rows = torch.stack(pending).cpu().tolist()
            pending.clear()
            summary["metrics"].extend(rows)
            if aggregator is not None:
                for row in rows:
                    for name, value in zip(metric_names, row):
                        if name in aggregator:
                            aggregator.update(name, value)

    def checkpoint_state(it: int) -> Dict[str, Any]:
        out = {"world_model": world_model.state_dict(), "actor": actor.state_dict(), "critic": critic.state_dict(),
               "target_critic": target_critic.state_dict(),
               "optimizers": {name: opt.state_dict() for name, opt in optimizers.items()},
               "moments": carry[0], "ratio": ratio.state_dict(), "iter_num": it, "batch_size": batch_size,
               "last_log": last_log, "last_checkpoint": last_checkpoint, "train_step": train_step,
               "rng": rng.get_state(), "actor_rng": actor_base_state}
        if cfg.buffer.get("checkpoint", False):
            out["rb"] = ring.state_dict(live=True).to_dict()  # the ring, its heads and its generator
        return out

    def rollback(good: Dict[str, Any]) -> None:
        nonlocal carry
        for module, name in ((world_model, "world_model"), (actor, "actor"), (critic, "critic"),
                             (target_critic, "target_critic")):
            module.load_state_dict(good[name])
        for name, opt in optimizers.items():
            opt.load_state_dict(good["optimizers"][name])
        carry = ({k: v.to(learner_device) for k, v in good["moments"].items()}, carry[1])
        if good.get("rng") is not None:
            rng.set_state(good["rng"])

    for a in range(num_actors):
        supervisor.spawn(name=f"dreamer-sebulba-actor-{a}", target=partial(actor_fn, a), on_restart=partial(rehome, a))
    pool_metrics: Dict[str, float] = {}
    try:
        while iter_num < total_iters:
            supervisor.check()
            try:
                item = rollout_q.get(timeout=0.5, deadline_s=handoff_deadline(), diagnose=supervisor.describe)
            except _queue.Empty:
                continue
            steps = int(item["steps"])
            staleness = param_server.version - item["version"]
            stats.observe_staleness(staleness)
            summary["staleness"].append(staleness)
            # the append: one ragged multi-head scatter at the actor's columns (the learner is the ring's only writer)
            t0 = time.perf_counter()
            blob = item["blob"].wait()["blob"]
            ring.append(blob, item["env_offset"])
            ring.note_append(item["env_counts"], blob.numel())
            summary["append_s"].append(time.perf_counter() - t0)
            stats.add("env_steps", steps * num_envs)
            for _ in range(steps):  # the coupled loop's grant accounting, one Ratio call per consumed row
                iter_num += 1
                policy_step += policy_steps_per_iter
                summary["iterations"] += 1
                if iter_num >= learning_starts:
                    grant_backlog += ratio(policy_step - prefill_steps * policy_steps_per_iter)
            # train at the learner's own cadence: the backlog in grad_max-step
            # dispatches, held while any env column is shorter than a window
            while grant_backlog > 0 and ring.ready():
                chunk = min(grad_max, grant_backlog)
                validmask = np.zeros((grad_max,), np.float32)
                validmask[:chunk] = 1.0
                ctl = pack_burst_blob(ctl_layout, {"__validmask__": validmask})
                t1 = time.perf_counter()
                carry, metrics = train_fn(carry, ring.state, ctl, ring.host_valid, generator=ring.generator)
                summary["dispatch_host_s"].append((time.perf_counter() - t1, chunk))  # the enqueue, per dispatch
                grant_backlog -= chunk
                summary["gradient_steps"] += chunk
                summary["train_calls"] += 1
                stats.add("grad_steps", chunk)
                train_step += 1
                param_server.maybe_publish(train_step)
                pending.append(metrics)
                if guard and sentinel.observe(float(metrics[-1]) * chunk):
                    manager.wait()  # the newest save must be published before the rollback looks for it
                    sentinel.recover(ckpt_dir, rollback)
                    param_server.publish()  # actors never keep acting on diverged weights
            for ep_rew, ep_len in item["episodes"]:
                summary["episodes"].append((policy_step, item["actor_id"], ep_rew, ep_len))
                if log_level > 0:
                    if aggregator is not None:
                        aggregator.update("Rewards/rew_avg", ep_rew)
                        aggregator.update("Game/ep_len_avg", ep_len)
                    print(f"Rank-0: policy_step={policy_step}, reward_env_{item['actor_id']}={ep_rew}", flush=True)

            if policy_step - last_log >= log_every or iter_num >= total_iters:
                read_metrics()
                if log_level > 0:
                    if aggregator is not None:
                        logger.log_dict(aggregator.compute(), policy_step)
                        aggregator.reset()
                    pipe = stats.snapshot()
                    pipe["Pipeline/queue_depth"] = rollout_q.qsize()
                    pipe.update(supervisor.metrics("Pipeline/", "actor"))
                    logger.log_dict(pipe, policy_step)
                    logger.log_dict(ring.metrics(), policy_step)
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
    read_metrics()
    if os.environ.get("SHEEPRL_SEBULBA_DEBUG"):
        print("DREAMER_SEBULBA_STATS", {**stats.snapshot(), **pool_metrics, "staleness_max": stats.max_staleness_seen,
                                        "policy_steps": policy_step, "grad_steps": summary["gradient_steps"],
                                        "prefill_policy_steps": prefill_steps * policy_steps_per_iter}, flush=True)
    if stats.max_staleness_seen > 2 * bound + prefill_publishes:
        warnings.warn(f"Pipeline params staleness reached {stats.max_staleness_seen} publishes (steady-state bound "
                      f"{bound} + prefill transient {prefill_publishes}): actors cannot keep up with the learner; "
                      "raise algo.sebulba.num_actor_threads or publish_every.")
    if algo.get("run_test", True):
        agent = DreamerV3Agent(world_model, actor)
        summary["test_reward"], summary["test_steps"] = test(agent, cfg, learner_device, greedy=False)
    logger.close()
    summary.update(
        policy_steps=policy_step,
        log_dir=log_dir,
        act_steps=produced["act_steps"],
        replay=ring.metrics(),
        streams={"learner": stream_id(learner_device), "actors": sorted(actor_streams, key=str)},
        pipeline={**stats.snapshot(), **pool_metrics, "staleness_hist": dict(stats.staleness_hist),
                  "staleness_max": stats.max_staleness_seen, "staleness_bound": bound,
                  "prefill_publishes": prefill_publishes, "snapshots": param_server.snapshots,
                  "ready_fallbacks": stats.ready_fallbacks},
        rollbacks=sentinel.rollbacks,
        checkpoint_timings=manager.timings,
        **{"Fault/skipped_updates": sentinel.total_skipped,
           "Fault/env_restarts": sum(e.env_restarts for e in actor_envs)},
    )
    return summary
