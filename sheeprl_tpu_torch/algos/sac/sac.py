"""SAC coupled training (counterpart of ``sheeprl_tpu/algos/sac/sac.py``,
one device).

Each iteration, in the JAX package's order: one env step of ``num_envs``
envs (uniform random actions until ``learning_starts``, then the actor's
samples), the transition stored with the real final observation of a
truncated env as its next observation (with ``buffer.sample_next_obs`` no
next observation is stored: the host buffer reads it from the env's next
row, as the JAX buffer does), then the gradient steps the
``Ratio`` grants. A gradient step is the critic's TD update, the target
critics' EMA, the actor's update and the entropy coefficient's, each with
its own Adam.

Two replay tiers, chosen by ``buffer.device_resident`` (and the HBM budget):

- host (:func:`make_train_step`): the numpy ``ReplayBuffer``, uniform
  ``(G, B)`` samples copied to the device in one transfer, then G steps;
- device-resident (:func:`make_resident_train_step`): the ring lives on the
  device (:class:`~sheeprl_tpu_torch.replay.DeviceReplayBuffer`); each env
  step is one dispatch that appends the staged row and runs the granted
  steps, each drawing its batch on the device: uniform, or with
  ``buffer.priority.enabled`` proportional through the sum-tree by the CUDA
  ``sumtree_sample`` kernel, whose IS weights scale the critic's errors and
  whose |TD| priorities go back into the tree. ``beta`` anneals to 1 over
  ``total_steps``.

Random numbers come from explicit ``torch.Generator``s (the player's, the
host path's train draws, and the device ring's own stream, which its
checkpoint carries); both train steps take their uniforms and Gaussian noise
as arguments too, so a test can feed JAX's draws. Losses stay on the device
until a log point reads them.

With ``fault.sentinel.enabled`` (the default) every gradient step is guarded
as the JAX package's ``guard=True`` step is: when a loss or a gradient of
the critic, actor or entropy update is not finite, the parameters (target
critics included), the three optimizers' states, and on the ring the drawn
leaves' priorities and ``max_p`` stay as they were (a select on the device,
no host read); the loop reads the skipped count once per train call for the
:class:`~sheeprl_tpu_torch.fault.DivergenceSentinel`.

The run writes into its own directory (``utils.logger.get_log_dir``) and, at
``metric.log_level`` 1, the JAX loop's metrics into ``metrics.jsonl`` every
``metric.log_every`` policy steps: ``Rewards/rew_avg``, ``Game/ep_len_avg``,
``Loss/*`` (the losses kept on the device are read there, in one copy),
``Params/replay_ratio``, ``Time/sps_*``, on the ring ``Replay/*``, and the
fault counters. The host tier's buffer is memmapped with ``buffer.memmap``.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.agent import SACAgent, SACPlayer, build_agent
from sheeprl_tpu_torch.algos.sac.loss import critic_loss, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.data import ReplayBuffer
from sheeprl_tpu_torch.data.ring import BlobLayout, make_layout, pack_burst_blob, unpack_burst_blob
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import CheckpointManager, DivergenceSentinel, load_resume_state
from sheeprl_tpu_torch.ops.guard import StateGuard, finite_guard
from sheeprl_tpu_torch.ops.kernels import sumtree_sample
from sheeprl_tpu_torch.optim import ClippedOptimizer, build_optimizer
from sheeprl_tpu_torch.utils.burst import HostCopies, HostSnapshot, TrainerThread, TrainStateCopy
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric, build_aggregator
from sheeprl_tpu_torch.utils.timer import log_timers, timer
from sheeprl_tpu_torch.replay import DeviceReplayBuffer, DeviceReplayState, resolve_device_resident, restore_host_buffer
from sheeprl_tpu_torch.replay import sumtree as st
from sheeprl_tpu_torch.utils.utils import Ratio, resolve_hybrid_player

__all__ = ["LOSS_NAMES", "RING_KEYS", "burst_layout", "make_burst_train_step", "make_optimizers", "make_train_step",
           "make_resident_train_step", "restore_train_state", "main"]

LOSS_NAMES = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss")
#: what a stored transition holds, in the order a host sample is packed for its one copy to the device
RING_KEYS = ("observations", "next_observations", "actions", "rewards", "terminated")

Optimizers = Tuple[ClippedOptimizer, ClippedOptimizer, ClippedOptimizer]


def make_optimizers(cfg: Any, agent: SACAgent) -> Optimizers:
    """``(actor, critic, alpha)`` Adams, as the JAX package's ``actor_tx``,
    ``critic_tx`` and ``alpha_tx``."""
    algo = cfg.algo
    return (
        build_optimizer(agent.actor.parameters(), algo.actor.optimizer),
        build_optimizer(agent.critic.parameters(), algo.critic.optimizer),
        build_optimizer([agent.log_alpha], algo.alpha.optimizer),
    )


def restore_train_state(agent: SACAgent, optimizers: Optimizers, generator: torch.Generator,
                        good: Dict[str, Any]) -> None:
    """Put a rollback checkpoint's agent, optimizers and generator back into
    the live objects (the sentinel's recover callback; JAX
    ``restore_train_state``)."""
    agent.load_state_dict(good["agent"])
    for opt, name in zip(optimizers, ("actor_optimizer", "qf_optimizer", "alpha_optimizer")):
        opt.load_state_dict(good[name])
    if good.get("rng") is not None:
        generator.set_state(good["rng"])


def _gradient_step(agent: SACAgent, optimizers: Optimizers, gamma: float,
                   guard: bool = False) -> Tuple[Callable, Callable]:
    """One SAC update and the snapshot that starts a train call:
    ``step(batch, weights, noise_next, noise_actor, ema) -> (losses (3,), q
    (B, n), td_target (B, 1), ok)``, the agent updated in place. ``weights``
    are PER's normalized IS weights or None. With ``guard``, ``ok`` is the
    0-dim verdict over the three updates' losses and gradients, and where it
    is False the step has put the agent and the optimizers' states back as
    the last ``snapshot()`` or step left them; else ``ok`` is None and
    ``snapshot`` does nothing."""
    actor_opt, critic_opt, alpha_opt = optimizers
    actor_params, critic_params = list(agent.actor.parameters()), list(agent.critic.parameters())
    every_param = list(agent.parameters())  # actor, critic, target critic, log_alpha
    state_guard = StateGuard(
        lambda: every_param + [t for opt in optimizers for t in opt.state_tensors()]
    ) if guard else None

    def step(batch: Dict[str, torch.Tensor], weights: Optional[torch.Tensor], noise_next: torch.Tensor,
             noise_actor: torch.Tensor, ema: bool):
        obs = batch["observations"]
        td_target = agent.next_target_q(
            batch["next_observations"], batch["rewards"], batch["terminated"], gamma, noise_next
        )
        q = agent.q_values(obs, batch["actions"])
        qf_loss = critic_loss(q, td_target, weights)
        cgrads = torch.autograd.grad(qf_loss, critic_params)
        critic_opt.step(cgrads)
        if ema:
            agent.ema()

        alpha = torch.exp(agent.log_alpha.detach())
        actions, logp = agent.sample_action(obs, noise_actor)
        min_q = torch.min(agent.q_values(obs, actions), dim=-1, keepdim=True).values
        actor_loss = policy_loss(alpha, logp, min_q)
        agrads = torch.autograd.grad(actor_loss, actor_params)
        actor_opt.step(agrads)

        alpha_loss = entropy_loss(agent.log_alpha, logp.detach(), agent.target_entropy)
        lgrads = torch.autograd.grad(alpha_loss, [agent.log_alpha])
        alpha_opt.step(lgrads)
        ok = None
        if guard:
            ok = finite_guard([*cgrads, *agrads, *lgrads, qf_loss, actor_loss, alpha_loss])
            state_guard.select(ok)
        return torch.stack([qf_loss, actor_loss, alpha_loss]).detach(), q.detach(), td_target, ok

    return step, (state_guard.snapshot if guard else lambda: None)


def _count_skipped(skipped: torch.Tensor, ok: Optional[torch.Tensor]) -> None:
    if ok is not None:
        skipped += (~ok).to(torch.float32)


def make_train_step(agent: SACAgent, optimizers: Optimizers, cfg: Any, guard: bool = False) -> Callable:
    """The host-replay update (JAX ``make_train_step`` on one device):
    ``train(data, ema, noise=None, generator=None) -> (losses, skipped)``. ``data``
    holds ``(G, B, ...)`` float32 tensors of :data:`RING_KEYS` on the
    agent's device; ``noise`` is ``{"next", "actor"}``, each ``(G, B,
    act_dim)`` standard normal, else drawn from ``generator``. ``ema`` is the
    JAX ``ema_flag`` of the iteration. Returns the ``(3,)`` mean of
    :data:`LOSS_NAMES` over the G steps and ``skipped``, the 0-dim count of
    steps the guard undid (0 unguarded), both left on the device."""
    step, snapshot = _gradient_step(agent, optimizers, float(cfg.algo.gamma), guard)

    def train(data: Dict[str, torch.Tensor], ema: bool, noise: Optional[Dict[str, torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        G, B = data["actions"].shape[:2]
        device = data["actions"].device
        if noise is None:
            noise = {k: torch.randn((G, B, agent.action_dim), generator=generator, device=device) for k in ("next", "actor")}
        total = torch.zeros(3, dtype=torch.float32, device=device)
        skipped = torch.zeros((), dtype=torch.float32, device=device)
        snapshot()
        for g in range(G):
            losses, _, _, ok = step({k: data[k][g] for k in RING_KEYS}, None, noise["next"][g], noise["actor"][g],
                                    bool(ema))
            total += losses
            _count_skipped(skipped, ok)
        return total / G, skipped

    return train


def make_resident_train_step(agent: SACAgent, optimizers: Optimizers, cfg: Any, drb: DeviceReplayBuffer,
                             guard: bool = False, append: bool = True) -> Callable:
    """The device-resident dispatch (JAX ``make_resident_train_step`` on one
    device): ``train(job, flags, beta=0.0, draws=None) -> (losses, skipped)
    or None``.

    ``job`` is :meth:`DeviceReplayBuffer.make_job`'s flush, appended first;
    then one gradient step per entry of ``flags`` (the granted steps' EMA
    flags; none for a step that only appends). Each step draws ``B`` rows
    from the ``job.valid`` rows now stored: with PER, proportionally through
    the sum-tree (``sumtree_sample``, importance weights with exponent
    ``beta`` normalized by the batch's largest), then writes ``(|TD| +
    eps)^alpha`` back as the drawn leaves' priorities and raises ``max_p``;
    else uniformly over the ``(row, env)`` grid. ``draws`` holds each step's
    random numbers, ``(G, B)`` uniforms ``u`` (PER) or ``pos``/``env``
    indices (uniform), and ``next``/``actor`` Gaussian noise ``(G, B,
    act_dim)``; else they come from the ring's generator. Returns the
    ``(3,)`` mean of :data:`LOSS_NAMES` over the steps and the 0-dim count
    of steps the guard undid (0 unguarded), on the device, or None without
    steps. Nothing here reads the device back.

    ``append=False`` (JAX ``append=False``) is the decoupled topology's
    train-only dispatch: ``train(ctl, draws=None)`` over a
    :class:`~sheeprl_tpu_torch.replay.ControlJob` (its flags, beta and the
    valid rows); the appends ride :meth:`DeviceReplayBuffer.make_append_step`.
    The draws, the sum-tree and the ring's generator advance exactly as in
    the fused form.

    ``guard=True`` (JAX ``guard=True``): a step the guard undoes also leaves
    the drawn leaves' priorities and ``max_p`` as they were (the old leaf is
    written back, so the next draw sees the tree JAX restores)."""
    step, snapshot = _gradient_step(agent, optimizers, float(cfg.algo.gamma), guard)
    batch_size = int(cfg.algo.per_rank_batch_size)
    n_envs = drb.n_envs
    flat = {k: v.view(drb.capacity * n_envs, *v.shape[2:]) for k, v in drb.storage.items()}

    def draw(count: int, valid: int) -> Dict[str, torch.Tensor]:
        gen, dev = drb.generator, drb.device
        if drb.prioritized:
            draws = {"u": torch.rand((count, batch_size), generator=gen, device=dev)}
        else:
            draws = {
                "pos": torch.randint(0, max(valid, 1), (count, batch_size), generator=gen, device=dev),
                "env": torch.randint(0, n_envs, (count, batch_size), generator=gen, device=dev),
            }
        for k in ("next", "actor"):
            draws[k] = torch.randn((count, batch_size, agent.action_dim), generator=gen, device=dev)
        return draws

    def steps(flags: Sequence[float], beta: float, valid: int,
              draws: Optional[Dict[str, torch.Tensor]]) -> Tuple[torch.Tensor, torch.Tensor]:
        if draws is None:
            draws = draw(len(flags), valid)
        total = torch.zeros(3, dtype=torch.float32, device=drb.device)
        skipped = torch.zeros((), dtype=torch.float32, device=drb.device)
        snapshot()
        for g, flag in enumerate(flags):
            weights = None
            if drb.prioritized:
                leaf, weights = sumtree_sample(drb.tree, draws["u"][g], valid * n_envs, beta)
                weights = weights / torch.clamp(weights.max(), min=1e-12)
                rows = leaf.to(torch.int64)  # leaves are (row, env) row-major
            else:
                rows = draws["pos"][g] * n_envs + draws["env"][g]
            batch = {k: flat[k][rows] for k in RING_KEYS}
            losses, q, td_target, ok = step(batch, weights, draws["next"][g], draws["actor"][g], bool(flag))
            if drb.prioritized:
                priority = torch.pow(torch.mean(torch.abs(q - td_target), dim=-1) + drb.per_eps, drb.per_alpha)
                if ok is not None:
                    # a skipped step writes the drawn leaves' old priorities back; a
                    # leaf never exceeds max_p (new rows enter at max_p), so max_p
                    # below stays as it was too
                    priority = torch.where(ok, priority, st.get(drb.tree, rows))
                st.update(drb.tree, rows, priority)
                torch.maximum(drb.max_p, priority.max(), out=drb.max_p)
            total += losses
            _count_skipped(skipped, ok)
        return total / len(flags), skipped

    if not append:
        def train_only(ctl, draws: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
            if not ctl.flags:
                return None
            return steps(ctl.flags, ctl.beta, ctl.valid, draws)

        return train_only

    def train(job, flags: Sequence[float], beta: float = 0.0,
              draws: Optional[Dict[str, torch.Tensor]] = None) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        drb.append(job)
        if not flags:
            return None
        return steps(flags, beta, job.valid, draws)

    return train


def burst_layout(dims: Dict[str, int], stage_max: int, n_envs: int, grad_chunk: int) -> BlobLayout:
    """Byte layout of one burst job (JAX ``make_burst_train_step``'s packed
    upload): ``stage_max`` staged rows of each ring key, the ring's write
    head, the staged count, the valid rows after the append, each step's EMA
    flag and its granted mask. JAX's blob also carries the burst's PRNG key;
    the port's draws come from the trainer's generator."""
    spec = [(k, (stage_max, n_envs, d), np.float32) for k, d in dims.items()]
    spec += [
        ("__pos__", (), np.int32),
        ("__count__", (), np.int32),
        ("__valid_n__", (), np.int32),
        ("__flags__", (grad_chunk,), np.float32),
        ("__valid__", (grad_chunk,), np.float32),
    ]
    return make_layout(spec)


def make_burst_train_step(agent: SACAgent, optimizers: Optimizers, cfg: Any, capacity: int, n_envs: int,
                          stage_max: int, grad_chunk: int, dims: Dict[str, int]) -> Tuple[Callable, BlobLayout]:
    """The hybrid player's burst (JAX ``make_burst_train_step`` on one
    device): ``(burst, layout)`` with ``burst(rb, blob, generator=None,
    draws=None) -> losses or None``.

    ``rb`` is the flat ring ``{key: (capacity, n_envs, d)}`` float32 on the
    card, ``blob`` one host :func:`burst_layout` job. The burst appends the
    blob's first ``__count__`` staged rows at the write head with
    wrap-around (the padding rows are dropped; plain ``index_copy_``, as JAX
    appends outside any Pallas kernel), then runs one uniform minibatch step
    over the valid ``(position, env)`` grid for each granted entry of
    ``__valid__`` (a prefix): the critic update, the target EMA where
    ``__flags__`` says, the actor and the entropy updates. The steps past
    the granted prefix are no-ops, as JAX's masked scan steps are. Each step
    draws ``B`` positions, ``B`` envs and the next-action and actor noise
    from ``generator`` unless ``draws`` holds them (``pos``/``env`` ``(G,
    B)`` and ``next``/``actor`` ``(G, B, act_dim)`` for the G granted
    steps). The count, heads and masks are read from the host copy of the
    blob: nothing is read back from the card. Returns the ``(3,)`` mean of
    :data:`LOSS_NAMES` over the granted steps, or None."""
    step, _ = _gradient_step(agent, optimizers, float(cfg.algo.gamma))
    layout = burst_layout(dims, stage_max, n_envs, grad_chunk)
    batch_size = int(cfg.algo.per_rank_batch_size)
    capacity, n_envs = int(capacity), int(n_envs)

    def burst(rb: Dict[str, torch.Tensor], blob: torch.Tensor, generator: Optional[torch.Generator] = None,
              draws: Optional[Dict[str, torch.Tensor]] = None) -> Optional[torch.Tensor]:
        device = next(iter(rb.values())).device
        host = unpack_burst_blob(blob, layout)
        staged = unpack_burst_blob(blob.to(device, non_blocking=True), layout)
        count, pos, valid_n = int(host["__count__"]), int(host["__pos__"]), int(host["__valid_n__"])
        if count:
            rows = (pos + torch.arange(count, device=device)) % capacity
            for k in dims:
                rb[k].index_copy_(0, rows, staged[k][:count])
        granted = [g for g in range(grad_chunk) if float(host["__valid__"][g]) > 0]
        if not granted:
            return None
        n = len(granted)
        if draws is None:
            draws = {
                "pos": torch.randint(0, max(valid_n, 1), (n, batch_size), generator=generator, device=device),
                "env": torch.randint(0, n_envs, (n, batch_size), generator=generator, device=device),
            }
            for k in ("next", "actor"):
                draws[k] = torch.randn((n, batch_size, agent.action_dim), generator=generator, device=device)
        total = torch.zeros(3, dtype=torch.float32, device=device)
        for i, g in enumerate(granted):
            batch = {k: rb[k][draws["pos"][i], draws["env"][i]] for k in RING_KEYS}
            losses, _, _, _ = step(batch, None, draws["next"][i], draws["actor"][i], float(host["__flags__"][g]) > 0)
            total += losses
        return total / n

    return burst, layout


def _ring_specs(obs_dim: int, act_dim: int) -> Dict[str, Tuple[tuple, Any]]:
    return {
        "observations": ((obs_dim,), np.float32),
        "next_observations": ((obs_dim,), np.float32),
        "actions": ((act_dim,), np.float32),
        "rewards": ((1,), np.float32),
        "terminated": ((1,), np.float32),
    }


def _to_device(sample: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host sample's :data:`RING_KEYS` as float32 on ``device``, in ONE copy."""
    widths = [int(np.prod(sample[k].shape[2:])) for k in RING_KEYS]
    lead = sample[RING_KEYS[0]].shape[:2]
    packed = np.concatenate([sample[k].reshape(*lead, -1).astype(np.float32) for k in RING_KEYS], axis=-1)
    on_device = torch.from_numpy(packed).to(device)
    return dict(zip(RING_KEYS, torch.split(on_device, widths, dim=-1)))


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The coupled loop: act, store, train, log, checkpoint; a greedy test
    episode at the end with ``algo.run_test``. Returns a summary of the run
    (counters, the losses of every train call, the finished episodes, host
    seconds per iteration, the replay tier and its metrics, the last
    checkpoint's path, ``Fault/skipped_updates``, ``Fault/env_restarts``, the
    sentinel's rollbacks and the manager's save timings)."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    algo = cfg.algo
    if list(algo.cnn_keys.encoder):
        warnings.warn("SAC algorithm cannot allow to use images as observations, the CNN keys will be ignored")
        algo.cnn_keys["encoder"] = []
    mlp_keys = list(algo.mlp_keys.encoder)
    if not mlp_keys:
        raise RuntimeError("You should specify at least one MLP key for the encoder: `mlp_keys.encoder=[state]`")
    # the host buffer stores no next observation and reads it from the next row
    sample_next_obs = bool(cfg.buffer.get("sample_next_obs", False))
    num_envs = int(cfg.env.num_envs)
    seed = int(cfg.seed)

    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    envs = make_vector_env(cfg, seed)
    cfg["spaces"] = dotdict(envs.spaces)
    logger.log_hyperparams(cfg)
    write_run_config(log_dir, plain(cfg))  # the run directory's config.json
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))
    action_space = cfg.spaces.actions
    if not action_space.get("continuous", False):
        raise ValueError("Only continuous action space is supported for the SAC agent")
    obs_dim = int(sum(np.prod(cfg.spaces.obs[k].shape) for k in mlp_keys))
    act_dim = int(np.prod(action_space.shape))
    low, high = np.asarray(action_space.low, np.float32), np.asarray(action_space.high, np.float32)

    generator = torch.Generator(device=device).manual_seed(seed)
    if state is not None and state.get("rng") is not None:
        generator.set_state(state["rng"])
    agent, player = build_agent(cfg, obs_dim, action_space, device, state["agent"] if state is not None else None, generator)
    optimizers = make_optimizers(cfg, agent)
    if state is not None:
        for opt, name in zip(optimizers, ("actor_optimizer", "qf_optimizer", "alpha_optimizer")):
            opt.load_state_dict(state[name])
        algo["per_rank_batch_size"] = int(state["batch_size"])
    batch_size = int(algo.per_rank_batch_size)

    dry_run = bool(cfg.get("dry_run", False))
    buffer_size = int(cfg.buffer.size) // num_envs if not dry_run else 1
    specs = _ring_specs(obs_dim, act_dim)
    per_cfg = cfg.buffer.priority
    prioritized = bool(per_cfg.enabled)
    # the hybrid host player (JAX's default off the CPU): the actor acts on
    # the host CPU from a snapshot; with train_every > 1 (auto: 64) the
    # grants train in bursts on a trainer thread over a ring on the card,
    # which takes precedence over the resident tier and samples uniformly
    hp_cfg = algo.get("hybrid_player") or {}
    hybrid = resolve_hybrid_player(hp_cfg, device)
    refresh_every = max(1, int(hp_cfg.get("refresh_every", 64)))
    train_every = hp_cfg.get("train_every", "auto")
    if isinstance(train_every, str):
        train_every = (64 if hybrid else 1) if train_every == "auto" else int(train_every)
    train_every = max(1, int(train_every))
    burst = hybrid and train_every > 1
    if burst and sample_next_obs:
        warnings.warn("buffer.sample_next_obs is not supported by burst training; disabling the burst path.")
        burst = False
    resident, reason = False, "algo.hybrid_player"
    if not burst:
        resident, reason = resolve_device_resident(
            cfg.buffer.device_resident, specs, buffer_size, num_envs, float(cfg.buffer.hbm_budget_gb), prioritized
        )
    if resident and sample_next_obs:
        # the ring holds every row's next observation; a uniform ring spills
        # to the host buffer as the JAX loop does, a prioritized one raises as
        # an over-budget prioritized ring does (the host tier has no PER)
        if prioritized:
            raise ValueError("buffer.sample_next_obs stores no next observation, which the prioritized device ring "
                             "needs; turn one of buffer.sample_next_obs and buffer.priority.enabled off")
        warnings.warn("buffer.sample_next_obs stores no explicit next observation; the device-resident ring needs "
                      "one — falling back to the host buffer path.")
        resident, reason = False, "buffer.sample_next_obs"
    log_level = int(cfg.metric.get("log_level", 1))
    if log_level > 0 and cfg.buffer.device_resident and not burst:
        print(f"Replay: device_resident={resident} ({reason})", flush=True)

    rb = ReplayBuffer(buffer_size, num_envs, ("observations",), memmap=bool(cfg.buffer.get("memmap", False)),
                      memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
                      memmap_mode=str(cfg.buffer.get("memmap_mode", "r+")))
    rb.seed(seed)
    saved_rb = state.get("rb") if state is not None and cfg.buffer.checkpoint else None
    restored_ring = None
    if saved_rb is not None:
        if "kind" not in saved_rb:
            rb.load_state_dict(saved_rb)
        elif resident:
            restored_ring = DeviceReplayState.from_dict(saved_rb)
        else:  # a device ring resumed on the host tier
            restore_host_buffer(DeviceReplayState.from_dict(saved_rb), rb, fill_missing={"truncated": ((1,), np.uint8)})

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
    ema_modulus = int(algo.critic.target_network_frequency) // policy_steps_per_iter + 1
    log_every = int(cfg.metric.get("log_every", 5000))
    action_repeat = int(cfg.env.get("action_repeat", 1) or 1)
    train_step = int(state.get("train_step", 0)) if state is not None else 0
    last_train = int(state.get("last_train", 0)) if state is not None else 0
    if log_level > 0 and log_every % policy_steps_per_iter != 0:
        warnings.warn(f"The metric.log_every parameter ({log_every}) is not a multiple of the "
                      f"policy_steps_per_iter value ({policy_steps_per_iter}).")
    if int(cfg.checkpoint.every) % policy_steps_per_iter != 0:
        warnings.warn(f"The checkpoint.every parameter ({cfg.checkpoint.every}) is not a multiple of the "
                      f"policy_steps_per_iter value ({policy_steps_per_iter}).")
    sentinel_cfg = (cfg.get("fault") or {}).get("sentinel") or {}
    guard = bool(sentinel_cfg.get("enabled", True)) and not burst
    sentinel = DivergenceSentinel(sentinel_cfg)
    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)

    drb = None
    if resident:
        grad_max = max(1, int(math.ceil(float(algo.replay_ratio) * policy_steps_per_iter)))
        drb = DeviceReplayBuffer(
            specs, buffer_size, num_envs, device=device, prioritized=prioritized,
            per_alpha=float(per_cfg.alpha), per_eps=float(per_cfg.eps), seed=seed + 29,
        )
        if restored_ring is not None:
            drb.load_state_dict(restored_ring)
        elif not rb.empty:  # resumed from a host-buffer checkpoint
            drb.load_host_buffer(rb)
        resident_fn = make_resident_train_step(agent, optimizers, cfg, drb, guard=guard)
        beta0 = float(per_cfg.beta)
        ema_backlog: List[float] = []
    elif not burst:
        train_fn = make_train_step(agent, optimizers, cfg, guard=guard)
    if hybrid:
        # SAC's actor is small: its snapshot stays float32 (the Dreamer harness narrows to bf16)
        host_agent = copy.deepcopy(agent).to("cpu")
        snapshot = HostSnapshot(list(agent.actor.parameters()), list(host_agent.actor.parameters()), torch.float32)
        snapshot.pull()
        host_generator = torch.Generator().manual_seed(seed + 17)
        if state is not None and state.get("host_rng") is not None:
            host_generator.set_state(state["host_rng"])
        host_player = SACPlayer(host_agent, host_generator)
        last_refresh = 0
    if burst:
        grad_chunk = max(1, int(round(float(algo.replay_ratio) * policy_steps_per_iter * train_every)))
        # sized from the configured warm-up, not the resume-shifted one: the
        # staging rows only ever hold the transitions since the last flush
        base_learning_starts = int(algo.get("learning_starts", 0)) // policy_steps_per_iter if not dry_run else 0
        stage_max = min(base_learning_starts + 2 * train_every + 1, buffer_size)
        dims = {k: int(specs[k][0][0]) for k in RING_KEYS}
        burst_fn, layout = make_burst_train_step(agent, optimizers, cfg, buffer_size, num_envs, stage_max, grad_chunk,
                                                 dims)
        rb_dev = {k: torch.zeros((buffer_size, num_envs, d), dtype=torch.float32, device=device)
                  for k, d in dims.items()}
        dev_pos, dev_total = 0, 0
        if not rb.empty:  # resumed with the host buffer: mirror it into the ring
            stored = rb.to_numpy()
            for k in rb_dev:
                host = np.asarray(stored[k], np.float32).reshape(buffer_size, num_envs, -1)
                rb_dev[k] = torch.from_numpy(host).to(device)
            dev_pos, dev_total = rb.pos, (buffer_size if rb.full else rb.pos)
        staged: List[Dict[str, np.ndarray]] = []
        ema_backlog = []
        burst_losses = HostCopies()
        bursts = [0]  # trained bursts, counted on the trainer thread

        def burst_step(rb_dev, blob):
            losses = burst_fn(rb_dev, blob, generator)
            if losses is not None:
                bursts[0] += 1
                burst_losses.put(losses, bursts[0])
            snapshot.refresh_async(bursts[0])  # newest wins; skipped while a copy is in flight
            return rb_dev, losses

        trainer = TrainerThread(burst_step, rb_dev, supervisor_cfg=(cfg.get("fault") or {}).get("supervisor"),
                                rollback=TrainStateCopy([agent], optimizers, [generator]), device=device)
        snapshot.attach_supervisor(trainer.supervisor)

    action_rng = np.random.default_rng(seed)
    obs = envs.reset(seed=seed)[0]
    summary: Dict[str, Any] = {
        "start_iter": start_iter, "iterations": 0, "gradient_steps": 0, "train_calls": 0, "losses": [],
        "episodes": [], "env_s": [], "train_s": [], "checkpoint": None, "device": str(device), "test_reward": None,
        "test_steps": None,
        "resident": resident, "prioritized": resident and prioritized, "hybrid": hybrid, "burst": burst,
        "flush_host_s": [], "act_host_s": [],
    }
    pending: List[torch.Tensor] = []  # losses still on the device

    def read_losses() -> None:
        """The pending losses in one copy; into the summary and the aggregator."""
        if pending:
            rows = torch.stack(pending).cpu().tolist()
            pending.clear()
            summary["losses"].extend(rows)
            if aggregator is not None:
                for row in rows:
                    for name, value in zip(LOSS_NAMES, row):
                        aggregator.update(name, value)

    def take_burst_losses(wait: bool = False) -> None:
        """The trained bursts' losses that have landed on the host."""
        for _burst, row in burst_losses.take(wait):
            pending.append(torch.tensor(row))

    def flush_burst() -> None:
        """Hand the staged transitions and up to one grant chunk to the
        trainer thread (the steps past the granted ones are no-ops)."""
        nonlocal dev_pos, dev_total, train_step
        count = len(staged)
        values: Dict[str, np.ndarray] = {}
        for k, d in dims.items():
            values[k] = np.zeros((stage_max, num_envs, d), np.float32)
            if count:
                values[k][:count] = np.stack([t[k] for t in staged])
        staged.clear()
        dev_total = min(dev_total + count, buffer_size)
        chunk = min(grad_chunk, len(ema_backlog))
        flags = np.zeros((grad_chunk,), np.float32)
        valid = np.zeros((grad_chunk,), np.float32)
        flags[:chunk] = ema_backlog[:chunk]
        valid[:chunk] = 1.0
        t0 = time.perf_counter()
        with timer("Time/train_time", SumMetric):
            values.update(__pos__=np.asarray(dev_pos, np.int32), __count__=np.asarray(count, np.int32),
                          __valid_n__=np.asarray(dev_total, np.int32), __flags__=flags, __valid__=valid)
            trainer.submit(pack_burst_blob(layout, values, pin_memory=device.type == "cuda"))
            take_burst_losses()
        summary["flush_host_s"].append(time.perf_counter() - t0)
        dev_pos = (dev_pos + count) % buffer_size
        del ema_backlog[:chunk]
        if chunk > 0:
            summary["gradient_steps"] += chunk
            summary["train_calls"] += 1
            train_step += 1

    def observe(out):
        """The losses kept on the device; with the guard, the skipped count
        read now (once per train call) and handed to the sentinel."""
        losses, skipped = out
        pending.append(losses)
        if guard and sentinel.observe(skipped):
            manager.wait()  # the newest save must be published before the rollback looks for it
            sentinel.recover(ckpt_dir, lambda good: restore_train_state(agent, optimizers, generator, good))

    for iter_num in range(start_iter, total_iters + 1):
        policy_step += policy_steps_per_iter
        t0 = time.perf_counter()
        if hybrid:
            # adopt a landed snapshot; without bursts also start the next copy
            # every refresh_every iterations (the bursts refresh after each job)
            snapshot.poll()
            if (not burst and iter_num - last_refresh >= refresh_every and iter_num > learning_starts
                    and snapshot.refresh_async(iter_num)):
                last_refresh = iter_num
        # the actor's forward is inside: the copy of its actions to the host waits for the card
        with timer("Time/env_interaction_time", SumMetric):
            if iter_num <= learning_starts:
                actions = action_rng.uniform(low, high, size=(num_envs, act_dim)).astype(np.float32)
            elif hybrid:  # on the host CPU: nothing goes to the card
                t_act, busy = time.perf_counter(), burst and trainer.busy
                actions = host_player(prepare_obs(obs, mlp_keys, num_envs)).float().numpy()
                summary["act_host_s"].append((time.perf_counter() - t_act, busy or (burst and trainer.busy)))
            else:
                actions = player(prepare_obs(obs, mlp_keys, num_envs, device)).float().cpu().numpy()
            next_obs, rewards, terminated, truncated, infos = envs.step(actions)
        for i, ep_rew, ep_len in infos.get("episodes", ()):
            summary["episodes"].append((policy_step, i, ep_rew, ep_len))
            if log_level > 0:
                if aggregator is not None:
                    aggregator.update("Rewards/rew_avg", ep_rew)
                    aggregator.update("Game/ep_len_avg", ep_len)
                print(f"Rank-0: policy_step={policy_step}, reward_env_{i}={ep_rew}", flush=True)

        real_next_obs = {k: np.array(next_obs[k]) for k in mlp_keys}
        for i, final in enumerate(infos.get("final_obs", ())):
            if final is not None:  # the episode's last observation, not the reset one
                for k in mlp_keys:
                    real_next_obs[k][i] = final[k]
        step_data = {
            "terminated": np.asarray(terminated, dtype=np.uint8).reshape(1, num_envs, -1),
            "truncated": np.asarray(truncated, dtype=np.uint8).reshape(1, num_envs, -1),
            "actions": actions.astype(np.float32).reshape(1, num_envs, -1),
            "observations": prepare_obs(obs, mlp_keys, num_envs).numpy()[np.newaxis],
            "rewards": np.asarray(rewards, dtype=np.float32).reshape(1, num_envs, -1),
        }
        if not sample_next_obs:
            step_data["next_observations"] = prepare_obs(real_next_obs, mlp_keys, num_envs).numpy()[np.newaxis]
        if resident:
            drb.add(step_data)  # the device ring is the only storage tier
        else:
            rb.add(step_data)
        obs = next_obs
        t1 = time.perf_counter()

        if burst:
            # stage the transition for the ring; the host buffer stays the checkpoint's copy
            staged.append({k: np.asarray(step_data[k][0], dtype=np.float32) for k in dims})
            if iter_num >= learning_starts:
                granted = ratio(policy_step - prefill_steps + policy_steps_per_iter)
                ema_backlog.extend([1.0 if iter_num % ema_modulus == 0 else 0.0] * granted)
            # one burst once a full grant chunk is queued, or when the staging
            # rows are about to overflow (low replay ratios)
            while len(ema_backlog) >= grad_chunk or len(staged) >= stage_max - 1:
                flush_burst()
                if len(ema_backlog) < grad_chunk:
                    break
        elif resident:
            if iter_num >= learning_starts:
                granted = ratio(policy_step - prefill_steps + policy_steps_per_iter)
                ema_backlog.extend([1.0 if iter_num % ema_modulus == 0 else 0.0] * granted)
            # one dispatch per env step: append the staged row and run up to
            # grad_max granted steps; append-free dispatches drain a backlog
            while True:
                chunk = min(grad_max, len(ema_backlog))
                beta = beta0 + (1.0 - beta0) * min(1.0, policy_step / max(1, int(algo.total_steps))) if prioritized else 0.0
                with timer("Time/replay_path_time", SumMetric):
                    job = drb.make_job()
                # the time to enqueue the dispatch; with the guard, also its
                # device time, as observe's read of the skipped count waits for it
                with timer("Time/train_time", SumMetric):
                    out = resident_fn(job, ema_backlog[:chunk], beta)
                    if chunk:
                        observe(out)
                del ema_backlog[:chunk]
                if chunk:
                    summary["gradient_steps"] += chunk
                    summary["train_calls"] += 1
                    train_step += 1
                if len(ema_backlog) < grad_max:
                    break
        elif iter_num >= learning_starts:
            granted = ratio(policy_step - prefill_steps + policy_steps_per_iter)
            if granted > 0:
                with timer("Time/replay_path_time", SumMetric):
                    data = _to_device(rb.sample(batch_size, granted, sample_next_obs=sample_next_obs), device)
                # as on the ring: the enqueue, and with the guard the device time
                with timer("Time/train_time", SumMetric):
                    observe(train_fn(data, iter_num % ema_modulus == 0, generator=generator))
                summary["gradient_steps"] += granted
                summary["train_calls"] += 1
                train_step += 1
        t2 = time.perf_counter()
        summary["env_s"].append(t1 - t0)
        summary["train_s"].append(t2 - t1)
        summary["iterations"] += 1

        if policy_step - last_log >= log_every or iter_num == total_iters:
            read_losses()
            if log_level > 0:
                if summary["losses"]:
                    print(f"policy_step={policy_step} " + " ".join(
                        f"{n.split('/')[-1]}={v:.6g}" for n, v in zip(LOSS_NAMES, summary["losses"][-1])), flush=True)
                if envs.env_restarts:
                    logger.log_dict({"Fault/env_restarts": envs.env_restarts}, policy_step)
                if guard and sentinel.total_skipped:
                    logger.log_dict({"Fault/skipped_updates": sentinel.total_skipped}, policy_step)
                if resident:
                    logger.log_dict(drb.metrics(), policy_step)
                if aggregator is not None:
                    logger.log_dict(aggregator.compute(), policy_step)
                    aggregator.reset()
                logger.log_dict({"Params/replay_ratio": summary["gradient_steps"] / policy_step}, policy_step)
                log_timers(logger, policy_step, train_step - last_train, (policy_step - last_log) * action_repeat)
                last_train = train_step
            last_log = policy_step

        if (int(cfg.checkpoint.every) > 0 and policy_step - last_checkpoint >= int(cfg.checkpoint.every)) or (
            iter_num == total_iters and cfg.checkpoint.get("save_last", False)
        ):
            last_checkpoint = policy_step
            # in burst mode the trainer's state between two bursts (at most one burst stale, as in JAX)
            with trainer.train_lock if burst else contextlib.nullcontext():
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
                if hybrid:
                    ckpt_state["host_rng"] = host_generator.get_state()
                if cfg.buffer.checkpoint:
                    ckpt_state["rb"] = drb.state_dict(live=True).to_dict() if resident else rb.checkpoint_state_dict()
                path = os.path.join(ckpt_dir, f"ckpt_{policy_step}_0.ckpt")
                summary["checkpoint"] = str(manager.save(path, ckpt_state, step=policy_step, config=plain(cfg)))

    if burst:
        # the tail: Ratio has counted the remaining grants, so they run (as the JAX loop does)
        while staged or ema_backlog:
            flush_burst()
        trainer.close()
        take_burst_losses(wait=True)
        summary.update(bursts=bursts[0], burst_host_s=list(trainer.step_host_s), grad_chunk=grad_chunk,
                       stage_max=stage_max, train_every=train_every)
    if hybrid:
        summary["snapshot"] = {"pulls": snapshot.pulls, "polls": snapshot.polls, "bytes": snapshot.nbytes,
                               "host_version": snapshot.host_version}
    manager.close()
    read_losses()
    envs.close()
    if algo.get("run_test", True):
        summary["test_reward"], summary["test_steps"] = test(player, cfg, device)
    logger.close()
    env_s = sum(summary["env_s"])
    summary.update(
        policy_steps=policy_step,
        log_dir=log_dir,
        env_steps_per_s=summary["iterations"] * num_envs / (env_s + sum(summary["train_s"])) if env_s > 0 else None,
        replay=drb.metrics() if resident else None,
        rollbacks=sentinel.rollbacks,
        checkpoint_timings=manager.timings,
        **{"Fault/skipped_updates": sentinel.total_skipped, "Fault/env_restarts": envs.env_restarts},
    )
    return summary
