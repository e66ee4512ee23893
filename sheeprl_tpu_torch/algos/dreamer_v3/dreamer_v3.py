"""DreamerV3 coupled training (counterpart of
``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``: its host-sampled path and
its device-resident sequence ring).

Each gradient step, in the JAX package's order: the target-critic EMA, the
world-model update (reconstruction loss over a T-step dynamic rollout), the
actor update through an H-step imagination on the freshly updated world
model with ``Moments`` return normalisation, and the critic update against
the lambda-returns and the target critic. Each loss is differentiated with
respect to its own module's parameters only (``torch.autograd.grad``), as
JAX's ``value_and_grad`` over one parameter subtree does. A discrete actor
learns by REINFORCE on a graph-free imagination, a continuous one by
backpropagating through it; with ``algo.world_model.decoupled_rssm`` every
posterior comes from one pass over the observations.

The JAX package's ``lax.scan``s are Python loops here; the GRU gate chain
of every RSSM step and the two-hot heads run the hand-written CUDA kernels
on the card. Random draws come from an explicit ``torch.Generator``, or are
injected (:func:`draw_noise` gives their shapes), so a test can feed the
uniforms JAX's keys give.

Two replay tiers, chosen by ``buffer.device_resident`` (and the HBM budget):
the host's per-env buffers, sampled on the host and copied over per train
call; or the sequence ring in card memory
(:class:`~sheeprl_tpu_torch.replay.SequenceRingDriver`), where each env
step is one dispatch: the packed upload of the staged rows, their append by
the CUDA ``ragged_ring_scatter`` kernel, the window draws on the card and
the granted gradient steps. With ``buffer.checkpoint`` a checkpoint holds
the replay of its tier, as the JAX loop's does: the ring's snapshot, or the
host buffer's state with its generators. Either resumes on either tier.

On the host tier, with ``fault.sentinel.enabled`` (the default), each
gradient step is guarded as the JAX package's ``guard=True`` step is: when a
loss or gradient of the three updates is not finite, the four modules, the
three optimizers' states (step counts included) and ``Moments`` go back to
what they were before the target-critic EMA (a select on the device, no
host read), and the EMA cadence counts only the steps taken. The
:class:`~sheeprl_tpu_torch.fault.DivergenceSentinel` reads the skipped count
with the metrics once per train call. The resident tier stays unguarded, as
in the JAX package.

Under ``run --pod N`` (a ``torch.distributed`` group of N processes, one
device each) every rank steps its own envs and counts its own policy steps,
as the JAX loop counts one process's envs, and trains on
``per_rank_batch_size // N`` windows of its own host buffer or ring (a
batch that N does not divide raises JAX's ``ValueError``). The world-model,
actor and critic gradients are mean-reduced before their clipped steps, the
guard's verdict is the group's (it rides the critic's reduction), the
``Moments`` percentiles are taken over every rank's lambda-returns
(:func:`~sheeprl_tpu_torch.algos.dreamer_v3.utils.moments_update`) and the
metrics are the group's means. The ring's sampling gate is the group's. The
generators (the player's and the step noise's, the host buffer's and the
ring's) are re-seeded at the run's start, fresh or resumed, from (seed,
rank, start iteration) (``parallel/fabric.py:rank_seed``), where JAX folds
the rank into its key; at one process nothing is re-seeded. Rank 0 alone
logs, writes the config, runs the test episode and checkpoints, its replay
included; every rank resumes from that checkpoint. The hybrid player does
not run under a group (the CLI refuses it).

The run writes into its own directory (``utils.logger.get_log_dir``); the
host tier's per-env buffers are memmapped under its ``memmap_buffer/rank_<r>``
with ``buffer.memmap`` (the default). At ``metric.log_level`` 1 the JAX
loop's metrics go to ``metrics.jsonl`` every ``metric.log_every`` policy
steps: ``Rewards/rew_avg``, ``Game/ep_len_avg``, the ``Loss/*`` and
``State/*`` means (from the reads the loop already makes), on the ring
``Replay/*``, ``Params/replay_ratio`` and ``Time/sps_*``.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    Actor,
    WorldModel,
    action_dims,
    actor_dists,
    actor_sample,
    build_training_agent,
    sample_stochastic,
)
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import DreamerV3Agent, posterior_step
from sheeprl_tpu_torch.algos.ppo.ppo import last10, param_digest
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import (
    compute_lambda_values,
    init_moments,
    moments_update,
    patch_restarted_envs,
    prepare_obs,
    test,
)
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.data import EnvIndependentReplayBuffer
from sheeprl_tpu_torch.data.ring import build_burst_train_step, build_seq_train_step
from sheeprl_tpu_torch.distributions import (
    BernoulliSafeMode,
    Independent,
    MSEDistribution,
    OneHotCategorical,
    SymlogDistribution,
    TwoHotEncodingDistribution,
)
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import CheckpointManager, DivergenceSentinel, load_resume_state
from sheeprl_tpu_torch.ops.guard import StateGuard, finite_guard, guarded_select
from sheeprl_tpu_torch.optim import ClippedOptimizer, build_optimizer
from sheeprl_tpu_torch.parallel import pod as pod_runtime
from sheeprl_tpu_torch.parallel.comm import (
    all_reduce_mean,
    barrier,
    broadcast_flag,
    pmean_grads,
    pmean_grads_with_verdict,
)
from sheeprl_tpu_torch.parallel.fabric import global_rank, rank_seed, world_size
from sheeprl_tpu_torch.replay import (
    DeviceReplayState,
    SequenceRingDriver,
    resolve_device_resident,
    restore_host_env_buffer,
)
from sheeprl_tpu_torch.utils.burst import HybridPlayerHarness, dreamer_ring_keys
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric, build_aggregator
from sheeprl_tpu_torch.utils.profiler import TraceProfiler
from sheeprl_tpu_torch.utils.timer import log_timers, timer
from sheeprl_tpu_torch.utils.utils import Ratio, resolve_hybrid_player

__all__ = ["METRIC_NAMES", "Player", "draw_noise", "make_optimizers", "make_train_step", "main"]

METRIC_NAMES = (
    "Loss/world_model_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Loss/policy_loss",
    "Loss/value_loss",
)

_TINY = float(np.finfo(np.float32).tiny)


def _uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniforms in ``[tiny, 1)``, the interval ``jax.random.categorical``'s
    Gumbel noise is drawn from."""
    return torch.rand(shape, generator=generator, device=device).clamp_(min=_TINY)


def draw_noise(
    cfg: Any, seq_len: int, batch: int, actions_dim: Sequence[int], generator: Optional[torch.Generator], device,
    continuous: bool = False,
) -> Dict[str, Any]:
    """One gradient step's noise: ``posterior`` ``(T, B, S*D)`` for the
    dynamic rollout's posterior draws (with the decoupled RSSM, the one
    pass's), ``imagined_prior`` ``(H, T*B, S*D)`` for imagination's prior
    draws, and ``actions``, one ``(H+1, T*B, A_i)`` tensor of uniforms per
    discrete actor head, or for a ``continuous`` actor one ``(H+1, T*B,
    sum(actions_dim))`` tensor of standard normals (row 0 for the first
    imagined action)."""
    wm_cfg = cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    horizon = int(cfg.algo.horizon)
    rows = seq_len * batch
    noise = {
        "posterior": _uniform((seq_len, batch, stoch), generator, device),
        "imagined_prior": _uniform((horizon, rows, stoch), generator, device),
    }
    if continuous:
        noise["actions"] = [torch.randn((horizon + 1, rows, int(sum(actions_dim))), generator=generator, device=device)]
    else:
        noise["actions"] = [_uniform((horizon + 1, rows, int(d)), generator, device) for d in actions_dim]
    return noise


def make_optimizers(cfg: Any, world_model: WorldModel, actor: Actor, critic: torch.nn.Module) -> Dict[str, ClippedOptimizer]:
    algo = cfg.algo
    return {
        "world": build_optimizer(world_model.parameters(), algo.world_model.optimizer, algo.world_model.clip_gradients),
        "actor": build_optimizer(actor.parameters(), algo.actor.optimizer, algo.actor.clip_gradients),
        "critic": build_optimizer(critic.parameters(), algo.critic.optimizer, algo.critic.clip_gradients),
    }


def _grads(loss: torch.Tensor, params: List[torch.nn.Parameter]) -> List[torch.Tensor]:
    """d loss / d params; a parameter the loss does not reach gets zeros, as
    in JAX, so Adam still counts the step for it."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def make_train_step(
    world_model: WorldModel,
    actor: Actor,
    critic: torch.nn.Module,
    target_critic: torch.nn.Module,
    optimizers: Dict[str, ClippedOptimizer],
    cfg: Any,
    ring: Optional[Dict[str, Any]] = None,
    guard: bool = False,
) -> Callable:
    """The G-step update: ``train(data, moments_state, cum0, generator=None,
    noise=None) -> (moments_state, metrics, skipped)``. ``data`` holds ``(G, T, B,
    ...)`` float tensors on the modules' device (pixels in ``[0, 255]``);
    ``cum0`` counts the gradient steps taken before; ``noise`` is a list of G
    :func:`draw_noise` dicts, else the draws come from ``generator``. The
    modules and optimizers are updated in place; ``metrics`` is ``(G, 10)``
    in :data:`METRIC_NAMES` order; ``skipped`` is the 0-dim count of steps
    the guard undid (0 unguarded), on the device.

    ``guard=True`` (JAX ``guard=True``, host tier only): a step whose losses
    or gradients are not all finite leaves the modules, the optimizers'
    states and ``moments_state`` as they were before its target-critic EMA,
    and the step count that sets the EMA's cadence advances only over the
    steps taken.

    With a ``ring`` spec (:class:`~sheeprl_tpu_torch.replay.SequenceRingDriver`
    builds it), the same step body instead becomes the device ring's burst
    (:func:`~sheeprl_tpu_torch.data.ring.build_burst_train_step`) over the
    carry ``(moments_state, cum)``: ``burst(carry, rb, blob, generator=None,
    draws=None) -> (carry, rb, metrics)``, ``metrics`` the ``(10,)`` mean
    over the granted steps. With ``ring["decoupled"]`` (``dreamer_sebulba``)
    it becomes the append-free dispatch over the async ring
    (:func:`~sheeprl_tpu_torch.data.ring.build_seq_train_step`):
    ``(train_fn, ctl_layout)``, ``train_fn(carry, state, ctl, host_valid,
    generator=None, draws=None) -> (carry, metrics)``; guarded, each dispatch
    snapshots the train state first, and ``metrics`` ends in the skipped
    share of its steps (JAX's ``Fault/skipped_fraction``)."""
    wm_cfg = cfg.algo.world_model
    cnn_enc = list(cfg.algo.cnn_keys.encoder)
    mlp_enc = list(cfg.algo.mlp_keys.encoder)
    cnn_dec = list(cfg.algo.cnn_keys.get("decoder", cnn_enc))
    mlp_dec = list(cfg.algo.mlp_keys.get("decoder", mlp_enc))
    stochastic_size = int(wm_cfg.stochastic_size)
    discrete_size = int(wm_cfg.discrete_size)
    stoch_state_size = stochastic_size * discrete_size
    recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    horizon = int(cfg.algo.horizon)
    gamma = float(cfg.algo.gamma)
    lmbda = float(cfg.algo.lmbda)
    ent_coef = float(cfg.algo.actor.ent_coef)
    target_update_freq = int(cfg.algo.critic.per_rank_target_network_update_freq)
    tau = float(cfg.algo.critic.tau)
    moments_cfg = cfg.algo.actor.moments
    actions_dim = list(actor.actions_dim)
    continuous = actor.is_continuous
    wm_params = list(world_model.parameters())
    actor_params = list(actor.parameters())
    critic_params = list(critic.parameters())
    target_params = list(target_critic.parameters())
    state_guard = StateGuard(
        lambda: wm_params + actor_params + critic_params + target_params
        + [t for opt in optimizers.values() for t in opt.state_tensors()]
    ) if guard else None

    def grouped(logits: torch.Tensor) -> torch.Tensor:
        return logits.reshape(*logits.shape[:-1], stochastic_size, discrete_size)

    def imagine(posts, recs, true_continue, noise, moments_state):
        """Imagination from every posterior of the rollout and the policy
        loss. A discrete actor learns by REINFORCE: its imagined actions, the
        advantage and the discount are all stop-gradient in the JAX loss, so
        imagination and the value decode run without a graph and only the
        log-probs and entropies of the actor's distributions carry one. A
        continuous actor learns by dynamics backpropagation (``objective =
        advantage``): imagination keeps a graph, so the gradient runs from
        each rsampled action through the recurrent model (the GRU cell's
        backward), the straight-through prior draws, and the reward and
        critic heads' decode (its backward) into the lambda-returns. Either
        way the actor reads its input detached and the discount and the
        ``Moments`` quantiles are stop-gradient, as in the JAX loss. Returns
        the trajectory and the lambda-returns detached for the critic."""
        with torch.set_grad_enabled(continuous):
            rows = posts.shape[0] * posts.shape[1]
            prior = posts.detach().reshape(rows, stoch_state_size)
            rec = recs.detach().reshape(rows, recurrent_state_size)
            true_continue = true_continue.reshape(1, rows, 1)
            latent = torch.cat([prior, rec], dim=-1)
            heads = noise["actions"]
            act = torch.cat(actor_sample(actor, latent, [u[0] for u in heads])[0], dim=-1)
            trajectory, imagined = [latent], [act]
            for h in range(horizon):
                prior, rec = world_model.imagination(prior, rec, act, noise["imagined_prior"][h])
                latent = torch.cat([prior, rec], dim=-1)
                act = torch.cat(actor_sample(actor, latent.detach(), [u[h + 1] for u in heads])[0], dim=-1)
                trajectory.append(latent)
                imagined.append(act)
            traj = torch.stack(trajectory, dim=0)  # (H+1, T*B, L)
            values = TwoHotEncodingDistribution(critic(traj)).mean  # the critic before its update
            rewards = TwoHotEncodingDistribution(world_model.reward_model(traj)).mean
            with torch.no_grad():
                continues = Independent(BernoulliSafeMode(world_model.continue_model(traj)), 1).mode
                continues = torch.cat([true_continue, continues[1:]], dim=0)
                discount = torch.cumprod(continues * gamma, dim=0) / gamma
            lambda_values = compute_lambda_values(rewards[1:], values[1:], continues[1:] * gamma, lmbda)
            moments_state, offset, invscale = moments_update(
                moments_state,
                lambda_values,
                decay=float(moments_cfg.decay),
                max_=float(moments_cfg.max),
                percentile_low=float(moments_cfg.percentile.low),
                percentile_high=float(moments_cfg.percentile.high),
            )
            advantage = (lambda_values - offset) / invscale - (values[:-1] - offset) / invscale

        policies = actor_dists(actor, actor(traj.detach()))
        if continuous:
            objective = advantage
        else:
            act_parts = torch.split(torch.stack(imagined, dim=0), actions_dim, dim=-1)
            logprob = torch.stack([p.log_prob(a)[..., None][:-1] for p, a in zip(policies, act_parts)], dim=-1).sum(-1)
            objective = logprob * advantage
        try:
            entropy = ent_coef * torch.stack([p.entropy() for p in policies], dim=-1).sum(-1)
        except NotImplementedError:  # TanhNormal, as the JAX loss does
            entropy = torch.zeros(traj.shape[:-1], dtype=traj.dtype, device=traj.device)
        policy_loss = -torch.mean(discount[:-1] * (objective + entropy[..., None][:-1]))
        return moments_state, traj.detach(), lambda_values.detach(), discount, policy_loss

    def gradient_step(batch: Dict[str, torch.Tensor], moments_state, cum: "torch.Tensor | int",
                      noise: Dict[str, Any]):
        """One step; ``cum``, the steps taken before, is a 0-dim integer
        tensor (or a host int), so the EMA's cadence needs no host read.
        Returns ``(moments_state, metrics, ok)``, ``ok`` None unguarded."""
        old_moments = moments_state
        # -- target-critic EMA: a full copy at the first step, as JAX mixes it
        cum = torch.as_tensor(cum, dtype=torch.int64, device=batch["actions"].device)
        mix = torch.where(cum % target_update_freq == 0, torch.where(cum == 0, 1.0, tau), 0.0).to(torch.float32)
        with torch.no_grad():
            moved = torch._foreach_mul(critic_params, mix)
            torch._foreach_add_(moved, torch._foreach_mul(target_params, 1.0 - mix))
            torch._foreach_copy_(target_params, moved)

        batch_obs = {k: batch[k] / 255.0 - 0.5 for k in cnn_enc}
        batch_obs.update({k: batch[k] for k in mlp_enc})
        is_first = batch["is_first"].clone()
        is_first[0] = 1.0
        batch_actions = torch.cat([torch.zeros_like(batch["actions"][:1]), batch["actions"][:-1]], dim=0)
        T, B = batch["actions"].shape[:2]

        # -- world-model update
        embedded = world_model.encoder(batch_obs)
        rec = torch.zeros((B, recurrent_state_size), dtype=embedded.dtype, device=embedded.device)
        initial = world_model.get_initial_states(B)
        if world_model.decoupled:
            # every posterior from the observations alone, in one pass; the
            # recurrent rollout reads them shifted by one step
            post_logits = world_model.representation(None, embedded)
            posts = sample_stochastic(post_logits, world_model.discrete, noise["posterior"])
            posts_prev = torch.cat([torch.zeros_like(posts[:1]), posts[:-1]], dim=0)
            steps = []
            for t in range(T):
                rec, prior_logit = world_model.dynamic_decoupled(
                    posts_prev[t], rec, batch_actions[t], is_first[t], initial
                )
                steps.append((rec, prior_logit))
            recs, prior_logits = (torch.stack(x, dim=0) for x in zip(*steps))
        else:
            post = torch.zeros((B, stoch_state_size), dtype=embedded.dtype, device=embedded.device)
            steps = []
            for t in range(T):
                rec, post, post_logit, prior_logit = world_model.dynamic(
                    post, rec, batch_actions[t], embedded[t], is_first[t], noise["posterior"][t], initial
                )
                steps.append((rec, post, post_logit, prior_logit))
            recs, posts, post_logits, prior_logits = (torch.stack(x, dim=0) for x in zip(*steps))
        latents = torch.cat([posts, recs], dim=-1)
        recon = world_model.decode(latents)
        po = {k: MSEDistribution(recon[k], dims=3) for k in cnn_dec}
        po.update({k: SymlogDistribution(recon[k], dims=1) for k in mlp_dec})
        pr = TwoHotEncodingDistribution(world_model.reward_model(latents))
        pc = Independent(BernoulliSafeMode(world_model.continue_model(latents)), 1)
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
            po,
            batch_obs,
            pr,
            batch["rewards"],
            grouped(prior_logits),
            grouped(post_logits),
            float(wm_cfg.kl_dynamic),
            float(wm_cfg.kl_representation),
            float(wm_cfg.kl_free_nats),
            float(wm_cfg.kl_regularizer),
            pc,
            1 - batch["terminated"],
            float(wm_cfg.continue_scale_factor),
        )
        wm_grads = pmean_grads(_grads(rec_loss, wm_params))
        optimizers["world"].step(wm_grads)

        # -- behaviour learning on the updated world model
        moments_state, traj, lambda_values, discount, policy_loss = imagine(
            posts, recs, 1 - batch["terminated"], noise, moments_state
        )
        actor_grads = pmean_grads(_grads(policy_loss, actor_params))
        optimizers["actor"].step(actor_grads)

        # -- critic update, against the target critic after this step's EMA
        qv = TwoHotEncodingDistribution(critic(traj[:-1]))
        with torch.no_grad():
            target_values = TwoHotEncodingDistribution(target_critic(traj[:-1])).mean
        value_loss = torch.mean(
            (-qv.log_prob(lambda_values) - qv.log_prob(target_values)) * discount[:-1, ..., 0]
        )
        critic_grads = _grads(value_loss, critic_params)
        ok = None
        if guard:
            # the group's verdict rides the last reduction (JAX's pmin over dp)
            critic_grads, ok = pmean_grads_with_verdict(
                critic_grads, finite_guard([*wm_grads, *actor_grads, *critic_grads, rec_loss, policy_loss, value_loss]))
        else:
            critic_grads = pmean_grads(critic_grads)
        optimizers["critic"].step(critic_grads)
        if guard:
            state_guard.select(ok)
            keys = list(old_moments)
            moments_state = dict(zip(keys, guarded_select(
                ok, [moments_state[k] for k in keys], [old_moments[k] for k in keys])))

        with torch.no_grad():
            post_ent = Independent(OneHotCategorical(grouped(post_logits)), 1).entropy().mean()
            prior_ent = Independent(OneHotCategorical(grouped(prior_logits)), 1).entropy().mean()
            metrics = torch.stack([
                rec_loss, observation_loss, reward_loss, state_loss, continue_loss,
                kl, post_ent, prior_ent, policy_loss, value_loss,
            ]).detach()
        return moments_state, metrics, ok

    if ring is not None:
        seq_len, batch_size = int(ring["seq_len"]), int(ring["batch_size"])

        def carry_step(carry, xs):
            moments_state, cum = carry
            batch, noise = xs
            moments_state, metrics, ok = gradient_step(batch, moments_state, cum, noise)
            if ok is None:
                return (moments_state, cum + 1), metrics
            # a skipped step did not happen: the EMA's cadence keeps its phase
            return (moments_state, cum + ok.to(torch.int64)), torch.cat([metrics, (~ok).to(metrics.dtype)[None]])

        def noise_fn(gen):
            return draw_noise(cfg, seq_len, batch_size, actions_dim, gen, gen.device, continuous)

        if not ring.get("decoupled"):
            burst = build_burst_train_step(carry_step, ring, noise_fn)
            if world_size() == 1:
                return burst

            def group_burst(*args, **kwargs):
                # the granted steps' mean metrics, averaged over the group (JAX's pmean)
                carry, rb, metrics = burst(*args, **kwargs)
                return carry, rb, None if metrics is None else all_reduce_mean(metrics)

            return group_burst
        seq_train, ctl_layout = build_seq_train_step(carry_step, ring, noise_fn)
        if not guard:
            return seq_train, ctl_layout

        def guarded_seq_train(*args, **kwargs):
            state_guard.snapshot()  # the state a skipped step returns to
            return seq_train(*args, **kwargs)

        return guarded_seq_train, ctl_layout

    def train(
        data: Dict[str, torch.Tensor],
        moments_state: Dict[str, torch.Tensor],
        cum0: int,
        generator: Optional[torch.Generator] = None,
        noise: Optional[List[Dict[str, Any]]] = None,
    ):
        n_steps, T, B = data["actions"].shape[:3]
        device = data["actions"].device
        metrics = []
        cum = torch.tensor(int(cum0), dtype=torch.int64, device=device)
        skipped = torch.zeros((), dtype=torch.float32, device=device)
        if guard:
            state_guard.snapshot()
        for g in range(n_steps):
            step_noise = (
                noise[g] if noise is not None
                else draw_noise(cfg, T, B, actions_dim, generator, device, continuous)
            )
            moments_state, m, ok = gradient_step({k: v[g] for k, v in data.items()}, moments_state, cum, step_noise)
            metrics.append(m)
            if guard:  # a skipped step did not happen: the EMA's cadence keeps its phase
                cum = cum + ok.to(torch.int64)
                skipped += (~ok).to(torch.float32)
            else:
                cum = cum + 1
        # each step's metrics averaged over the group (JAX's pmean of the steps' mean)
        return moments_state, all_reduce_mean(torch.stack(metrics, dim=0)), skipped

    return train


class Player:
    """The env-side policy: per env the action carry (one-hot per head, or
    the continuous action), the recurrent state and the posterior sample,
    advanced by the serving session step's pieces
    (:func:`~sheeprl_tpu_torch.algos.dreamer_v3.evaluate.posterior_step`)
    with the posterior and the actions drawn from ``generator``."""

    def __init__(self, world_model: WorldModel, actor: Actor, num_envs: int, generator: torch.Generator) -> None:
        self.agent = DreamerV3Agent(world_model, actor)
        self.num_envs = int(num_envs)
        self.generator = generator
        self.actions = self.recurrent_state = self.stochastic_state = None

    @torch.no_grad()
    def init_states(self, reset_envs: Optional[Sequence[int]] = None) -> None:
        wm = self.agent.world_model
        if reset_envs is None or len(reset_envs) == 0:
            device = wm.initial_recurrent_state.device
            self.actions = torch.zeros((self.num_envs, sum(self.agent.actor.actions_dim)), device=device)
            rec, post = wm.get_initial_states(self.num_envs)
            self.recurrent_state, self.stochastic_state = rec.clone(), post  # rec is an expanded view
            return
        idx = torch.as_tensor(list(reset_envs), device=self.actions.device)
        rec, post = wm.get_initial_states(len(reset_envs))
        self.actions[idx] = 0.0
        self.recurrent_state[idx] = rec
        self.stochastic_state[idx] = post

    @torch.no_grad()
    def get_actions(self, obs: Dict[str, torch.Tensor], greedy: bool = False) -> List[torch.Tensor]:
        """One-hot actions per head, or the one continuous action tensor:
        sampled, or with ``greedy`` the actor's mode. The posterior is
        sampled in both modes, as the JAX player does."""
        wm, actor = self.agent.world_model, self.agent.actor
        device = self.actions.device
        rec, logits = posterior_step(self.agent, obs, self.actions, self.recurrent_state, self.stochastic_state)
        stoch = sample_stochastic(logits, wm.discrete, _uniform(logits.shape, self.generator, device))
        noise = None
        if not greedy and actor.is_continuous:
            noise = [torch.randn((self.num_envs, sum(actor.actions_dim)), generator=self.generator, device=device)]
        elif not greedy:
            noise = [_uniform((self.num_envs, d), self.generator, device) for d in actor.actions_dim]
        acts, _ = actor_sample(actor, torch.cat([stoch, rec], dim=-1), noise, greedy)
        self.actions = torch.cat(acts, dim=-1)
        self.recurrent_state, self.stochastic_state = rec, stoch
        return acts


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The coupled loop: step the envs with the player (random actions
    until ``learning_starts``), store every transition, take the gradient
    steps ``Ratio`` grants, and checkpoint. Host tier: the per-env buffers,
    windows sampled on the host. Resident tier (``buffer.device_resident``
    and a ring within ``buffer.hbm_budget_gb``): the sequence ring on the
    device, one dispatch per env step (append + granted steps), the ring
    checkpointed with ``buffer.checkpoint``. Returns a summary of the run
    (counters, each train call's metrics, timings, the replay tier, the last
    checkpoint's path), and with ``algo.run_test`` (on by default, as in the
    JAX package) the return and length of a test episode after the loop,
    whose draws leave the training generator untouched; on the host tier
    ``Fault/skipped_updates`` and the sentinel's rollbacks; the manager's
    save timings and ``Fault/env_restarts``."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    if 2 ** int(np.log2(cfg.env.screen_size)) != cfg.env.screen_size:
        raise ValueError(f"The screen size must be a power of 2, got: {cfg.env.screen_size}")
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    for kind, enc in (("cnn", cnn_keys), ("mlp", mlp_keys)):
        if set(cfg.algo[f"{kind}_keys"].get("decoder", enc)) - set(enc):
            raise RuntimeError(f"The {kind.upper()} keys of the decoder must be contained in the encoder ones")
    obs_keys = cnn_keys + mlp_keys
    num_envs = int(cfg.env.num_envs)
    seed = int(cfg.seed)
    rank, world = global_rank(), world_size()

    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir, rank)
    print(f"Log dir: {log_dir}", flush=True)
    envs = make_vector_env(cfg, seed, restart_on_exception=True, rank=rank)
    cfg["spaces"] = dotdict(envs.spaces)  # what serve reads off the run's config.json
    is_continuous, actions_dim = action_dims(cfg.spaces)
    if is_continuous:
        low = np.asarray(cfg.spaces.actions.low, np.float32)
        high = np.asarray(cfg.spaces.actions.high, np.float32)
    logger.log_hyperparams(cfg)
    if rank == 0:
        write_run_config(log_dir, plain(cfg))  # the run directory's config.json
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))

    world_model, actor, critic, target_critic = build_training_agent(cfg, device, state)
    optimizers = make_optimizers(cfg, world_model, actor, critic)
    moments_state = init_moments(device)
    if state is not None:
        for name, opt in optimizers.items():
            opt.load_state_dict(state["optimizers"][name])
        moments_state = {k: v.to(device) for k, v in state["moments"].items()}

    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)
    dry_run = bool(cfg.get("dry_run", False))
    buffer_size = int(cfg.buffer.size) // num_envs if not dry_run else 2
    rb = EnvIndependentReplayBuffer(buffer_size, num_envs, obs_keys, memmap=bool(cfg.buffer.get("memmap", False)),
                                    memmap_dir=os.path.join(log_dir, "memmap_buffer", f"rank_{rank}"),
                                    memmap_mode=str(cfg.buffer.get("memmap_mode", "r+")))
    rb.seed(seed)
    checkpoint_rb = bool(cfg.buffer.get("checkpoint", False))
    saved_rb = state.get("rb") if state is not None and checkpoint_rb else None

    start_iter = int(state["iter_num"]) + 1 if state is not None else 1
    policy_step = int(state["iter_num"]) * num_envs if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    last_log = int(state["last_log"]) if state is not None else 0
    total_iters = int(cfg.algo.total_steps) // num_envs if not dry_run else 1
    learning_starts = int(cfg.algo.get("learning_starts", 0)) // num_envs if not dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    if state is not None:
        cfg.algo["per_rank_batch_size"] = int(state["batch_size"])
        learning_starts += start_iter
        prefill_steps += start_iter
    ratio = Ratio(float(cfg.algo.replay_ratio), pretrain_steps=int(cfg.algo.per_rank_pretrain_steps))
    if state is not None:
        ratio.load_state_dict(state["ratio"])
    batch_size = int(cfg.algo.per_rank_batch_size)
    if batch_size % world != 0:
        raise ValueError(f"per_rank_batch_size ({batch_size}) must be divisible by the number of devices ({world})")
    local_batch = batch_size // world  # each rank trains on its share, drawn from its own data
    seq_len = int(cfg.algo.per_rank_sequence_length)
    log_level = int(cfg.metric.get("log_level", 1))
    log_every = int(cfg.metric.get("log_every", 5000))
    action_repeat = int(cfg.env.get("action_repeat", 1) or 1)
    train_step = resumed_train_steps = int(state.get("train_step", 0)) if state is not None else 0
    last_train = int(state.get("last_train", 0)) if state is not None else 0
    if log_level > 0 and log_every % num_envs != 0:
        warnings.warn(f"The metric.log_every parameter ({log_every}) is not a multiple of the "
                      f"policy_steps_per_iter value ({num_envs}).")
    if int(cfg.checkpoint.every) % num_envs != 0:
        warnings.warn(f"The checkpoint.every parameter ({cfg.checkpoint.every}) is not a multiple of the "
                      f"policy_steps_per_iter value ({num_envs}).")

    generator = torch.Generator(device=device).manual_seed(seed)
    if state is not None and state.get("rng") is not None:
        generator.set_state(state["rng"])
    action_rng = np.random.default_rng(seed)
    player = Player(world_model, actor, num_envs, generator)

    # the hybrid host player (JAX's default off the CPU): the policy on the
    # host CPU from a snapshot, the ring and the bursts on the card; it is
    # already device-resident and asynchronous, so it takes precedence over
    # the resident tier
    burst = resolve_hybrid_player(cfg.algo.get("hybrid_player"), device)
    # the device-resident sequence ring: pixels stay uint8 on the card,
    # windows are drawn there, one dispatch per env step
    ring_keys = dreamer_ring_keys(cfg.spaces.obs, cnn_keys, mlp_keys, actions_dim, with_is_first=True)
    resident = False
    if not burst:
        resident, reason = resolve_device_resident(
            cfg.buffer.get("device_resident", False), ring_keys, buffer_size, num_envs,
            float(cfg.buffer.get("hbm_budget_gb", 4.0)), sequence={"seq_len": seq_len, "batch_size": batch_size},
            world=world,
        )
        if log_level > 0 and cfg.buffer.get("device_resident", False):
            print(f"Replay: device_resident={resident} ({reason})", flush=True)
    # the host buffer: the storage tier, or with the hybrid player the
    # checkpoint's copy of the ring (kept only with buffer.checkpoint)
    host_mirror = (not burst and not resident) or (burst and checkpoint_rb)
    # the finite guard and its sentinel on the host tier only, as in the JAX package
    sentinel_cfg = (cfg.get("fault") or {}).get("sentinel") or {}
    guard = bool(sentinel_cfg.get("enabled", True)) and not resident and not burst
    sentinel = DivergenceSentinel(sentinel_cfg)
    # the saved replay, told apart by its content: a ring snapshot
    # (``DeviceReplayState``) or the host buffer's state
    restored: Any = None
    if saved_rb is not None and "kind" in saved_rb:
        restored = DeviceReplayState.from_dict(saved_rb)
        if not resident:  # a device-ring checkpoint resumed on the host tier keeps its experience
            restore_host_env_buffer(restored, rb, fill_missing={"truncated": ((1,), np.float32)})
    elif saved_rb is not None:
        rb.load_state_dict(saved_rb)
        restored = rb  # resumed on the ring: the host buffer is mirrored into it
    driver: Optional[SequenceRingDriver] = None
    hp: Optional[HybridPlayerHarness] = None
    act_player = player
    if burst:
        from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_sebulba import player_subset

        card_agent = player_subset(world_model, actor)
        host_agent = copy.deepcopy(card_agent).to("cpu")  # the host player's modules
        hp = HybridPlayerHarness(
            cfg, ring_keys=ring_keys, capacity=buffer_size, seq_len=seq_len, batch_size=batch_size,
            policy_steps_per_iter=num_envs,
            make_burst_fn=lambda ring: make_train_step(
                world_model, actor, critic, target_critic, optimizers, cfg, ring=ring
            ),
            player_card=[*card_agent.parameters(), *card_agent.buffers()],
            player_host=[*host_agent.parameters(), *host_agent.buffers()],
            carry=(moments_state, torch.zeros((), dtype=torch.int64, device=device)), device=device,
            train_modules=(world_model, actor, critic, target_critic), optimizers=list(optimizers.values()),
            rb=rb if saved_rb is not None else None, aggregator=aggregator,
        )
        if state is not None and state.get("host_rng") is not None:
            hp.host_generator.set_state(state["host_rng"])
        if state is not None and state.get("rng") is not None:
            hp.generator.set_state(state["rng"])
        act_player = Player(host_agent.world_model, host_agent.actor, num_envs, hp.host_generator)
    elif resident:
        driver = SequenceRingDriver(
            ring_keys, buffer_size, num_envs, seq_len, local_batch,
            grad_chunk=max(1, int(math.ceil(float(cfg.algo.replay_ratio) * num_envs))),
            make_burst_fn=lambda ring: make_train_step(
                world_model, actor, critic, target_critic, optimizers, cfg, ring=ring
            ),
            device=device, seed=seed + 31, restore=restored,
        )
    else:
        train_fn = make_train_step(world_model, actor, critic, target_critic, optimizers, cfg, guard=guard)

    if world > 1:
        # each rank's own draws from here on, whatever checkpoint it resumed
        # (every rank of a restarted pod reads rank 0's); the buffers keep their rows
        generator.manual_seed(rank_seed(seed, rank, start_iter))
        action_rng = np.random.default_rng([seed, rank])
        rb.seed(rank_seed(seed + 1, rank, start_iter))
        if resident:
            driver.generator.manual_seed(rank_seed(seed + 31, rank, start_iter))
    step_data: Dict[str, np.ndarray] = {}
    obs = envs.reset(seed=seed + rank * num_envs)[0]
    for k in obs_keys:
        step_data[k] = np.asarray(obs[k])[np.newaxis]
    for k in ("rewards", "truncated", "terminated"):
        step_data[k] = np.zeros((1, num_envs, 1), dtype=np.float32)
    step_data["is_first"] = np.ones_like(step_data["terminated"])
    act_player.init_states()

    summary: Dict[str, Any] = {"start_iter": start_iter, "metrics": [], "train_host_s": [], "checkpoint": None,
                               "device": str(device), "resident": resident, "dispatch_host_s": [],
                               "test_reward": None, "test_steps": None, "hybrid": burst, "act_host_s": [],
                               # the ring's heads as a resume mirrored them from the host buffer
                               "ring_restored": ([hp.runner.dev_pos.tolist(), hp.runner.dev_valid.tolist()]
                                                 if burst and saved_rb is not None else None),
                               "rank": rank, "world_size": world, "drained": False, "iterations": 0, "episodes": []}
    # this run's gradient steps: a resumed run starts again at 0, so its first
    # step copies the critic into the target critic, as the JAX loop does
    cum_gradient_steps = 0
    carry = (moments_state, torch.zeros((), dtype=torch.int64, device=device))  # the resident burst's carry
    pending: List[torch.Tensor] = []  # resident metrics still on the device

    def take_metrics(rows: List[List[float]]) -> None:
        """One train call's metrics read from the device, a row per step:
        into the summary and the printout, and their mean into the
        aggregator, once per call as the JAX loop updates it."""
        summary["metrics"].extend(rows)
        if aggregator is not None:
            for name, column in zip(METRIC_NAMES, zip(*rows)):
                aggregator.update(name, np.mean(column))
        if log_level > 0:
            for row in rows:
                print("train " + " ".join(f"{n.split('/')[-1]}={v:.6g}" for n, v in zip(METRIC_NAMES, row)), flush=True)

    def read_metrics() -> None:
        """The resident dispatches' pending metrics, one row each, in one copy."""
        if pending:
            rows = torch.stack(pending).cpu().tolist()
            pending.clear()
            for row in rows:
                take_metrics([row])

    def log_metrics() -> None:
        """The JAX loop's log point (at ``metric.log_level`` 1)."""
        if resident:
            logger.log_dict(driver.metrics(), policy_step)
        if aggregator is not None:
            logger.log_dict(aggregator.compute(), policy_step)
            aggregator.reset()
        logger.log_dict({"Params/replay_ratio": cum_gradient_steps / policy_step}, policy_step)
        log_timers(logger, policy_step, train_step - last_train, (policy_step - last_log) * action_repeat)

    player_steps = 0
    env_s = 0.0
    profiler = TraceProfiler(cfg.metric.get("profiler"), log_dir, device)
    t_loop = time.perf_counter()
    for iter_num in range(start_iter, total_iters + 1):
        profiler.tick(iter_num)
        policy_step += num_envs
        if burst:
            hp.poll()  # the newest snapshot that has landed
        t_env = time.perf_counter()
        # the player's forward is inside: the copy of its actions to the host waits for the card
        with timer("Time/env_interaction_time", SumMetric):
            if iter_num <= learning_starts and state is None and is_continuous:
                # uniform in the Box, as the JAX loop's action_space.sample() draws
                actions = action_rng.uniform(low, high, size=(num_envs, len(low))).astype(np.float32)
                real_actions = actions
            elif iter_num <= learning_starts and state is None:
                real_actions = action_rng.integers(0, actions_dim, size=(num_envs, len(actions_dim)))
                actions = np.concatenate(
                    [np.eye(d, dtype=np.float32)[real_actions[:, i]] for i, d in enumerate(actions_dim)], axis=-1
                )
            else:
                prepared = prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys=cnn_keys, num_envs=num_envs)
                t_act, busy = time.perf_counter(), burst and hp.trainer.busy
                # the hybrid player acts on the host CPU: nothing goes to the card
                act_device = "cpu" if burst else device
                acts = act_player.get_actions({k: torch.from_numpy(v).to(act_device) for k, v in prepared.items()})
                if burst:
                    summary["act_host_s"].append((time.perf_counter() - t_act, busy or hp.trainer.busy))
                player_steps += 1
                actions = torch.cat(acts, dim=-1).float().cpu().numpy()
                # a continuous action goes to the env as it is; a discrete head as its index
                real_actions = actions if is_continuous else np.stack([a.argmax(dim=-1).cpu().numpy() for a in acts],
                                                                      axis=-1)

            step_data["actions"] = actions.reshape(1, num_envs, -1)
            if resident:
                driver.stage_step(step_data)  # the device ring is the only storage tier
            if host_mirror:
                rb.add(step_data, validate_args=cfg.buffer.get("validate_args", False))
            if burst:
                hp.stage_step(step_data)
            next_obs, rewards, terminated, truncated, infos = envs.step(real_actions)
        dones = np.logical_or(terminated, truncated)
        env_s += time.perf_counter() - t_env

        step_data["is_first"] = np.zeros_like(step_data["terminated"])
        if "restart_on_exception" in infos:
            patch_restarted_envs(infos["restart_on_exception"], dones, step_data,
                                 rb=rb if host_mirror else None, driver=driver if resident else hp)
        for i, ep_rew, ep_len in infos.get("episodes", ()):
            summary["episodes"].append((policy_step, i, ep_rew, ep_len))
        if log_level > 0:
            for i, ep_rew, ep_len in infos.get("episodes", ()):
                if aggregator is not None:
                    aggregator.update("Rewards/rew_avg", ep_rew)
                    aggregator.update("Game/ep_len_avg", ep_len)
                print(f"{f'Rank-{rank}: ' if world > 1 else ''}policy_step={policy_step}, reward_env_{i}={ep_rew}, "
                      f"length={ep_len}", flush=True)

        real_next_obs = {k: np.asarray(next_obs[k]).copy() for k in obs_keys}
        for idx, final in enumerate(infos.get("final_obs", ())):
            if final is not None:
                for k in obs_keys:
                    real_next_obs[k][idx] = final[k]
        for k in obs_keys:
            step_data[k] = np.asarray(next_obs[k])[np.newaxis]
        obs = next_obs

        rewards = np.asarray(rewards, dtype=np.float32).reshape(1, num_envs, -1)
        step_data["terminated"] = np.asarray(terminated, dtype=np.float32).reshape(1, num_envs, -1)
        step_data["truncated"] = np.asarray(truncated, dtype=np.float32).reshape(1, num_envs, -1)
        step_data["rewards"] = np.tanh(rewards) if cfg.env.get("clip_rewards", False) else rewards

        dones_idxes = dones.nonzero()[0].tolist()
        if dones_idxes:
            # the episode's last observation, then the reset one starts the next
            reset_data = {k: real_next_obs[k][dones_idxes][np.newaxis] for k in obs_keys}
            reset_data["terminated"] = step_data["terminated"][:, dones_idxes]
            reset_data["truncated"] = step_data["truncated"][:, dones_idxes]
            reset_data["actions"] = np.zeros((1, len(dones_idxes), int(np.sum(actions_dim))), dtype=np.float32)
            reset_data["rewards"] = step_data["rewards"][:, dones_idxes]
            reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
            if resident:
                driver.stage_reset(reset_data, dones_idxes)
            if host_mirror:
                rb.add(reset_data, dones_idxes, validate_args=cfg.buffer.get("validate_args", False))
            if burst:
                hp.stage_reset(reset_data, dones_idxes)
            step_data["rewards"][:, dones_idxes] = 0.0
            step_data["terminated"][:, dones_idxes] = 0.0
            step_data["truncated"][:, dones_idxes] = 0.0
            step_data["is_first"][:, dones_idxes] = 1.0
            act_player.init_states(dones_idxes)

        if burst:
            if iter_num >= learning_starts:
                hp.grant(ratio(policy_step - prefill_steps * num_envs))
            # the flushes are handed to the trainer thread; the env loop never waits on the card
            hp.pump()
            cum_gradient_steps, train_step = hp.gradient_steps, resumed_train_steps + hp.train_steps
        elif resident:
            if iter_num >= learning_starts:
                driver.grant(ratio(policy_step - prefill_steps * num_envs))
            # ONE append + sample + train dispatch per env step (plus
            # append-free drains while a full grant chunk is backlogged)
            t0 = time.perf_counter()
            before = driver.gradient_steps
            # the dispatch's enqueue: its metrics stay on the card until the log point
            with timer("Time/train_time", SumMetric):
                carry, metrics = driver.pump(carry)
            summary["dispatch_host_s"].append((time.perf_counter() - t0, driver.gradient_steps - before))
            if metrics is not None:
                pending.append(metrics)
            moments_state, cum_gradient_steps = carry[0], driver.gradient_steps
            train_step = resumed_train_steps + driver.train_steps
            if policy_step - last_log >= log_every or iter_num == total_iters:
                read_metrics()
                if log_level > 0:
                    log_metrics()
                    last_train = train_step
                last_log = policy_step
        elif iter_num >= learning_starts:
            gradient_steps = ratio(policy_step - prefill_steps * num_envs)
            if gradient_steps > 0:
                t0 = time.perf_counter()
                with timer("Time/replay_path_time", SumMetric):
                    sample = rb.sample(local_batch, sequence_length=seq_len, n_samples=gradient_steps)
                    data = {k: torch.from_numpy(v).to(device).float() for k, v in sample.items()}
                # the metrics' one read waits for the card: the timer holds the steps' device time
                with timer("Time/train_time", SumMetric):
                    moments_state, metrics, skipped = train_fn(data, moments_state, cum_gradient_steps, generator)
                    # the skipped count rides the metrics' one read, which also waits for the device
                    rows = torch.cat([metrics, skipped.expand(metrics.shape[0], 1)], dim=1).cpu().tolist()
                summary["train_host_s"].append((time.perf_counter() - t0, gradient_steps))
                cum_gradient_steps += gradient_steps
                train_step += 1
                skipped = rows[0][-1]
                take_metrics([row[:-1] for row in rows])
                if guard and sentinel.observe(skipped):
                    def rollback(good: Dict[str, Any]) -> None:
                        nonlocal moments_state
                        for module, name in ((world_model, "world_model"), (actor, "actor"), (critic, "critic"),
                                             (target_critic, "target_critic")):
                            module.load_state_dict(good[name])
                        for name, opt in optimizers.items():
                            opt.load_state_dict(good["optimizers"][name])
                        moments_state = {k: v.to(device) for k, v in good["moments"].items()}
                        if good.get("rng") is not None:
                            generator.set_state(good["rng"])

                    manager.wait()  # the newest save must be published before the rollback looks for it
                    barrier()  # ... rank 0's, before any rank looks
                    sentinel.recover(ckpt_dir, rollback)
        if not resident and log_level > 0 and (policy_step - last_log >= log_every or iter_num == total_iters):
            log_metrics()
            last_log, last_train = policy_step, train_step

        summary["iterations"] += 1
        # the pod's heartbeat, and rank 0's drain flag on every rank
        pod_runtime.beat_step(policy_step)
        drain_now = broadcast_flag(pod_runtime.drain_requested())
        if (int(cfg.checkpoint.every) > 0 and policy_step - last_checkpoint >= int(cfg.checkpoint.every)) or (
            iter_num == total_iters and cfg.checkpoint.get("save_last", False)
        ) or drain_now:
            last_checkpoint = policy_step
            # with the hybrid player, the trainer's state between two bursts
            # (at most one burst stale, as in the JAX package)
            with hp.trainer.train_lock if burst else contextlib.nullcontext():
                if burst:
                    moments_state = hp.carry[0]
                ckpt_state = {
                    "world_model": world_model.state_dict(),
                    "actor": actor.state_dict(),
                    "critic": critic.state_dict(),
                    "target_critic": target_critic.state_dict(),
                    "optimizers": {name: opt.state_dict() for name, opt in optimizers.items()},
                    "moments": moments_state,
                    "ratio": ratio.state_dict(),
                    "iter_num": iter_num,
                    "batch_size": batch_size,
                    "last_log": last_log,
                    "last_checkpoint": last_checkpoint,
                    "train_step": train_step,
                    "last_train": last_train,
                    "rng": (hp.generator if burst else generator).get_state(),
                }
                if burst:
                    ckpt_state["host_rng"] = hp.host_generator.get_state()
                if checkpoint_rb and rank == 0:
                    # the ring, its heads and its generator; or the host buffer and its generators
                    ckpt_state["rb"] = (driver.state_dict(live=True).to_dict() if resident
                                        else rb.checkpoint_state_dict())
                if rank == 0:  # rank 0 alone writes, its buffer included (JAX CheckpointCallback._save)
                    path = os.path.join(ckpt_dir, f"ckpt_{policy_step}_0.ckpt")
                    summary["checkpoint"] = str(manager.save(path, ckpt_state, step=policy_step, config=plain(cfg)))
        if drain_now:
            print(f"Rank-{rank}: drain requested — checkpointed at policy_step={policy_step}, exiting", flush=True)
            summary["drained"] = True
            break

    if burst:
        # the tail: grants that can never run (an env still shorter than a window) go with the run
        moments_state, _ = hp.finish()
        cum_gradient_steps, train_step = hp.gradient_steps, resumed_train_steps + hp.train_steps
        summary.update(
            metrics=list(hp.metric_rows), bursts=hp.runner.bursts, burst_host_s=list(hp.trainer.step_host_s),
            flush_host_s=list(hp.flush_host_s), snapshot_age=hp.snapshot_age,
            snapshot={"pulls": hp.snapshot.pulls, "polls": hp.snapshot.polls, "bytes": hp.snapshot.nbytes},
            grad_chunk=hp.grad_chunk, replay={"Replay/flushes": hp.runner.flushes,
                                              "Replay/bytes_staged": hp.runner.bytes_staged},
        )
    profiler.close(total_iters + 1)
    manager.close()
    read_metrics()
    loop_s = time.perf_counter() - t_loop
    envs.close()
    if cfg.algo.get("run_test", True) and rank == 0:
        summary["test_reward"], summary["test_steps"] = test(player.agent, cfg, device, greedy=False)
    logger.close()
    steps = policy_step - (start_iter - 1) * num_envs
    summary.update(
        policy_steps=policy_step,
        log_dir=log_dir,
        player_steps=player_steps,
        gradient_steps=cum_gradient_steps,
        env_steps_per_s=steps / env_s if env_s > 0 else None,
        loop_steps_per_s=steps / loop_s if loop_s > 0 else None,
        train_calls=driver.train_steps if resident else (hp.train_steps if burst else len(summary["train_host_s"])),
        replay=driver.metrics() if resident else summary.get("replay"),
        rollbacks=sentinel.rollbacks,
        checkpoint_timings=manager.timings,
        profiler=profiler.trace_path,
        last10=last10(summary["episodes"]),
        param_digest=(param_digest(torch.nn.ModuleList([world_model, actor, critic, target_critic]))
                      if world > 1 else None),
        **{"Fault/skipped_updates": sentinel.total_skipped, "Fault/env_restarts": envs.env_restarts},
    )
    return summary
