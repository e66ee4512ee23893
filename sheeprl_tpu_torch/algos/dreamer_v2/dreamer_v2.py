"""Dreamer V2 coupled training (counterpart of
``sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py``, its host-buffer path).

Each gradient step, in the JAX package's order (arXiv:2010.02193):

1. the hard target-critic copy, every ``critic.per_rank_target_network_update_freq``
   gradient steps counted from the run's first (so the first step copies);
2. the world-model update: pixels mapped to ``/255 - 0.5``, ``is_first``
   set on the first row, the buffer's actions fed unshifted (row ``t`` holds
   the observation after ``a_t``), a T-step dynamic rollout whose
   ``is_first`` rows zero the carried state, and the reconstruction loss
   (unit-variance Normal likelihoods, KL balancing with free nats, the
   optional continue head);
3. the actor through an H-step imagination from every posterior of the
   rollout on the freshly updated world model (action slot 0 the zero
   action), lambda-returns on the target critic with its bootstrap row, the
   objective ``objective_mix * REINFORCE + (1 - objective_mix) * dynamics``
   and the entropy bonus (zero for ``tanh_normal``);
4. the critic's unit-variance Normal log-likelihood of the lambda-returns,
   weighted by the discount.

Each loss is differentiated with respect to its own module's parameters
only (``torch.autograd.grad``). A discrete actor at ``objective_mix`` 1
learns by REINFORCE alone, so its imagination runs without a graph (the
dynamics term's gradient is multiplied by zero in JAX); otherwise, and for
every continuous actor, imagination keeps a graph and the actor's gradient
runs back through the imagined RSSM steps (``gru_gates_ln``'s plain
backward chain). Every RSSM step's LayerNorm and gates are one
``gru_gates_ln`` launch on the card. Random draws come from an explicit
``torch.Generator`` or are injected (:func:`draw_noise` gives their shapes).

The loop (:func:`run_loop`, which the Plan2Explore-on-V2 loops share) keeps
the JAX loop's host tier: ``buffer.type`` ``sequential`` (per-env
:class:`~sheeprl_tpu_torch.data.SequentialReplayBuffer`) or ``episode``
(:class:`~sheeprl_tpu_torch.data.EpisodeBuffer`); ``Ratio`` with
``per_rank_pretrain_steps``; the JAX loop's rows (the first observation
with ``is_first``, then each observation after its action, and a reset row
for each env that just finished). It runs unguarded, as the JAX V2 loop
does. With the hybrid host player (``algo.hybrid_player``, JAX's default on
the card) the player acts on the host CPU, the rows stream to a sequence
ring on the card (the episode buffer through the ring's episode rule) and a
trainer thread takes the granted steps in bursts (:func:`make_train_step`'s
``ring`` variant, :class:`~sheeprl_tpu_torch.utils.burst.HybridPlayerHarness`).
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    Actor,
    PlayerDV2,
    WorldModel,
    _uniform,
    actor_dists,
    actor_sample,
    build_agent,
    player_subset,
)
from sheeprl_tpu_torch.algos.dreamer_v2.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v2.utils import compute_lambda_values, prepare_obs, test
from sheeprl_tpu_torch.algos.dreamer_v3.agent import action_dims
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES, _grads
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.data import EnvIndependentReplayBuffer, EpisodeBuffer
from sheeprl_tpu_torch.data.ring import build_burst_train_step
from sheeprl_tpu_torch.distributions import BernoulliSafeMode, Independent, Normal, OneHotCategorical
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import CheckpointManager, load_resume_state
from sheeprl_tpu_torch.optim import ClippedOptimizer, build_optimizer
from sheeprl_tpu_torch.utils.burst import HybridPlayerHarness, dreamer_ring_keys
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric, build_aggregator
from sheeprl_tpu_torch.utils.timer import log_timers, timer
from sheeprl_tpu_torch.utils.utils import Ratio, resolve_hybrid_player

__all__ = [
    "METRIC_NAMES",
    "draw_noise",
    "draw_imagination_noise",
    "make_optimizers",
    "make_train_step",
    "world_model_step",
    "imagine",
    "behaviour_step",
    "make_buffer",
    "buffer_digest",
    "run_loop",
    "main",
]


def draw_imagination_noise(cfg: Any, rows: int, actor: Actor, generator: Optional[torch.Generator],
                           device) -> Dict[str, Any]:
    """One imagination's noise: ``imagined_prior`` ``(H, rows, S*D)`` and
    ``actions``, per discrete head ``(H, rows, A_i)`` uniforms, or for a
    continuous actor one ``(H, rows, sum(actions_dim))`` tensor of uniforms
    (``trunc_normal``) or standard normals."""
    wm_cfg = cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    horizon = int(cfg.algo.horizon)
    noise: Dict[str, Any] = {"imagined_prior": _uniform((horizon, rows, stoch), generator, device)}
    if not actor.is_continuous:
        noise["actions"] = [_uniform((horizon, rows, d), generator, device) for d in actor.actions_dim]
    elif actor.noise_kind == "normal":
        noise["actions"] = [torch.randn((horizon, rows, sum(actor.actions_dim)), generator=generator, device=device)]
    else:
        noise["actions"] = [torch.rand((horizon, rows, sum(actor.actions_dim)), generator=generator, device=device)]
    return noise


def draw_noise(cfg: Any, seq_len: int, batch: int, actor: Actor, generator: Optional[torch.Generator],
               device) -> Dict[str, Any]:
    """One gradient step's noise: ``posterior`` ``(T, B, S*D)`` for the
    dynamic rollout's posterior draws and the imagination's
    (:func:`draw_imagination_noise`, over ``T * B`` rows)."""
    wm_cfg = cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    return {"posterior": _uniform((seq_len, batch, stoch), generator, device),
            **draw_imagination_noise(cfg, seq_len * batch, actor, generator, device)}


def make_optimizers(cfg: Any, world_model: WorldModel, actor: Actor, critic: torch.nn.Module
                    ) -> Dict[str, ClippedOptimizer]:
    algo = cfg.algo
    return {
        "world": build_optimizer(world_model.parameters(), algo.world_model.optimizer, algo.world_model.clip_gradients),
        "actor": build_optimizer(actor.parameters(), algo.actor.optimizer, algo.actor.clip_gradients),
        "critic": build_optimizer(critic.parameters(), algo.critic.optimizer, algo.critic.clip_gradients),
    }


def hard_copy(pairs: List[tuple], cum: int, freq: int) -> None:
    """The targets' hard copy at ``cum % freq == 0``: JAX mixes ``1 * online
    + 0 * target`` there, which is the copy."""
    if cum % freq == 0:
        with torch.no_grad():
            for online, target in pairs:
                torch._foreach_copy_(target, online)


def world_model_step(world_model: WorldModel, optimizer: ClippedOptimizer, cfg: Any, batch: Dict[str, torch.Tensor],
                     posterior_noise: torch.Tensor, detach_heads: bool = False):
    """The world-model update of one gradient step (``detach_heads``: the
    reward and continue heads read stop-gradient latents, as Plan2Explore's
    do). Returns ``(posts, recs, post_logits, prior_logits, losses)``, the
    rollout's states detached and ``losses`` the reconstruction loss's six
    terms."""
    wm_cfg = cfg.algo.world_model
    cnn_enc = list(cfg.algo.cnn_keys.encoder)
    mlp_enc = list(cfg.algo.mlp_keys.encoder)
    cnn_dec = list(cfg.algo.cnn_keys.get("decoder", cnn_enc))
    mlp_dec = list(cfg.algo.mlp_keys.get("decoder", mlp_enc))
    S, D = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    gamma = float(cfg.algo.gamma)
    batch_obs = {k: batch[k] / 255.0 - 0.5 for k in cnn_enc}
    batch_obs.update({k: batch[k] for k in mlp_enc})
    is_first = batch["is_first"].clone()
    is_first[0] = 1.0
    actions = batch["actions"]  # unshifted: row t holds the observation after a_t
    T, B = actions.shape[:2]
    embedded = world_model.encoder(batch_obs)
    rec = torch.zeros((B, world_model.recurrent_model.rnn.hidden_size), device=embedded.device)
    post = torch.zeros((B, S * D), device=embedded.device)
    steps = []
    for t in range(T):
        rec, post, post_logit, prior_logit = world_model.dynamic(post, rec, actions[t], embedded[t], is_first[t],
                                                                 posterior_noise[t])
        steps.append((rec, post, post_logit, prior_logit))
    recs, posts, post_logits, prior_logits = (torch.stack(x, dim=0) for x in zip(*steps))
    latents = torch.cat([posts, recs], dim=-1)
    recon = world_model.decode(latents)
    po = {k: Independent(Normal(recon[k], 1.0), 3) for k in cnn_dec}
    po.update({k: Independent(Normal(recon[k], 1.0), 1) for k in mlp_dec})
    heads_in = latents.detach() if detach_heads else latents
    pr = Independent(Normal(world_model.reward_model(heads_in), 1.0), 1)
    pc = continue_targets = None
    if world_model.continue_model is not None:
        pc = Independent(BernoulliSafeMode(world_model.continue_model(heads_in)), 1)
        continue_targets = (1 - batch["terminated"]) * gamma
    losses = reconstruction_loss(
        po, batch_obs, pr, batch["rewards"],
        prior_logits.reshape(*prior_logits.shape[:-1], S, D), post_logits.reshape(*post_logits.shape[:-1], S, D),
        float(wm_cfg.kl_balancing_alpha), float(wm_cfg.kl_free_nats), bool(wm_cfg.kl_free_avg),
        float(wm_cfg.kl_regularizer), pc, continue_targets, float(wm_cfg.discount_scale_factor),
    )
    optimizer.step(_grads(losses[0], list(world_model.parameters())))
    return posts.detach(), recs.detach(), post_logits.detach(), prior_logits.detach(), losses


def imagine(world_model: WorldModel, actor: Actor, prior: torch.Tensor, rec: torch.Tensor, noise: Dict[str, Any]):
    """H imagination steps from ``(prior, rec)`` (``(rows, .)``, detached):
    at each step the actor acts on the detached latent, then the RSSM
    advances. Returns the ``(H + 1, rows, L)`` latents (the start first) and
    the ``(H + 1, rows, A)`` actions with the zero action in slot 0."""
    trajectory, acts = [torch.cat([prior, rec], dim=-1)], []
    for h in range(noise["imagined_prior"].shape[0]):
        act = torch.cat(actor_sample(actor, trajectory[-1].detach(), [u[h] for u in noise["actions"]])[0], dim=-1)
        prior, rec = world_model.imagination(prior, rec, act, noise["imagined_prior"][h])
        trajectory.append(torch.cat([prior, rec], dim=-1))
        acts.append(act)
    imagined = torch.stack([torch.zeros_like(acts[0])] + acts, dim=0)
    return torch.stack(trajectory, dim=0), imagined


def policy_loss(actor: Actor, traj: torch.Tensor, imagined: torch.Tensor, lambda_values: torch.Tensor,
                baseline: torch.Tensor, discount: torch.Tensor, objective_mix: float, ent_coef: float) -> torch.Tensor:
    """``-mean(discount * (mix * log_prob * advantage + (1 - mix) * dynamics
    + entropy))`` over the first H - 1 imagined states, the advantage the
    lambda-return less the ``baseline`` value, stop-gradient."""
    policies = actor_dists(actor, actor(traj[:-2].detach()))
    dynamics = lambda_values[1:]
    advantage = (lambda_values[1:] - baseline[:-2]).detach()
    if actor.is_continuous:
        logprob = policies[0].log_prob(imagined[1:-1].detach())[..., None]
    else:
        parts = torch.split(imagined.detach(), list(actor.actions_dim), dim=-1)
        logprob = torch.stack([p.log_prob(a[1:-1])[..., None] for p, a in zip(policies, parts)], dim=-1).sum(-1)
    objective = objective_mix * (logprob * advantage) + (1 - objective_mix) * dynamics
    try:
        entropy = ent_coef * torch.stack([p.entropy() for p in policies], dim=-1).sum(-1)
    except NotImplementedError:  # TanhNormal, as the JAX loss does
        entropy = torch.zeros(objective.shape[:-1], dtype=objective.dtype, device=objective.device)
    return -torch.mean(discount[:-2] * (objective + entropy[..., None]))


def critic_step(critic: torch.nn.Module, optimizer: ClippedOptimizer, traj: torch.Tensor,
                lambda_values: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    """The critic's discount-weighted unit-variance Normal negative
    log-likelihood of the lambda-returns, and its update."""
    qv = Independent(Normal(critic(traj[:-1]), 1.0), 1)
    value_loss = -torch.mean(discount[:-1, ..., 0] * qv.log_prob(lambda_values))
    optimizer.step(_grads(value_loss, list(critic.parameters())))
    return value_loss


def behaviour_step(world_model: WorldModel, actor: Actor, target_critic: torch.nn.Module, reward_fn: Callable,
                   prior0: torch.Tensor, rec0: torch.Tensor, true_continue: torch.Tensor, noise: Dict[str, Any],
                   cfg: Any):
    """One imagination and its actor loss: the lambda-returns of
    ``reward_fn(traj, imagined)`` on ``target_critic``'s values (bootstrap
    from the last), the continues from the continue head (the first row the
    batch's ``true_continue``) or ``gamma``, the discount their cumulative
    product. The imagination keeps a graph for a continuous actor or an
    ``objective_mix`` below 1. Returns ``(policy_loss, traj, lambda_values,
    discount, reward)``, all but the loss detached."""
    gamma, lmbda = float(cfg.algo.gamma), float(cfg.algo.lmbda)
    objective_mix = float(cfg.algo.actor.objective_mix)
    graph = actor.is_continuous or objective_mix < 1.0
    with torch.set_grad_enabled(graph):
        traj, imagined = imagine(world_model, actor, prior0, rec0, noise)
        target_values = target_critic(traj)
        rewards = reward_fn(traj, imagined)
        if world_model.continue_model is not None:
            continues = torch.sigmoid(world_model.continue_model(traj))
            continues = torch.cat([true_continue, continues[1:]], dim=0)
        else:
            continues = torch.ones_like(rewards) * gamma
        lambda_values = compute_lambda_values(rewards[:-1], target_values[:-1], continues[:-1],
                                              bootstrap=target_values[-1:], lmbda=lmbda)
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]], dim=0), dim=0).detach()
    loss = policy_loss(actor, traj, imagined, lambda_values, target_values, discount, objective_mix,
                       float(cfg.algo.actor.ent_coef))
    return loss, traj.detach(), lambda_values.detach(), discount, rewards.detach()


def state_entropies(cfg: Any, post_logits: torch.Tensor, prior_logits: torch.Tensor) -> tuple:
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    with torch.no_grad():
        return tuple(Independent(OneHotCategorical(x.reshape(*x.shape[:-1], S, D)), 1).entropy().mean()
                     for x in (post_logits, prior_logits))


def make_train_step(world_model: WorldModel, actor: Actor, critic: torch.nn.Module, target_critic: torch.nn.Module,
                    optimizers: Dict[str, ClippedOptimizer], cfg: Any, ring: Optional[Dict[str, Any]] = None
                    ) -> Callable:
    """The G-step update: ``train(data, cum0, generator=None, noise=None) ->
    metrics``. ``data`` holds ``(G, T, B, ...)`` float tensors on the
    modules' device (pixels in ``[0, 255]``); ``cum0`` counts the run's
    gradient steps before the call (the target copy's phase); ``noise`` is a
    list of G :func:`draw_noise` dicts, else the draws come from
    ``generator``. The modules and optimizers are updated in place;
    ``metrics`` is ``(G, 10)`` in :data:`METRIC_NAMES` order.

    With ``ring`` (the hybrid player's ring spec) the same step body becomes
    the ring's burst (:func:`~sheeprl_tpu_torch.data.ring.build_burst_train_step`)
    over the carry ``(cum,)``, the gradient steps taken since the run
    started, so a burst that straddles a hard target copy copies at the
    step the coupled loop copies at: ``burst(carry, rb, blob, generator=None,
    draws=None) -> (carry, rb, metrics)``."""
    freq = int(cfg.algo.critic.per_rank_target_network_update_freq)
    gamma = float(cfg.algo.gamma)
    pairs = [(list(critic.parameters()), list(target_critic.parameters()))]

    def gradient_step(batch: Dict[str, torch.Tensor], cum: int, noise: Dict[str, Any]) -> torch.Tensor:
        hard_copy(pairs, cum, freq)
        posts, recs, post_logits, prior_logits, losses = world_model_step(
            world_model, optimizers["world"], cfg, batch, noise["posterior"])
        T, B = posts.shape[:2]
        true_continue = (1 - batch["terminated"]).reshape(1, T * B, 1) * gamma
        loss, traj, lambda_values, discount, _ = behaviour_step(
            world_model, actor, target_critic, lambda traj, _: world_model.reward_model(traj),
            posts.reshape(T * B, -1), recs.reshape(T * B, -1), true_continue, noise, cfg)
        optimizers["actor"].step(_grads(loss, list(actor.parameters())))
        value_loss = critic_step(critic, optimizers["critic"], traj, lambda_values, discount)
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        post_ent, prior_ent = state_entropies(cfg, post_logits, prior_logits)
        return torch.stack([rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, post_ent,
                            prior_ent, loss, value_loss]).detach()

    if ring is not None:
        return burst_train_step(gradient_step, ring, lambda gen, T, B: draw_noise(cfg, T, B, actor, gen, gen.device),
                                counted=True)

    def train(data: Dict[str, torch.Tensor], cum0: int, generator: Optional[torch.Generator] = None,
              noise: Optional[List[Dict[str, Any]]] = None) -> torch.Tensor:
        n_steps, T, B = data["actions"].shape[:3]
        device = data["actions"].device
        rows = []
        for g in range(n_steps):
            step_noise = noise[g] if noise is not None else draw_noise(cfg, T, B, actor, generator, device)
            rows.append(gradient_step({k: v[g] for k, v in data.items()}, int(cum0) + g, step_noise))
        return torch.stack(rows, dim=0)

    return train


def burst_train_step(step: Callable, ring: Dict[str, Any], draw: Callable, counted: bool,
                     names: Optional[Sequence[str]] = None) -> Callable:
    """A V2-family step body as the ring's burst. ``step(batch, cum, noise)``
    (``counted``: the carry is ``(cum,)``, the target copies' phase, as JAX's
    ``(params, opts, cum)``) or ``step(batch, noise)`` (the carry is ``()``,
    V1's ``(params, opts)``) returns one metric row; ``draw(generator, T,
    B)`` one step's noise. With ``names`` a step's metrics are a dict keyed
    by them, as the P2E steps return theirs."""
    seq_len, batch_size = int(ring["seq_len"]), int(ring["batch_size"])

    def carry_step(carry, xs):
        batch, noise = xs
        if counted:
            (cum,) = carry
            row, carry = step(batch, cum, noise), (cum + 1,)
        else:
            row = step(batch, noise)
        return carry, (dict(zip(names, row.unbind())) if names is not None else row)

    return build_burst_train_step(carry_step, ring, lambda gen: draw(gen, seq_len, batch_size))


# -- the loop ------------------------------------------------------------------


def make_buffer(cfg: Any, log_dir: str, num_envs: int, obs_keys: List[str]) -> Any:
    """``buffer.type`` ``sequential`` (per-env sequential buffers) or
    ``episode`` (:class:`EpisodeBuffer`, episodes of at least the sequence
    length; 1 in a dry run), of ``buffer.size // num_envs`` rows per env (4
    in a dry run), memmapped under the run's ``memmap_buffer/rank_0`` with
    ``buffer.memmap``, seeded with the run's seed."""
    dry_run = bool(cfg.get("dry_run", False))
    size = int(cfg.buffer.size) // num_envs if not dry_run else 4
    kind = str(cfg.buffer.get("type", "sequential")).lower()
    memmap = dict(memmap=bool(cfg.buffer.get("memmap", False)),
                  memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
                  memmap_mode=str(cfg.buffer.get("memmap_mode", "r+")))
    if kind == "sequential":
        rb = EnvIndependentReplayBuffer(size, num_envs, obs_keys, **memmap)
    elif kind == "episode":
        rb = EpisodeBuffer(size, 1 if dry_run else int(cfg.algo.per_rank_sequence_length), num_envs, obs_keys,
                           prioritize_ends=bool(cfg.buffer.get("prioritize_ends", False)), **memmap)
    else:
        raise ValueError(f"Unrecognized buffer type: must be one of `sequential` or `episode`, received: {kind}")
    rb.seed(int(cfg.seed))
    return rb


def buffer_digest(state: Dict[str, Any]) -> Dict[str, Any]:
    """A buffer ``state_dict``'s fingerprint: its rows (the stored episodes'
    and the open chunks', or every env's), the float64 sum of each key over
    them, and the generator state(s); two buffers with one digest hold the
    same rows and draw the same windows."""
    if "episodes" in state:
        parts = list(state["episodes"]) + [c for chunks in state["open"] for c in chunks]
        rngs = [state["rng"]]
        extra = {"episodes": len(state["episodes"]), "cum_lengths": list(state["cum_lengths"])}
    else:
        parts = [env["buffer"] for env in state["envs"]]
        rngs = [state["rng"]] + [env["rng"] for env in state["envs"]]
        extra = {"heads": [[int(env["pos"]), bool(env["full"])] for env in state["envs"]]}
    sums: Dict[str, float] = {}
    for part in parts:
        for k, v in part.items():
            sums[k] = sums.get(k, 0.0) + float(v.double().sum())
    rows = sum(int(next(iter(p.values())).shape[0]) for p in parts if p)
    return {"rows": rows, "sums": sums, "rng": [str(r["state"]) for r in rngs], **extra}


def _load_buffer(rb: Any, saved: Dict[str, Any]) -> None:
    episodes = "episodes" in saved
    if episodes != isinstance(rb, EpisodeBuffer):
        raise RuntimeError(f"Cannot restore the replay buffer: the checkpoint holds a "
                           f"{'episode' if episodes else 'sequential'} buffer, this run's buffer.type is "
                           f"{'episode' if isinstance(rb, EpisodeBuffer) else 'sequential'}")
    rb.load_state_dict(saved)


def run_loop(cfg: Any, device: torch.device, state: Optional[Dict[str, Any]], log_dir: str, logger: Any, envs: Any,
             learner: Any, saved_rb: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The host-buffer loop of the Dreamer V2 family (the JAX V2 loops'
    body): step the envs with the player, store the JAX loop's rows, take
    the gradient steps ``Ratio`` grants through ``learner.train``, log at
    ``metric.log_every`` and checkpoint. ``state`` is the resumed run's
    checkpoint (None on a fresh run); ``saved_rb`` a buffer state to
    restore. With ``algo.run_test`` the run ends in a greedy test episode of
    ``learner.test_actor`` on the card. Returns the run's summary.

    ``learner`` holds ``world_model``, ``metric_names``, ``random_prefill``
    (random actions until ``learning_starts`` on a fresh run),
    ``player_cls`` (:class:`PlayerDV2`, or Dreamer V1's player),
    ``rows_with_is_first`` (the V2 rows' ``is_first`` key, and a dry run's
    first row terminated and truncated; Dreamer V1's rows have neither),
    ``player_actor(granted)`` (the actor the player acts with before and from
    the first granted gradient step), ``test_actor``, ``train(data, cum,
    generator)`` (a list of metric rows; ``cum`` the run's gradient steps
    before, the target copies' phase) and ``state()`` (the checkpoint's
    modules and optimizers).

    The hybrid host player (``algo.hybrid_player``, on by ``auto`` on the
    card, as in JAX) needs ``learner.hybrid``; the finetuning learners have
    it off and train coupled whatever the key says, as JAX's finetuning
    loops never read it. Then the player acts on the host CPU with a copy of
    ``learner.player_modules()`` refreshed from the card, the rows go to the
    ring on the card in flushes, and a trainer thread runs the granted steps
    in bursts of ``learner.burst(ring)`` over ``learner.burst_carry``,
    restoring ``learner.train_modules``/``learner.optimizers`` before a
    retried burst; ``learner.exploration_metric`` adds the player's
    ``expl_amount`` as ``Params/exploration_amount``. ``buffer.type=episode``
    runs the ring's episode rule where ``learner.episode_rule`` (Dreamer V2);
    P2E-DV2 warns and trains coupled. With the episode buffer,
    ``buffer.prioritize_ends`` raises under ``enabled=true`` and warns and
    trains coupled under ``auto``, and a resume with ``buffer.checkpoint``
    warns and trains coupled. The host buffer is kept with the hybrid player
    only for ``buffer.checkpoint``; a sequential one restored from a
    checkpoint is mirrored into the ring.

    The checkpoint also holds ``cum``, the gradient steps of the run and of
    the runs it resumed; a resumed run reads it back (its summary's
    ``cum``), and its target copies count from its own first step, as the
    JAX loop's do."""
    num_envs = int(cfg.env.num_envs)
    seed = int(cfg.seed)
    dry_run = bool(cfg.get("dry_run", False))
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    is_continuous, actions_dim = action_dims(cfg.spaces)
    if is_continuous:
        low = np.asarray(cfg.spaces.actions.low, np.float32)
        high = np.asarray(cfg.spaces.actions.high, np.float32)
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))
    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)
    rb = make_buffer(cfg, log_dir, num_envs, obs_keys)
    episode_buffer = isinstance(rb, EpisodeBuffer)
    if saved_rb is not None:
        _load_buffer(rb, saved_rb)
    restored = buffer_digest(rb.state_dict()) if saved_rb is not None else None

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
    seq_len = int(cfg.algo.per_rank_sequence_length)
    log_level = int(cfg.metric.get("log_level", 1))
    log_every = int(cfg.metric.get("log_every", 5000))
    action_repeat = int(cfg.env.get("action_repeat", 1) or 1)
    train_step = resumed_train_steps = int(state.get("train_step", 0)) if state is not None else 0
    last_train = int(state.get("last_train", 0)) if state is not None else 0
    cum_before = int(state.get("cum", 0)) if state is not None else 0
    checkpoint_rb = bool(cfg.buffer.get("checkpoint", False))
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
    expl_amount = float(cfg.algo.actor.get("expl_amount", 0.0) or 0.0)
    player_cls, with_is_first = learner.player_cls, learner.rows_with_is_first
    player = player_cls(learner.world_model, learner.player_actor(granted=False), num_envs, generator, expl_amount)
    clip_rewards = bool(cfg.env.get("clip_rewards", False))

    hp_cfg = cfg.algo.get("hybrid_player") or {}
    hybrid = learner.hybrid and resolve_hybrid_player(hp_cfg, device)
    episode_rule = hybrid and episode_buffer
    if episode_rule and not learner.episode_rule:
        warnings.warn("hybrid_player burst mode requires buffer.type=sequential; falling back to host sampling")
        hybrid = episode_rule = False
    if episode_rule and bool(cfg.buffer.get("prioritize_ends", False)):
        # a config conflict: under an explicit enabled=true it raises rather than drop the bias or the burst
        msg = ("buffer.prioritize_ends is a host-path sampling bias not implemented by the device ring's "
               "episode-rule sampling. Unset it to use the hybrid player with the episode buffer, or set "
               "algo.hybrid_player.enabled=false.")
        if str(hp_cfg.get("enabled", "auto")).lower() == "true":
            raise ValueError(msg)
        warnings.warn(msg + " hybrid_player was 'auto': falling back to host-path sampling.")
        hybrid = episode_rule = False
    if episode_rule and state is not None and checkpoint_rb:
        # the run must stay resumable with its own config: never an error
        warnings.warn("Resuming an episode buffer cannot mirror the device ring (episodes are not a per-env "
                      "sequential layout): this resumed run keeps host-path sampling. Use buffer.type=sequential "
                      "if you need burst mode across resumes.")
        hybrid = episode_rule = False
    host_mirror = not hybrid or checkpoint_rb
    hp: Optional[HybridPlayerHarness] = None
    act_player = player
    if hybrid:
        card_sub = learner.player_modules()
        host_sub = copy.deepcopy(card_sub).to("cpu")  # the host player's modules
        hp = HybridPlayerHarness(
            cfg, ring_keys=dreamer_ring_keys(cfg.spaces.obs, cnn_keys, mlp_keys, actions_dim, with_is_first),
            capacity=int(cfg.buffer.size) // num_envs if not dry_run else 4,
            seq_len=seq_len, batch_size=batch_size, policy_steps_per_iter=num_envs, make_burst_fn=learner.burst,
            player_card=[*card_sub.parameters(), *card_sub.buffers()],
            player_host=[*host_sub.parameters(), *host_sub.buffers()],
            carry=learner.burst_carry, device=device, train_modules=learner.train_modules,
            optimizers=list(learner.optimizers.values()),
            rb=rb if saved_rb is not None and not episode_buffer else None,
            metric_names=learner.burst_metric_names, aggregator=aggregator, ring_spec={"episode_rule": episode_rule},
        )
        if state is not None and state.get("host_rng") is not None:
            hp.host_generator.set_state(state["host_rng"])
        if state is not None and state.get("rng") is not None:
            hp.generator.set_state(state["rng"])
        act_player = player_cls(host_sub.world_model, host_sub.actor, num_envs, hp.host_generator, expl_amount)
        if learner.exploration_metric:
            hp.extra_metrics["Params/exploration_amount"] = lambda: act_player.expl_amount

    # the first observation: its row has a zero action and reward (and is_first)
    step_data: Dict[str, np.ndarray] = {}
    obs = envs.reset(seed=seed)[0]
    for k in obs_keys:
        step_data[k] = np.asarray(obs[k])[np.newaxis]
    for k in ("terminated", "truncated"):
        step_data[k] = np.full((1, num_envs, 1), 1.0 if dry_run and with_is_first else 0.0, dtype=np.float32)
    step_data["actions"] = np.zeros((1, num_envs, int(np.sum(actions_dim))), dtype=np.float32)
    step_data["rewards"] = np.zeros((1, num_envs, 1), dtype=np.float32)
    if with_is_first:
        step_data["is_first"] = np.ones((1, num_envs, 1), dtype=np.float32)
    if host_mirror:
        rb.add(step_data, validate_args=cfg.buffer.get("validate_args", False))
    if hybrid:
        hp.stage_step(step_data)
    act_player.init_states()

    summary: Dict[str, Any] = {"start_iter": start_iter, "metrics": [], "train_host_s": [], "checkpoint": None,
                               "device": str(device), "test_reward": None, "test_steps": None,
                               "metric_names": list(learner.metric_names), "switched_at": None,
                               "buffer_type": "episode" if episode_buffer else "sequential", "cum_restored": cum_before,
                               "restored_buffer": restored, "hybrid": hybrid, "episode_rule": episode_rule,
                               "act_host_s": [],
                               # the ring's heads as a resume mirrored them from the host buffer
                               "ring_restored": ([hp.runner.dev_pos.tolist(), hp.runner.dev_valid.tolist()]
                                                 if hybrid and saved_rb is not None else None)}
    cum_gradient_steps = 0  # the target copies' phase: a resumed run starts again at 0, as the JAX loop does
    player_steps = 0
    env_s = 0.0
    t_loop = time.perf_counter()
    for iter_num in range(start_iter, total_iters + 1):
        policy_step += num_envs
        if hybrid:
            hp.poll()  # the newest snapshot that has landed
        t_env = time.perf_counter()
        with timer("Time/env_interaction_time", SumMetric):
            prefill = learner.random_prefill and iter_num <= learning_starts and state is None
            if prefill and is_continuous:
                actions = action_rng.uniform(low, high, size=(num_envs, len(low))).astype(np.float32)
                real_actions = actions
            elif prefill:
                real_actions = action_rng.integers(0, actions_dim, size=(num_envs, len(actions_dim)))
                actions = np.concatenate(
                    [np.eye(d, dtype=np.float32)[real_actions[:, i]] for i, d in enumerate(actions_dim)], axis=-1
                )
            else:
                prepared = prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys=cnn_keys, num_envs=num_envs)
                t_act, busy = time.perf_counter(), hybrid and hp.trainer.busy
                # the hybrid player acts on the host CPU: nothing goes to the card
                act_device = "cpu" if hybrid else device
                acts = act_player.get_actions({k: torch.from_numpy(v).to(act_device) for k, v in prepared.items()})
                if hybrid:
                    summary["act_host_s"].append((time.perf_counter() - t_act, busy or hp.trainer.busy))
                player_steps += 1
                actions = torch.cat(acts, dim=-1).float().cpu().numpy()
                real_actions = actions if is_continuous else np.stack([a.argmax(dim=-1).cpu().numpy() for a in acts],
                                                                      axis=-1)
            if with_is_first:
                step_data["is_first"] = np.logical_or(step_data["terminated"], step_data["truncated"]).astype(np.float32)
            next_obs, rewards, terminated, truncated, infos = envs.step(real_actions)
            dones = np.logical_or(terminated, truncated)
            if dry_run and episode_buffer:
                dones = np.ones_like(dones)
                terminated = np.ones_like(terminated)
        env_s += time.perf_counter() - t_env

        if log_level > 0:
            for i, ep_rew, ep_len in infos.get("episodes", ()):
                if aggregator is not None:
                    aggregator.update("Rewards/rew_avg", ep_rew)
                    aggregator.update("Game/ep_len_avg", ep_len)
                print(f"policy_step={policy_step}, reward_env_{i}={ep_rew}, length={ep_len}", flush=True)

        # the row after a_t holds the observation a_t led to: an episode's last one where it ended
        real_next_obs = {k: np.asarray(next_obs[k]).copy() for k in obs_keys}
        for idx, final in enumerate(infos.get("final_obs", ())):
            if final is not None:
                for k in obs_keys:
                    real_next_obs[k][idx] = final[k]
        for k in obs_keys:
            step_data[k] = real_next_obs[k][np.newaxis]
        obs = next_obs
        step_data["terminated"] = np.asarray(terminated, dtype=np.float32).reshape(1, num_envs, -1)
        step_data["truncated"] = np.asarray(truncated, dtype=np.float32).reshape(1, num_envs, -1)
        step_data["actions"] = actions.reshape(1, num_envs, -1).astype(np.float32)
        rewards = np.asarray(rewards, dtype=np.float32).reshape(1, num_envs, -1)
        step_data["rewards"] = np.tanh(rewards) if clip_rewards else rewards
        if host_mirror:
            rb.add(step_data, validate_args=cfg.buffer.get("validate_args", False))
        if hybrid:
            hp.stage_step(step_data)

        dones_idxes = np.asarray(dones).reshape(num_envs).nonzero()[0].tolist()
        if dones_idxes:
            # the reset observation starts the next episode
            n = len(dones_idxes)
            reset_data = {k: np.asarray(next_obs[k])[dones_idxes][np.newaxis] for k in obs_keys}
            for k in ("terminated", "truncated", "rewards"):
                reset_data[k] = np.zeros((1, n, 1), dtype=np.float32)
            reset_data["actions"] = np.zeros((1, n, int(np.sum(actions_dim))), dtype=np.float32)
            if with_is_first:
                reset_data["is_first"] = np.ones((1, n, 1), dtype=np.float32)
            if host_mirror:
                rb.add(reset_data, dones_idxes, validate_args=cfg.buffer.get("validate_args", False))
            if hybrid:
                hp.stage_reset(reset_data, dones_idxes)
            step_data["terminated"][:, dones_idxes] = 0.0
            step_data["truncated"][:, dones_idxes] = 0.0
            act_player.init_states(dones_idxes)

        if hybrid:
            if iter_num >= learning_starts:
                hp.grant(ratio(policy_step - prefill_steps * num_envs))
            # the flushes are handed to the trainer thread; the env loop never waits on the card
            hp.pump()
            cum_gradient_steps, train_step = hp.gradient_steps, resumed_train_steps + hp.train_steps
        elif iter_num >= learning_starts:
            gradient_steps = ratio(policy_step - prefill_steps * num_envs)
            if gradient_steps > 0:
                actor = learner.player_actor(granted=True)
                if player.actor is not actor:  # finetuning: the task actor from the first granted step
                    player.actor = actor
                    summary["switched_at"] = policy_step
                t0 = time.perf_counter()
                with timer("Time/replay_path_time", SumMetric):
                    sample = rb.sample(batch_size, sequence_length=seq_len, n_samples=gradient_steps)
                    data = {k: torch.from_numpy(np.asarray(v)).to(device).float() for k, v in sample.items()}
                with timer("Time/train_time", SumMetric):  # the metrics' read waits for the device
                    rows = learner.train(data, cum_gradient_steps, generator)
                summary["train_host_s"].append((time.perf_counter() - t0, gradient_steps))
                cum_gradient_steps += gradient_steps
                train_step += 1
                summary["metrics"].extend(rows)
                if aggregator is not None:
                    for name, column in zip(learner.metric_names, zip(*rows)):
                        if name in aggregator:
                            aggregator.update(name, np.mean(column))
                if log_level > 0:
                    for row in rows:
                        print("train " + " ".join(f"{n.split('/')[-1]}={v:.6g}"
                                                  for n, v in zip(learner.metric_names, row)), flush=True)

        if log_level > 0 and (policy_step - last_log >= log_every or iter_num == total_iters):
            if aggregator is not None:
                logger.log_dict(aggregator.compute(), policy_step)
                aggregator.reset()
            logger.log_dict({"Params/replay_ratio": cum_gradient_steps / policy_step}, policy_step)
            log_timers(logger, policy_step, train_step - last_train, (policy_step - last_log) * action_repeat)
            last_log, last_train = policy_step, train_step

        if (int(cfg.checkpoint.every) > 0 and policy_step - last_checkpoint >= int(cfg.checkpoint.every)) or (
            iter_num == total_iters and cfg.checkpoint.get("save_last", False)
        ):
            last_checkpoint = policy_step
            # with the hybrid player, the trainer's state between two bursts (at most one burst stale, as in JAX)
            with hp.trainer.train_lock if hybrid else contextlib.nullcontext():
                ckpt_state = {
                    **learner.state(),
                    "ratio": ratio.state_dict(),
                    "iter_num": iter_num,
                    "batch_size": batch_size,
                    "last_log": last_log,
                    "last_checkpoint": last_checkpoint,
                    "train_step": train_step,
                    "last_train": last_train,
                    "cum": cum_before + cum_gradient_steps,
                    "rng": (hp.generator if hybrid else generator).get_state(),
                }
                if hybrid:
                    ckpt_state["host_rng"] = hp.host_generator.get_state()
                if checkpoint_rb:
                    ckpt_state["rb"] = rb.checkpoint_state_dict()
                path = os.path.join(ckpt_dir, f"ckpt_{policy_step}_0.ckpt")
                summary["checkpoint"] = str(manager.save(path, ckpt_state, step=policy_step, config=plain(cfg)))

    if hybrid:
        # the tail: grants that can never run (an env still shorter than a window) go with the run
        hp.finish()
        cum_gradient_steps, train_step = hp.gradient_steps, resumed_train_steps + hp.train_steps
        summary.update(
            metrics=list(hp.metric_rows), metric_names=list(hp.metric_names), bursts=hp.runner.bursts,
            burst_host_s=list(hp.trainer.step_host_s), flush_host_s=list(hp.flush_host_s),
            snapshot_age=hp.snapshot_age, grad_chunk=hp.grad_chunk, train_calls=hp.train_steps,
            snapshot={"pulls": hp.snapshot.pulls, "polls": hp.snapshot.polls, "bytes": hp.snapshot.nbytes},
            replay={"Replay/flushes": hp.runner.flushes, "Replay/bytes_staged": hp.runner.bytes_staged},
        )
        if log_level > 0:
            for row in hp.metric_rows:
                print("train " + " ".join(f"{n.split('/')[-1]}={v:.6g}" for n, v in zip(hp.metric_names, row)),
                      flush=True)
    manager.close()
    loop_s = time.perf_counter() - t_loop
    envs.close()
    if cfg.algo.get("run_test", True):
        test_player = player_cls(learner.world_model, learner.test_actor, 1, generator, expl_amount)
        summary["test_reward"], summary["test_steps"] = test(test_player, cfg, device, greedy=True)
    logger.close()
    steps = policy_step - (start_iter - 1) * num_envs
    summary.update(
        policy_steps=policy_step,
        log_dir=log_dir,
        player_steps=player_steps,
        gradient_steps=cum_gradient_steps,
        cum=cum_before + cum_gradient_steps,
        env_steps_per_s=steps / env_s if env_s > 0 else None,
        loop_steps_per_s=steps / loop_s if loop_s > 0 else None,
        checkpoint_timings=manager.timings,
        **{"Fault/env_restarts": envs.env_restarts},
    )
    summary.setdefault("train_calls", len(summary["train_host_s"]))
    return summary


class DreamerV2Learner:
    """The world model, actor, critic and target critic under
    :func:`make_train_step`; the player acts with the actor, after random
    actions until ``learning_starts``. The hybrid player's bursts carry
    ``(cum,)`` and restore all four modules and the three optimizers."""

    random_prefill = True
    metric_names = METRIC_NAMES
    player_cls = PlayerDV2
    rows_with_is_first = True
    hybrid = True
    episode_rule = True
    exploration_metric = False
    burst_metric_names = METRIC_NAMES
    burst_carry = (0,)

    def __init__(self, cfg: Any, device: torch.device, state: Optional[Dict[str, Any]]) -> None:
        self.cfg = cfg
        self.world_model, self.actor, self.critic, self.target_critic = build_agent(cfg, device, state)
        self.optimizers = make_optimizers(cfg, self.world_model, self.actor, self.critic)
        if state is not None:
            for name, opt in self.optimizers.items():
                opt.load_state_dict(state["optimizers"][name])
        self.test_actor = self.actor
        self._train = make_train_step(self.world_model, self.actor, self.critic, self.target_critic,
                                      self.optimizers, cfg)

    def player_actor(self, granted: bool) -> torch.nn.Module:
        return self.actor

    def player_modules(self) -> torch.nn.Module:
        return player_subset(self.world_model, self.actor)

    @property
    def train_modules(self) -> tuple:
        return self.world_model, self.actor, self.critic, self.target_critic

    def burst(self, ring: Dict[str, Any]) -> Callable:
        return make_train_step(self.world_model, self.actor, self.critic, self.target_critic, self.optimizers,
                               self.cfg, ring=ring)

    def train(self, data, cum, generator):
        return self._train(data, cum, generator).cpu().tolist()

    def state(self) -> Dict[str, Any]:
        return {
            "world_model": self.world_model.state_dict(),
            "actor": self.actor.state_dict(),
            "critic": self.critic.state_dict(),
            "target_critic": self.target_critic.state_dict(),
            "optimizers": {n: o.state_dict() for n, o in self.optimizers.items()},
        }


def check_keys(cfg: Any) -> None:
    """The JAX loops' checks of the encoder and decoder keys."""
    cnn_enc, mlp_enc = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    cnn_dec, mlp_dec = list(cfg.algo.cnn_keys.get("decoder", cnn_enc)), list(cfg.algo.mlp_keys.get("decoder", mlp_enc))
    if not set(cnn_enc) & set(cnn_dec) and not set(mlp_enc) & set(mlp_dec):
        raise RuntimeError("The CNN keys or the MLP keys of the encoder and decoder must not be disjointed")
    for kind, enc, dec in (("CNN", cnn_enc, cnn_dec), ("MLP", mlp_enc, mlp_dec)):
        if set(dec) - set(enc):
            raise RuntimeError(f"The {kind} keys of the decoder must be contained in the encoder ones")


def start_run(cfg: Any) -> tuple:
    """What every V2-family loop does first: the settings JAX pins
    (``env.screen_size`` 64, ``env.frame_stack`` 1), the key checks, the run
    directory, the logger, the envs and the run's ``config.json``. Returns
    ``(log_dir, logger, envs)``."""
    cfg.env["screen_size"] = 64
    cfg.env["frame_stack"] = 1
    check_keys(cfg)
    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    envs = make_vector_env(cfg, int(cfg.seed))
    cfg["spaces"] = dotdict(envs.spaces)
    logger.log_hyperparams(cfg)
    write_run_config(log_dir, plain(cfg))
    return log_dir, logger, envs


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The Dreamer V2 run (see the module docstring); ``checkpoint.resume_from``
    resumes the modules, optimizers, ``Ratio``, counters, generator and with
    ``buffer.checkpoint`` the buffer of ``buffer.type``."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    log_dir, logger, envs = start_run(cfg)
    learner = DreamerV2Learner(cfg, device, state)
    saved_rb = state.get("rb") if state is not None and cfg.buffer.get("checkpoint", False) else None
    return run_loop(cfg, device, state, log_dir, logger, envs, learner, saved_rb)
