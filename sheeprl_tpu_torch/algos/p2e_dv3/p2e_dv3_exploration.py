"""Plan2Explore on DreamerV3, the exploration phase (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_exploration.py``, its host-buffer path).

Each gradient step, in the JAX package's order (Sekar et al.,
arXiv:2005.05960):

1. the target EMAs of the task critic and of every exploration critic;
2. the world-model update, DreamerV3's reconstruction loss with the reward
   and continue heads fed stop-gradient latents;
3. the ensembles' update: each of the ``n`` members regresses the next
   posterior sample from the stop-gradient latent and the action taken, by
   MSE (on a one-step sequence, the only row);
4. the exploration actor through an H-step imagination on the updated
   world model: per exploration critic the lambda-returns of its reward
   (``intrinsic``: the ensembles' disagreement, the population variance
   over members averaged over features, times
   ``algo.intrinsic_reward_multiplier``; ``task``: the reward head),
   normalised by that critic's own ``Moments``, the advantages summed with
   weights ``weight / sum(weights)``;
5. each exploration critic against its lambda-returns and its target;
6. the task actor and critic, zero-shot, through a second imagination,
   exactly as DreamerV3 trains them.

Every RSSM step runs the ``gru_gates_ln`` kernel and every two-hot head the
two-hot loss and decode kernels on the card (their plain versions on the
CPU); the ensembles are batched matmuls. The run is unguarded, as the JAX
P2E loops are. The player acts with the exploration actor; the run's test
episode is the task actor's (zero-shot). Checkpoints hold every module, the
optimizers, every ``Moments`` state, the ``Ratio``, the generator and with
``buffer.checkpoint`` the host buffer; ``checkpoint.resume_from`` resumes
them. With the hybrid host player (``algo.hybrid_player``, JAX's default on
the card) the exploration actor acts on the host CPU and a trainer thread
takes the granted steps in bursts over the sequence ring on the card
(:func:`make_train_step`'s ``ring`` variant, carry ``(moments, cum)``).
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

from sheeprl_tpu_torch.algos.dreamer_v3.agent import action_dims, actor_dists, actor_sample
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_sebulba import player_subset
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import Player, _grads, _uniform
from sheeprl_tpu_torch.algos.dreamer_v3.utils import patch_restarted_envs
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import DreamerV3Agent
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.p2e_dv3.agent import P2EAgent, build_agent
from sheeprl_tpu_torch.algos.p2e_dv3.utils import (
    compute_lambda_values,
    init_moments,
    moments_update,
    prepare_obs,
    test,
)
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.data import EnvIndependentReplayBuffer
from sheeprl_tpu_torch.data.ring import build_burst_train_step
from sheeprl_tpu_torch.distributions import (
    BernoulliSafeMode,
    Independent,
    MSEDistribution,
    OneHotCategorical,
    SymlogDistribution,
    TwoHotEncodingDistribution,
)
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import CheckpointManager, load_resume_state
from sheeprl_tpu_torch.optim import ClippedOptimizer, build_optimizer
from sheeprl_tpu_torch.utils.burst import HybridPlayerHarness, dreamer_ring_keys
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric, build_aggregator
from sheeprl_tpu_torch.utils.timer import log_timers, timer
from sheeprl_tpu_torch.utils.utils import Ratio, resolve_hybrid_player

__all__ = ["critics_spec", "metric_names", "draw_noise", "make_optimizers", "make_train_step", "run_loop", "main"]


def critics_spec(cfg: Any) -> Dict[str, Dict[str, Any]]:
    """``algo.critics_exploration`` in ``sorted`` name order: per critic its
    ``weight`` and ``reward_type`` (``intrinsic`` or ``task``)."""
    spec = cfg.algo.critics_exploration
    return {k: {"weight": float(spec[k]["weight"]), "reward_type": str(spec[k]["reward_type"])} for k in sorted(spec)}


def metric_names(spec: Dict[str, Dict[str, Any]]) -> List[str]:
    """The columns of a step's metrics, in the step's order."""
    names = [
        "Loss/world_model_loss", "Loss/observation_loss", "Loss/reward_loss", "Loss/state_loss",
        "Loss/continue_loss", "State/kl", "Loss/ensemble_loss", "Loss/policy_loss_exploration",
    ]
    if any(c["reward_type"] == "intrinsic" for c in spec.values()):
        names.append("Rewards/intrinsic")
    names += [f"Loss/value_loss_{name}" for name in spec]
    return names + ["Loss/policy_loss_task", "Loss/value_loss_task", "State/post_entropy", "State/prior_entropy"]


def _imagination_noise(cfg: Any, rows: int, actions_dim: Sequence[int], generator: Optional[torch.Generator], device,
                       continuous: bool) -> Dict[str, Any]:
    wm_cfg = cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    horizon = int(cfg.algo.horizon)
    noise: Dict[str, Any] = {"imagined_prior": _uniform((horizon, rows, stoch), generator, device)}
    if continuous:
        noise["actions"] = [torch.randn((horizon + 1, rows, int(sum(actions_dim))), generator=generator, device=device)]
    else:
        noise["actions"] = [_uniform((horizon + 1, rows, int(d)), generator, device) for d in actions_dim]
    return noise


def draw_noise(cfg: Any, seq_len: int, batch: int, actions_dim: Sequence[int], generator: Optional[torch.Generator],
               device, continuous: bool = False) -> Dict[str, Any]:
    """One gradient step's noise: ``posterior`` ``(T, B, S*D)`` for the
    dynamic rollout, and for each imagination (``exploration``, ``task``)
    ``imagined_prior`` ``(H, T*B, S*D)`` and ``actions``, as DreamerV3's
    ``draw_noise`` shapes them."""
    wm_cfg = cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    rows = seq_len * batch
    return {
        "posterior": _uniform((seq_len, batch, stoch), generator, device),
        "exploration": _imagination_noise(cfg, rows, actions_dim, generator, device, continuous),
        "task": _imagination_noise(cfg, rows, actions_dim, generator, device, continuous),
    }


def make_optimizers(cfg: Any, agent: P2EAgent) -> Dict[str, ClippedOptimizer]:
    """``world``, ``ensembles``, ``actor_task``, ``critic_task``,
    ``actor_exploration`` and one ``critic_exploration_<name>`` per
    exploration critic, each with its config's clipping."""
    algo = cfg.algo
    optimizers = {
        "world": build_optimizer(agent.world_model.parameters(), algo.world_model.optimizer,
                                 algo.world_model.clip_gradients),
        "ensembles": build_optimizer(agent.ensembles.parameters(), algo.ensembles.optimizer,
                                     algo.ensembles.clip_gradients),
        "actor_task": build_optimizer(agent.actor_task.parameters(), algo.actor.optimizer, algo.actor.clip_gradients),
        "critic_task": build_optimizer(agent.critic_task.parameters(), algo.critic.optimizer,
                                       algo.critic.clip_gradients),
        "actor_exploration": build_optimizer(agent.actor_exploration.parameters(), algo.actor.optimizer,
                                             algo.actor.clip_gradients),
    }
    for name, pair in agent.critics_exploration.items():
        optimizers[f"critic_exploration_{name}"] = build_optimizer(
            pair["module"].parameters(), algo.critic.optimizer, algo.critic.clip_gradients
        )
    return optimizers


def initial_moments(agent: P2EAgent, device) -> Dict[str, Any]:
    """One ``Moments`` state for the task and one per exploration critic."""
    return {"task": init_moments(device), "exploration": {k: init_moments(device) for k in agent.critic_names}}


def make_train_step(agent: P2EAgent, optimizers: Dict[str, ClippedOptimizer], cfg: Any,
                    ring: Optional[Dict[str, Any]] = None) -> Callable:
    """The G-step update: ``train(data, moments_state, cum0, generator=None,
    noise=None) -> (moments_state, metrics)``. ``data`` holds ``(G, T, B,
    ...)`` float tensors on the modules' device (pixels in ``[0, 255]``);
    ``cum0`` counts the gradient steps taken before; ``noise`` is a list of G
    :func:`draw_noise` dicts, else the draws come from ``generator``.
    ``moments_state`` is ``{"task": ..., "exploration": {name: ...}}``. The
    modules and optimizers are updated in place; ``metrics`` is ``(G,
    len(metric_names))`` in :func:`metric_names` order. With ``ring`` the
    step body becomes the ring's burst over the carry ``(moments_state,
    cum)`` (JAX's ``(params, opts, moments, cum)``; ``cum`` a tensor on the
    modules' device), each step's metrics a dict keyed by name, as JAX's."""
    wm = agent.world_model
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
    intrinsic_mult = float(cfg.algo.intrinsic_reward_multiplier)
    target_update_freq = int(cfg.algo.critic.per_rank_target_network_update_freq)
    tau = float(cfg.algo.critic.tau)
    moments_kw = dict(
        decay=float(cfg.algo.actor.moments.decay),
        max_=float(cfg.algo.actor.moments.max),
        percentile_low=float(cfg.algo.actor.moments.percentile.low),
        percentile_high=float(cfg.algo.actor.moments.percentile.high),
    )
    actions_dim = list(agent.actor_task.actions_dim)
    continuous = agent.actor_task.is_continuous
    spec = critics_spec(cfg)
    names = list(spec)
    weights_sum = sum(c["weight"] for c in spec.values())
    wm_params = list(wm.parameters())
    ens_params = list(agent.ensembles.parameters())
    # (online, target) parameter lists whose targets the EMA moves
    ema_pairs = [(list(agent.critic_task.parameters()), list(agent.target_critic_task.parameters()))] + [
        (list(agent.critics_exploration[k]["module"].parameters()), list(agent.critics_exploration[k]["target"].parameters()))
        for k in names
    ]

    def grouped(logits: torch.Tensor) -> torch.Tensor:
        return logits.reshape(*logits.shape[:-1], stochastic_size, discrete_size)

    def imagine(actor, prior, rec, noise):
        """The H+1 latents and the action sampled at each (H+1, T*B, .),
        from the detached rollout states; a graph only for a continuous
        actor (dynamics backpropagation)."""
        heads = noise["actions"]
        latent = torch.cat([prior, rec], dim=-1)
        act = torch.cat(actor_sample(actor, latent, [u[0] for u in heads])[0], dim=-1)
        trajectory, imagined = [latent], [act]
        for h in range(horizon):
            prior, rec = wm.imagination(prior, rec, act, noise["imagined_prior"][h])
            latent = torch.cat([prior, rec], dim=-1)
            act = torch.cat(actor_sample(actor, latent.detach(), [u[h + 1] for u in heads])[0], dim=-1)
            trajectory.append(latent)
            imagined.append(act)
        return torch.stack(trajectory, dim=0), torch.stack(imagined, dim=0)

    def continues_and_discount(traj, true_continue):
        with torch.no_grad():
            continues = Independent(BernoulliSafeMode(wm.continue_model(traj)), 1).mode
            continues = torch.cat([true_continue, continues[1:]], dim=0)
            return continues, torch.cumprod(continues * gamma, dim=0) / gamma

    def policy_loss_of(actor, traj, imagined, advantage, discount):
        policies = actor_dists(actor, actor(traj.detach()))
        if continuous:
            objective = advantage
        else:
            act_parts = torch.split(imagined.detach(), actions_dim, dim=-1)
            logprob = torch.stack([p.log_prob(a)[..., None][:-1] for p, a in zip(policies, act_parts)], dim=-1).sum(-1)
            objective = logprob * advantage.detach()
        try:
            entropy = ent_coef * torch.stack([p.entropy() for p in policies], dim=-1).sum(-1)
        except NotImplementedError:  # TanhNormal, as the JAX loss does
            entropy = torch.zeros(traj.shape[:-1], dtype=traj.dtype, device=traj.device)
        return -torch.mean(discount[:-1] * (objective + entropy[..., None][:-1]))

    def critic_update(critic, target, optimizer, traj, lambda_values, discount):
        qv = TwoHotEncodingDistribution(critic(traj[:-1]))
        with torch.no_grad():
            target_values = TwoHotEncodingDistribution(target(traj[:-1])).mean
        value_loss = torch.mean((-qv.log_prob(lambda_values) - qv.log_prob(target_values)) * discount[:-1, ..., 0])
        optimizer.step(_grads(value_loss, list(critic.parameters())))
        return value_loss

    def gradient_step(batch: Dict[str, torch.Tensor], moments_state, cum: "torch.Tensor | int",
                      noise: Dict[str, Any]):
        metrics: Dict[str, torch.Tensor] = {}
        moments_state = {"task": moments_state["task"], "exploration": dict(moments_state["exploration"])}
        # -- the target EMAs: a full copy at the first step, as JAX mixes them
        cum = torch.as_tensor(cum, dtype=torch.int64, device=batch["actions"].device)
        mix = torch.where(cum % target_update_freq == 0, torch.where(cum == 0, 1.0, tau), 0.0).to(torch.float32)
        with torch.no_grad():
            for online, target in ema_pairs:
                moved = torch._foreach_mul(online, mix)
                torch._foreach_add_(moved, torch._foreach_mul(target, 1.0 - mix))
                torch._foreach_copy_(target, moved)

        batch_obs = {k: batch[k] / 255.0 - 0.5 for k in cnn_enc}
        batch_obs.update({k: batch[k] for k in mlp_enc})
        is_first = batch["is_first"].clone()
        is_first[0] = 1.0
        batch_actions = torch.cat([torch.zeros_like(batch["actions"][:1]), batch["actions"][:-1]], dim=0)
        T, B = batch["actions"].shape[:2]

        # -- 1. world model, its reward and continue heads on stop-gradient latents
        embedded = wm.encoder(batch_obs)
        rec = torch.zeros((B, recurrent_state_size), device=embedded.device)
        post = torch.zeros((B, stoch_state_size), device=embedded.device)
        initial = wm.get_initial_states(B)
        steps = []
        for t in range(T):
            rec, post, post_logit, prior_logit = wm.dynamic(
                post, rec, batch_actions[t], embedded[t], is_first[t], noise["posterior"][t], initial
            )
            steps.append((rec, post, post_logit, prior_logit))
        recs, posts, post_logits, prior_logits = (torch.stack(x, dim=0) for x in zip(*steps))
        latents = torch.cat([posts, recs], dim=-1)
        recon = wm.decode(latents)
        po = {k: MSEDistribution(recon[k], dims=3) for k in cnn_dec}
        po.update({k: SymlogDistribution(recon[k], dims=1) for k in mlp_dec})
        pr = TwoHotEncodingDistribution(wm.reward_model(latents.detach()))
        pc = Independent(BernoulliSafeMode(wm.continue_model(latents.detach())), 1)
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
            po, batch_obs, pr, batch["rewards"], grouped(prior_logits), grouped(post_logits),
            float(wm_cfg.kl_dynamic), float(wm_cfg.kl_representation), float(wm_cfg.kl_free_nats),
            float(wm_cfg.kl_regularizer), pc, 1 - batch["terminated"], float(wm_cfg.continue_scale_factor),
        )
        optimizers["world"].step(_grads(rec_loss, wm_params))
        metrics.update({
            "Loss/world_model_loss": rec_loss, "Loss/observation_loss": observation_loss,
            "Loss/reward_loss": reward_loss, "Loss/state_loss": state_loss, "Loss/continue_loss": continue_loss,
            "State/kl": kl,
        })

        posts_sg, recs_sg = posts.detach(), recs.detach()
        # -- 2. the ensembles: the next posterior from (latent, action)
        outs = agent.ensembles(torch.cat([posts_sg, recs_sg, batch["actions"]], dim=-1))  # (N, T, B, S*D)
        pred, tgt = (outs[:, :-1], posts_sg[None, 1:]) if T > 1 else (outs, posts_sg[None])
        ens_loss = (-MSEDistribution(pred, dims=1).log_prob(tgt).mean(dim=(1, 2))).sum()
        optimizers["ensembles"].step(_grads(ens_loss, ens_params))
        metrics["Loss/ensemble_loss"] = ens_loss

        prior0 = posts_sg.reshape(T * B, stoch_state_size)
        rec0 = recs_sg.reshape(T * B, recurrent_state_size)
        true_continue = (1 - batch["terminated"]).reshape(1, T * B, 1)

        # -- 3. the exploration actor
        lambdas: Dict[str, torch.Tensor] = {}
        with torch.set_grad_enabled(continuous):
            traj, imagined = imagine(agent.actor_exploration, prior0, rec0, noise["exploration"])
            continues, discount = continues_and_discount(traj, true_continue)
            advantage = 0.0
            for name in names:
                values = TwoHotEncodingDistribution(agent.critics_exploration[name]["module"](traj)).mean
                if spec[name]["reward_type"] == "intrinsic":
                    with torch.no_grad():
                        ens_pred = agent.ensembles(torch.cat([traj, imagined], dim=-1).detach())
                        reward = ens_pred.var(dim=0, unbiased=False).mean(-1, keepdim=True) * intrinsic_mult
                    metrics["Rewards/intrinsic"] = reward.mean()
                else:
                    reward = TwoHotEncodingDistribution(wm.reward_model(traj)).mean
                lambda_values = compute_lambda_values(reward[1:], values[1:], continues[1:] * gamma, lmbda)
                lambdas[name] = lambda_values.detach()
                moments_state["exploration"][name], offset, invscale = moments_update(
                    moments_state["exploration"][name], lambda_values, **moments_kw
                )
                normed = (lambda_values - offset) / invscale - (values[:-1] - offset) / invscale
                advantage = advantage + normed * spec[name]["weight"] / weights_sum
        policy_loss = policy_loss_of(agent.actor_exploration, traj, imagined, advantage, discount)
        optimizers["actor_exploration"].step(_grads(policy_loss, list(agent.actor_exploration.parameters())))
        metrics["Loss/policy_loss_exploration"] = policy_loss

        # -- 4. every exploration critic
        traj = traj.detach()
        for name in names:
            pair = agent.critics_exploration[name]
            metrics[f"Loss/value_loss_{name}"] = critic_update(
                pair["module"], pair["target"], optimizers[f"critic_exploration_{name}"], traj, lambdas[name], discount
            )

        # -- 5. the task actor and critic, zero-shot
        with torch.set_grad_enabled(continuous):
            traj, imagined = imagine(agent.actor_task, prior0, rec0, noise["task"])
            values = TwoHotEncodingDistribution(agent.critic_task(traj)).mean
            rewards = TwoHotEncodingDistribution(wm.reward_model(traj)).mean
            continues, discount = continues_and_discount(traj, true_continue)
            lambda_values = compute_lambda_values(rewards[1:], values[1:], continues[1:] * gamma, lmbda)
            moments_state["task"], offset, invscale = moments_update(moments_state["task"], lambda_values, **moments_kw)
            advantage = (lambda_values - offset) / invscale - (values[:-1] - offset) / invscale
        policy_loss = policy_loss_of(agent.actor_task, traj, imagined, advantage, discount)
        optimizers["actor_task"].step(_grads(policy_loss, list(agent.actor_task.parameters())))
        metrics["Loss/policy_loss_task"] = policy_loss
        metrics["Loss/value_loss_task"] = critic_update(
            agent.critic_task, agent.target_critic_task, optimizers["critic_task"], traj.detach(),
            lambda_values.detach(), discount,
        )

        with torch.no_grad():
            metrics["State/post_entropy"] = Independent(OneHotCategorical(grouped(post_logits)), 1).entropy().mean()
            metrics["State/prior_entropy"] = Independent(OneHotCategorical(grouped(prior_logits)), 1).entropy().mean()
            row = torch.stack([metrics[k].detach() for k in metric_names(spec)])
        return moments_state, row

    if ring is not None:
        seq_len, batch_size, names_ = int(ring["seq_len"]), int(ring["batch_size"]), metric_names(spec)

        def carry_step(carry, xs):
            moments_state, cum = carry
            batch, noise = xs
            moments_state, row = gradient_step(batch, moments_state, cum, noise)
            return (moments_state, cum + 1), dict(zip(names_, row.unbind()))

        return build_burst_train_step(
            carry_step, ring, lambda gen: draw_noise(cfg, seq_len, batch_size, actions_dim, gen, gen.device, continuous))

    def train(
        data: Dict[str, torch.Tensor],
        moments_state: Dict[str, Any],
        cum0: int,
        generator: Optional[torch.Generator] = None,
        noise: Optional[List[Dict[str, Any]]] = None,
    ):
        n_steps, T, B = data["actions"].shape[:3]
        device = data["actions"].device
        rows = []
        for g in range(n_steps):
            step_noise = noise[g] if noise is not None else draw_noise(cfg, T, B, actions_dim, generator, device,
                                                                      continuous)
            moments_state, row = gradient_step({k: v[g] for k, v in data.items()}, moments_state, int(cum0) + g,
                                               step_noise)
            rows.append(row)
        return moments_state, torch.stack(rows, dim=0)

    return train


def run_loop(cfg: Any, device: torch.device, state: Optional[Dict[str, Any]], log_dir: str, logger: Any, envs: Any,
             learner: Any, saved_rb: Optional[Dict[str, Any]], dry_run_rows: int) -> Dict[str, Any]:
    """The coupled host-buffer loop both P2E phases share (the JAX loops'
    body): step the envs with the player, store every transition in the
    per-env buffers, take the gradient steps ``Ratio`` grants through
    ``learner.train``, log at ``metric.log_every`` and checkpoint. ``state``
    is the resumed run's checkpoint (None on a fresh run); ``saved_rb`` a
    buffer state to restore; ``dry_run`` cuts the buffer to
    ``dry_run_rows`` rows per env. With ``algo.run_test`` the run ends in
    the task actor's test episode. Returns the run's summary.

    ``learner`` holds ``agent`` (a :class:`P2EAgent`), ``metric_names``,
    ``random_prefill`` (random actions until ``learning_starts`` on a fresh
    run), ``player_actor(granted)`` (the actor the player acts with before
    and from the first granted gradient step), ``train(data, cum,
    generator)`` (a list of metric rows) and ``state()`` (the checkpoint's
    modules, optimizers and ``Moments``). The hybrid host player runs where
    ``learner.hybrid`` (the exploration phase) and ``algo.hybrid_player``
    resolves on: the exploration actor acts on a CPU copy of DreamerV3's
    player subset, the rows go to the ring on the card, the trainer thread
    runs ``learner.burst(ring)`` over ``(learner.moments, cum)`` and restores
    every module and optimizer before a retried burst. The finetuning phase
    trains coupled whatever the key says, as JAX's does."""
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
    buffer_size = int(cfg.buffer.size) // num_envs if not dry_run else dry_run_rows
    rb = EnvIndependentReplayBuffer(buffer_size, num_envs, obs_keys, memmap=bool(cfg.buffer.get("memmap", False)),
                                    memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
                                    memmap_mode=str(cfg.buffer.get("memmap_mode", "r+")))
    rb.seed(seed)
    if saved_rb is not None:
        rb.load_state_dict(saved_rb)

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
    train_step = int(state.get("train_step", 0)) if state is not None else 0
    last_train = int(state.get("last_train", 0)) if state is not None else 0
    if int(cfg.checkpoint.every) % num_envs != 0:
        warnings.warn(f"The checkpoint.every parameter ({cfg.checkpoint.every}) is not a multiple of the "
                      f"policy_steps_per_iter value ({num_envs}).")

    generator = torch.Generator(device=device).manual_seed(seed)
    if state is not None and state.get("rng") is not None:
        generator.set_state(state["rng"])
    action_rng = np.random.default_rng(seed)
    agent = learner.agent
    player = Player(agent.world_model, learner.player_actor(granted=False), num_envs, generator)
    hybrid = learner.hybrid and resolve_hybrid_player(cfg.algo.get("hybrid_player"), device)
    checkpoint_rb = bool(cfg.buffer.get("checkpoint", False))
    host_mirror = not hybrid or checkpoint_rb  # with the hybrid player, the checkpoint's copy of the ring
    hp: Optional[HybridPlayerHarness] = None
    act_player = player
    resumed_train_steps = train_step
    if hybrid:
        card_agent = learner.player_modules()
        host_agent = copy.deepcopy(card_agent).to("cpu")  # the host player's modules
        hp = HybridPlayerHarness(
            cfg, ring_keys=dreamer_ring_keys(cfg.spaces.obs, cnn_keys, mlp_keys, actions_dim, with_is_first=True),
            capacity=buffer_size, seq_len=seq_len, batch_size=batch_size, policy_steps_per_iter=num_envs,
            make_burst_fn=learner.burst,
            player_card=[*card_agent.parameters(), *card_agent.buffers()],
            player_host=[*host_agent.parameters(), *host_agent.buffers()],
            carry=(learner.moments, torch.zeros((), dtype=torch.int64, device=device)), device=device,
            train_modules=learner.train_modules, optimizers=list(learner.optimizers.values()),
            rb=rb if saved_rb is not None else None, metric_names=learner.burst_metric_names, aggregator=aggregator,
        )
        if state is not None and state.get("host_rng") is not None:
            hp.host_generator.set_state(state["host_rng"])
        if state is not None and state.get("rng") is not None:
            hp.generator.set_state(state["rng"])
        act_player = Player(host_agent.world_model, host_agent.actor, num_envs, hp.host_generator)

    step_data: Dict[str, np.ndarray] = {}
    obs = envs.reset(seed=seed)[0]
    for k in obs_keys:
        step_data[k] = np.asarray(obs[k])[np.newaxis]
    for k in ("rewards", "truncated", "terminated"):
        step_data[k] = np.zeros((1, num_envs, 1), dtype=np.float32)
    step_data["is_first"] = np.ones_like(step_data["terminated"])
    act_player.init_states()

    summary: Dict[str, Any] = {"start_iter": start_iter, "metrics": [], "train_host_s": [], "checkpoint": None,
                               "device": str(device), "test_reward": None, "test_steps": None,
                               "metric_names": list(learner.metric_names), "switched_at": None, "hybrid": hybrid,
                               "act_host_s": [],
                               "ring_restored": ([hp.runner.dev_pos.tolist(), hp.runner.dev_valid.tolist()]
                                                 if hybrid and saved_rb is not None else None)}
    cum_gradient_steps = 0  # a resumed run starts again at 0, so its first step copies the critics, as in JAX
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
            step_data["actions"] = actions.reshape(1, num_envs, -1)
            if host_mirror:
                rb.add(step_data, validate_args=cfg.buffer.get("validate_args", False))
            if hybrid:
                hp.stage_step(step_data)
            next_obs, rewards, terminated, truncated, infos = envs.step(real_actions)
        dones = np.logical_or(terminated, truncated)
        env_s += time.perf_counter() - t_env

        step_data["is_first"] = np.zeros_like(step_data["terminated"])
        if "restart_on_exception" in infos:
            patch_restarted_envs(infos["restart_on_exception"], dones, step_data, rb=rb if host_mirror else None,
                                 driver=hp)
        if log_level > 0:
            for i, ep_rew, ep_len in infos.get("episodes", ()):
                if aggregator is not None:
                    aggregator.update("Rewards/rew_avg", ep_rew)
                    aggregator.update("Game/ep_len_avg", ep_len)
                print(f"policy_step={policy_step}, reward_env_{i}={ep_rew}, length={ep_len}", flush=True)

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
            reset_data = {k: real_next_obs[k][dones_idxes][np.newaxis] for k in obs_keys}
            reset_data["terminated"] = step_data["terminated"][:, dones_idxes]
            reset_data["truncated"] = step_data["truncated"][:, dones_idxes]
            reset_data["actions"] = np.zeros((1, len(dones_idxes), int(np.sum(actions_dim))), dtype=np.float32)
            reset_data["rewards"] = step_data["rewards"][:, dones_idxes]
            reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
            if host_mirror:
                rb.add(reset_data, dones_idxes, validate_args=cfg.buffer.get("validate_args", False))
            if hybrid:
                hp.stage_reset(reset_data, dones_idxes)
            step_data["rewards"][:, dones_idxes] = 0.0
            step_data["terminated"][:, dones_idxes] = 0.0
            step_data["truncated"][:, dones_idxes] = 0.0
            step_data["is_first"][:, dones_idxes] = 1.0
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
                if player.agent.actor is not actor:  # finetuning: the task actor from the first granted step
                    player.agent.actor = actor
                    summary["switched_at"] = policy_step
                t0 = time.perf_counter()
                with timer("Time/replay_path_time", SumMetric):
                    sample = rb.sample(batch_size, sequence_length=seq_len, n_samples=gradient_steps)
                    data = {k: torch.from_numpy(v).to(device).float() for k, v in sample.items()}
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
                if hybrid:
                    learner.moments = hp.carry[0]
                ckpt_state = {
                    **learner.state(),
                    "ratio": ratio.state_dict(),
                    "iter_num": iter_num,
                    "batch_size": batch_size,
                    "last_log": last_log,
                    "last_checkpoint": last_checkpoint,
                    "train_step": train_step,
                    "last_train": last_train,
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
        learner.moments, _ = hp.finish()
        cum_gradient_steps, train_step = hp.gradient_steps, resumed_train_steps + hp.train_steps
        summary.update(
            metrics=list(hp.metric_rows), metric_names=list(hp.metric_names), bursts=hp.runner.bursts,
            burst_host_s=list(hp.trainer.step_host_s), flush_host_s=list(hp.flush_host_s),
            snapshot_age=hp.snapshot_age, grad_chunk=hp.grad_chunk, train_calls=hp.train_steps,
            snapshot={"pulls": hp.snapshot.pulls, "polls": hp.snapshot.polls, "bytes": hp.snapshot.nbytes},
            replay={"Replay/flushes": hp.runner.flushes, "Replay/bytes_staged": hp.runner.bytes_staged},
        )
    manager.close()
    loop_s = time.perf_counter() - t_loop
    envs.close()
    if cfg.algo.get("run_test", True):
        test_agent = DreamerV3Agent(agent.world_model, agent.actor_task)
        summary["test_reward"], summary["test_steps"] = test(test_agent, cfg, device, greedy=False)
    logger.close()
    steps = policy_step - (start_iter - 1) * num_envs
    summary.update(
        policy_steps=policy_step,
        log_dir=log_dir,
        player_steps=player_steps,
        gradient_steps=cum_gradient_steps,
        env_steps_per_s=steps / env_s if env_s > 0 else None,
        loop_steps_per_s=steps / loop_s if loop_s > 0 else None,
        checkpoint_timings=manager.timings,
        **{"Fault/env_restarts": envs.env_restarts},
    )
    summary.setdefault("train_calls", len(summary["train_host_s"]))
    return summary


class ExplorationLearner:
    """The exploration phase's modules, optimizers and ``Moments``: the
    player acts with the exploration actor, after random actions until
    ``learning_starts``."""

    random_prefill = True
    hybrid = True
    burst_metric_names = None  # the burst steps name their metrics

    def __init__(self, cfg: Any, device: torch.device, state: Optional[Dict[str, Any]]) -> None:
        self.cfg = cfg
        self.agent = build_agent(cfg, device, state)
        self.optimizers = make_optimizers(cfg, self.agent)
        self.moments = initial_moments(self.agent, device)
        if state is not None:
            for name, opt in self.optimizers.items():
                opt.load_state_dict(state["optimizers"][name])
            self.moments = {
                "task": {k: v.to(device) for k, v in state["moments"]["task"].items()},
                "exploration": {n: {k: v.to(device) for k, v in m.items()}
                                for n, m in state["moments"]["exploration"].items()},
            }
        self.metric_names = metric_names(critics_spec(cfg))
        self._train = make_train_step(self.agent, self.optimizers, cfg)

    def player_actor(self, granted: bool) -> torch.nn.Module:
        return self.agent.actor_exploration

    def player_modules(self) -> torch.nn.Module:
        """DreamerV3's player subset with the exploration actor."""
        return player_subset(self.agent.world_model, self.agent.actor_exploration)

    @property
    def train_modules(self) -> tuple:
        return (self.agent,)

    def burst(self, ring: Dict[str, Any]) -> Callable:
        return make_train_step(self.agent, self.optimizers, self.cfg, ring=ring)

    def train(self, data, cum, generator):
        self.moments, metrics = self._train(data, self.moments, cum, generator)
        return metrics.cpu().tolist()

    def state(self) -> Dict[str, Any]:
        return {**self.agent.state(), "optimizers": {n: o.state_dict() for n, o in self.optimizers.items()},
                "moments": self.moments}


def check_keys(cfg: Any) -> None:
    """The JAX loops' checks of the screen and the encoder/decoder keys."""
    if 2 ** int(np.log2(cfg.env.screen_size)) != cfg.env.screen_size:
        raise ValueError(f"The screen size must be a power of 2, got: {cfg.env.screen_size}")
    for kind in ("cnn", "mlp"):
        enc = list(cfg.algo[f"{kind}_keys"].encoder)
        if set(cfg.algo[f"{kind}_keys"].get("decoder", enc)) - set(enc):
            raise RuntimeError(f"The {kind.upper()} keys of the decoder must be contained in the encoder ones")


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The exploration run: the player on the exploration actor, every
    module trained each granted step (:func:`make_train_step`), the task
    actor's zero-shot test episode at the end. ``env.frame_stack`` is held
    at 1 and ``algo.player.actor_type`` at ``exploration``, as in JAX."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    cfg.env["frame_stack"] = 1
    cfg.algo.setdefault("player", {})["actor_type"] = "exploration"
    check_keys(cfg)
    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    envs = make_vector_env(cfg, int(cfg.seed), restart_on_exception=True)
    cfg["spaces"] = dotdict(envs.spaces)
    logger.log_hyperparams(cfg)
    write_run_config(log_dir, plain(cfg))
    learner = ExplorationLearner(cfg, device, state)
    saved_rb = state.get("rb") if state is not None and cfg.buffer.get("checkpoint", False) else None
    return run_loop(cfg, device, state, log_dir, logger, envs, learner, saved_rb, dry_run_rows=2)
