"""Dreamer V1 coupled training (counterpart of
``sheeprl_tpu/algos/dreamer_v1/dreamer_v1.py``, its host-buffer path).

Each gradient step, in the JAX package's order (arXiv:1912.01603):

1. the world-model update: pixels mapped to ``/255 - 0.5``, the buffer's
   actions fed unshifted (row ``t`` holds the observation after ``a_t``), a
   T-step dynamic rollout from zero states with Gaussian posteriors drawn on
   injected normals (no ``is_first`` resets in V1), and the reconstruction
   loss: unit-variance Normal likelihoods, the plain KL with free nats, the
   optional continue head;
2. the actor through an H-step imagination from every posterior of the
   rollout on the freshly updated world model, by dynamics backpropagation:
   the actor acts on the stop-gradient latent, and the loss
   ``-mean(discount * lambda)`` reaches its parameters through the imagined
   actions, the GRU and the transition head. The trajectory holds the H
   latents after each step; V1's lambda-returns give H - 1 rows, bootstrapped
   from the last value; the discount is the cumulative product of
   ``[1, continues[:-2]]``;
3. one critic (V1 has no target network) on the stop-gradient trajectory
   less its last row.

Each loss is differentiated with respect to its own module's parameters only
(``torch.autograd.grad``): the actor's backward through the imagined RSSM
leaves no gradient on the world model, whose next step is its own. V1's
path holds no kernel: its GRU has no LayerNorm and its heads are Normal.
Random draws come from an explicit ``torch.Generator`` or are injected
(:func:`draw_noise` gives their shapes).

The loop is the Dreamer V2 family's :func:`~sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2.run_loop`
with V1's player and V1's rows (no ``is_first``), on the per-env sequential
buffer whatever ``buffer.type`` says, as the JAX V1 loop keeps it; ``Ratio``
with ``per_rank_pretrain_steps``; the player's ``expl_amount`` logged as
``Params/exploration_amount``. It runs unguarded, as the JAX loop does.
With the hybrid host player (``algo.hybrid_player``) the loop's burst path
runs :func:`make_train_step`'s ``ring`` variant over a carry with no
counter and a ring without ``is_first``, V1's rows having none.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import PlayerDV1, WorldModel, actor_sample, build_agent, player_subset
from sheeprl_tpu_torch.algos.dreamer_v1.loss import actor_loss, critic_loss, reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v1.utils import compute_lambda_values
from sheeprl_tpu_torch.algos.dreamer_v2.agent import Actor, draw_actor_noise
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import burst_train_step, make_optimizers, run_loop, start_run
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES, _grads
from sheeprl_tpu_torch.distributions import BernoulliSafeMode, Independent, Normal
from sheeprl_tpu_torch.fault import load_resume_state
from sheeprl_tpu_torch.optim import ClippedOptimizer

__all__ = [
    "METRIC_NAMES",
    "draw_imagination_noise",
    "draw_noise",
    "world_model_step",
    "imagine",
    "behaviour_step",
    "critic_step",
    "make_train_step",
    "main",
]


def draw_imagination_noise(cfg: Any, rows: int, actor: Actor, generator: Optional[torch.Generator],
                           device) -> Dict[str, Any]:
    """One imagination's noise: ``imagined_prior`` ``(H, rows, S)`` standard
    normals and ``actions``, as :func:`~sheeprl_tpu_torch.algos.dreamer_v2.agent.draw_actor_noise`
    draws them for ``H * rows`` states, each ``(H, rows, .)``."""
    horizon = int(cfg.algo.horizon)
    stoch = int(cfg.algo.world_model.stochastic_size)
    prior = torch.randn((horizon, rows, stoch), generator=generator, device=device)
    actions = [n.reshape(horizon, rows, -1) for n in draw_actor_noise(actor, horizon * rows, generator, device)]
    return {"imagined_prior": prior, "actions": actions}


def draw_noise(cfg: Any, seq_len: int, batch: int, actor: Actor, generator: Optional[torch.Generator],
               device) -> Dict[str, Any]:
    """One gradient step's noise: ``posterior`` ``(T, B, S)`` standard
    normals for the dynamic rollout's draws and the imagination's
    (:func:`draw_imagination_noise`, over ``T * B`` rows)."""
    stoch = int(cfg.algo.world_model.stochastic_size)
    return {"posterior": torch.randn((seq_len, batch, stoch), generator=generator, device=device),
            **draw_imagination_noise(cfg, seq_len * batch, actor, generator, device)}


def world_model_step(world_model: WorldModel, optimizer: ClippedOptimizer, cfg: Any, batch: Dict[str, torch.Tensor],
                     posterior_noise: torch.Tensor, detach_heads: bool = False):
    """The world-model update of one gradient step (``detach_heads``: the
    reward and continue heads read stop-gradient latents, as Plan2Explore's
    do). Returns ``(posts, recs, embedded, losses, entropies)``: the
    rollout's states and the embedded observations detached, ``losses`` the
    reconstruction loss's six terms, ``entropies`` the posterior's and the
    prior's mean entropy."""
    wm_cfg = cfg.algo.world_model
    cnn_enc = list(cfg.algo.cnn_keys.encoder)
    mlp_enc = list(cfg.algo.mlp_keys.encoder)
    cnn_dec = list(cfg.algo.cnn_keys.get("decoder", cnn_enc))
    mlp_dec = list(cfg.algo.mlp_keys.get("decoder", mlp_enc))
    gamma = float(cfg.algo.gamma)
    batch_obs = {k: batch[k] / 255.0 - 0.5 for k in cnn_enc}
    batch_obs.update({k: batch[k] for k in mlp_enc})
    actions = batch["actions"]  # unshifted: row t holds the observation after a_t
    T, B = actions.shape[:2]
    embedded = world_model.encoder(batch_obs)
    rec = torch.zeros((B, world_model.recurrent_model.rnn.hidden_size), device=embedded.device)
    post = torch.zeros((B, world_model.stochastic_size), device=embedded.device)
    steps = []
    for t in range(T):
        rec, post, post_ms, prior_ms = world_model.dynamic(post, rec, actions[t], embedded[t], posterior_noise[t])
        steps.append((rec, post, *post_ms, *prior_ms))
    recs, posts, post_mean, post_std, prior_mean, prior_std = (torch.stack(x, dim=0) for x in zip(*steps))
    latents = torch.cat([posts, recs], dim=-1)
    recon = world_model.decode(latents)
    qo = {k: Independent(Normal(recon[k], 1.0), 3) for k in cnn_dec}
    qo.update({k: Independent(Normal(recon[k], 1.0), 1) for k in mlp_dec})
    heads_in = latents.detach() if detach_heads else latents
    qr = Independent(Normal(world_model.reward_model(heads_in), 1.0), 1)
    qc = continue_targets = None
    if world_model.continue_model is not None:
        qc = Independent(BernoulliSafeMode(world_model.continue_model(heads_in)), 1)
        continue_targets = (1 - batch["terminated"]) * gamma
    posteriors = Independent(Normal(post_mean, post_std), 1)
    priors = Independent(Normal(prior_mean, prior_std), 1)
    losses = reconstruction_loss(
        qo, batch_obs, qr, batch["rewards"], posteriors, priors, float(wm_cfg.kl_free_nats),
        float(wm_cfg.kl_regularizer), qc, continue_targets, float(wm_cfg.continue_scale_factor),
    )
    with torch.no_grad():
        entropies = (posteriors.entropy().mean(), priors.entropy().mean())
    optimizer.step(_grads(losses[0], list(world_model.parameters())))
    return posts.detach(), recs.detach(), embedded.detach(), losses, entropies


def imagine(world_model: WorldModel, actor: Actor, prior: torch.Tensor, rec: torch.Tensor, noise: Dict[str, Any]):
    """H imagination steps from ``(prior, rec)`` (``(rows, .)``, detached):
    at each step the actor acts on the detached latent, then the RSSM
    advances. Returns the ``(H, rows, L)`` latents after each step (V1 keeps
    no start row) and the ``(H, rows, A)`` actions that led to them."""
    trajectory, acts = [], []
    for h in range(noise["imagined_prior"].shape[0]):
        latent = torch.cat([prior, rec], dim=-1)
        act = torch.cat(actor_sample(actor, latent.detach(), [u[h] for u in noise["actions"]])[0], dim=-1)
        prior, rec = world_model.imagination(prior, rec, act, noise["imagined_prior"][h])
        trajectory.append(torch.cat([prior, rec], dim=-1))
        acts.append(act)
    return torch.stack(trajectory, dim=0), torch.stack(acts, dim=0)


def behaviour_step(world_model: WorldModel, actor: Actor, critic: torch.nn.Module, reward_fn: Callable,
                   prior0: torch.Tensor, rec0: torch.Tensor, noise: Dict[str, Any], cfg: Any):
    """One imagination and its actor loss: the lambda-returns of
    ``reward_fn(traj, acts)`` on ``critic``'s values (bootstrap from the
    last), the continues from the continue head or ``gamma``, the discount
    the cumulative product of ``[1, continues[:-2]]``. Returns
    ``(policy_loss, traj, lambda_values, discount, reward)``, all but the loss
    detached."""
    gamma, lmbda = float(cfg.algo.gamma), float(cfg.algo.lmbda)
    traj, acts = imagine(world_model, actor, prior0, rec0, noise)
    values = critic(traj)
    rewards = reward_fn(traj, acts)
    if world_model.continue_model is not None:
        continues = torch.sigmoid(world_model.continue_model(traj))
    else:
        continues = torch.ones_like(rewards) * gamma
    lambda_values = compute_lambda_values(rewards, values, continues, values[-1], lmbda=lmbda)
    discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-2]], dim=0), dim=0).detach()
    loss = actor_loss(discount * lambda_values)
    return loss, traj.detach(), lambda_values.detach(), discount, rewards.detach()


def critic_step(critic: torch.nn.Module, optimizer: ClippedOptimizer, traj: torch.Tensor,
                lambda_values: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    """The critic's unit-variance Normal loss on the trajectory less its last
    row (:func:`~sheeprl_tpu_torch.algos.dreamer_v1.loss.critic_loss`), and
    its update."""
    qv = Independent(Normal(critic(traj[:-1]), 1.0), 1)
    value_loss = critic_loss(qv, lambda_values, discount[..., 0])
    optimizer.step(_grads(value_loss, list(critic.parameters())))
    return value_loss


def make_train_step(world_model: WorldModel, actor: Actor, critic: torch.nn.Module,
                    optimizers: Dict[str, ClippedOptimizer], cfg: Any, ring: Optional[Dict[str, Any]] = None
                    ) -> Callable:
    """The G-step update: ``train(data, generator=None, noise=None) ->
    metrics``. ``data`` holds ``(G, T, B, ...)`` float tensors on the
    modules' device (pixels in ``[0, 255]``); ``noise`` is a list of G
    :func:`draw_noise` dicts, else the draws come from ``generator``. The
    modules and optimizers are updated in place; ``metrics`` is ``(G, 10)``
    in :data:`METRIC_NAMES` order. With ``ring`` the step body becomes the
    ring's burst over the carry ``()`` (JAX's ``(params, opts)``)."""

    def gradient_step(batch: Dict[str, torch.Tensor], noise: Dict[str, Any]) -> torch.Tensor:
        posts, recs, _, losses, (post_ent, prior_ent) = world_model_step(
            world_model, optimizers["world"], cfg, batch, noise["posterior"])
        T, B = posts.shape[:2]
        loss, traj, lambda_values, discount, _ = behaviour_step(
            world_model, actor, critic, lambda traj, _: world_model.reward_model(traj),
            posts.reshape(T * B, -1), recs.reshape(T * B, -1), noise, cfg)
        optimizers["actor"].step(_grads(loss, list(actor.parameters())))
        value_loss = critic_step(critic, optimizers["critic"], traj, lambda_values, discount)
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        return torch.stack([rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, post_ent,
                            prior_ent, loss, value_loss]).detach()

    if ring is not None:
        return burst_train_step(gradient_step, ring, lambda gen, T, B: draw_noise(cfg, T, B, actor, gen, gen.device),
                                counted=False)

    def train(data: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
              noise: Optional[List[Dict[str, Any]]] = None) -> torch.Tensor:
        n_steps, T, B = data["actions"].shape[:3]
        device = data["actions"].device
        rows = []
        for g in range(n_steps):
            step_noise = noise[g] if noise is not None else draw_noise(cfg, T, B, actor, generator, device)
            rows.append(gradient_step({k: v[g] for k, v in data.items()}, step_noise))
        return torch.stack(rows, dim=0)

    return train


class DreamerV1Learner:
    """The world model, actor and critic under :func:`make_train_step`; the
    player (:class:`PlayerDV1`) acts with the actor, after random actions
    until ``learning_starts``. Each metric row ends in the player's
    ``expl_amount`` (``Params/exploration_amount``), the hybrid player's
    through the harness's extra metrics."""

    random_prefill = True
    metric_names = METRIC_NAMES + ("Params/exploration_amount",)
    player_cls = PlayerDV1
    rows_with_is_first = False
    hybrid = True
    episode_rule = False  # the buffer is per-env sequential whatever buffer.type says
    exploration_metric = True
    burst_metric_names = METRIC_NAMES
    burst_carry = ()

    def __init__(self, cfg: Any, device: torch.device, state: Optional[Dict[str, Any]]) -> None:
        self.cfg = cfg
        self.world_model, self.actor, self.critic = build_agent(cfg, device, state)
        self.optimizers = make_optimizers(cfg, self.world_model, self.actor, self.critic)
        if state is not None:
            for name, opt in self.optimizers.items():
                opt.load_state_dict(state["optimizers"][name])
        self.test_actor = self.actor
        self.expl_amount = float(cfg.algo.actor.get("expl_amount", 0.0) or 0.0)
        self._train = make_train_step(self.world_model, self.actor, self.critic, self.optimizers, cfg)

    def player_actor(self, granted: bool) -> torch.nn.Module:
        return self.actor

    def player_modules(self) -> torch.nn.Module:
        return player_subset(self.world_model, self.actor)

    @property
    def train_modules(self) -> tuple:
        return self.world_model, self.actor, self.critic

    def burst(self, ring: Dict[str, Any]) -> Callable:
        return make_train_step(self.world_model, self.actor, self.critic, self.optimizers, self.cfg, ring=ring)

    def train(self, data, cum, generator):
        return [row + [self.expl_amount] for row in self._train(data, generator).cpu().tolist()]

    def state(self) -> Dict[str, Any]:
        return {
            "world_model": self.world_model.state_dict(),
            "actor": self.actor.state_dict(),
            "critic": self.critic.state_dict(),
            "optimizers": {n: o.state_dict() for n, o in self.optimizers.items()},
        }


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The Dreamer V1 run (see the module docstring); ``checkpoint.resume_from``
    resumes the modules, optimizers, ``Ratio``, counters, generator and with
    ``buffer.checkpoint`` the buffer."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    cfg.buffer["type"] = "sequential"  # the JAX V1 loops keep per-env sequential buffers
    log_dir, logger, envs = start_run(cfg)
    learner = DreamerV1Learner(cfg, device, state)
    saved_rb = state.get("rb") if state is not None and cfg.buffer.get("checkpoint", False) else None
    return run_loop(cfg, device, state, log_dir, logger, envs, learner, saved_rb)
