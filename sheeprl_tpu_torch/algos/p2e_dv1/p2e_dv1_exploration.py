"""Plan2Explore on Dreamer V1, the exploration phase (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_exploration.py``, its host-buffer path).

Each gradient step, in the JAX package's order (Sekar et al.,
arXiv:2005.05960):

1. the world-model update, Dreamer V1's reconstruction loss with the reward
   and continue heads fed stop-gradient latents;
2. the ensembles' update: each of the ``n`` members regresses the next
   embedded observation from the stop-gradient latent and the action taken,
   by a unit-variance Normal likelihood, the per-member losses summed (on a
   one-step sequence, the only row);
3. the exploration actor through an H-step V1 imagination on the updated
   world model, by dynamics backpropagation, its reward the ensembles'
   disagreement on the imagined (latent, action) pairs (the population
   variance over members averaged over features, times
   ``algo.intrinsic_reward_multiplier``), its lambda-returns on the
   exploration critic;
4. the exploration critic against those lambda-returns;
5. the task actor and critic, zero-shot, through a second imagination,
   exactly as Dreamer V1 trains them.

No kernel is on the path. The loop is the Dreamer V2 family's
:func:`~sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2.run_loop` with V1's
player and rows, on the per-env sequential buffer (and with the hybrid host
player on a ring without ``is_first``), unguarded as the JAX loop is; the player acts with the exploration actor and the run's test episode is
the task actor's (zero-shot).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import PlayerDV1, player_subset
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import (
    behaviour_step,
    critic_step,
    draw_imagination_noise,
    world_model_step,
)
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import burst_train_step, run_loop, start_run
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _grads
from sheeprl_tpu_torch.algos.p2e_dv1.agent import P2EDV1Agent, build_agent
from sheeprl_tpu_torch.distributions import Independent, Normal
from sheeprl_tpu_torch.fault import load_resume_state
from sheeprl_tpu_torch.optim import ClippedOptimizer, build_optimizer

__all__ = ["METRIC_NAMES", "draw_noise", "make_optimizers", "make_train_step", "main"]

#: the columns of a step's metrics, in the step's order
METRIC_NAMES = (
    "Loss/world_model_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Loss/ensemble_loss",
    "Loss/policy_loss_exploration",
    "Rewards/intrinsic",
    "Loss/value_loss_exploration",
    "Loss/policy_loss_task",
    "Loss/value_loss_task",
)


def draw_noise(cfg: Any, seq_len: int, batch: int, agent: P2EDV1Agent, generator: Optional[torch.Generator],
               device) -> Dict[str, Any]:
    """One gradient step's noise: ``posterior`` ``(T, B, S)`` standard normals
    and each imagination's (``exploration``, ``task``), as Dreamer V1's
    ``draw_imagination_noise`` shapes them."""
    rows = seq_len * batch
    stoch = int(cfg.algo.world_model.stochastic_size)
    return {
        "posterior": torch.randn((seq_len, batch, stoch), generator=generator, device=device),
        "exploration": draw_imagination_noise(cfg, rows, agent.actor_exploration, generator, device),
        "task": draw_imagination_noise(cfg, rows, agent.actor_task, generator, device),
    }


def make_optimizers(cfg: Any, agent: P2EDV1Agent) -> Dict[str, ClippedOptimizer]:
    """``world``, ``ensembles``, ``actor_task``, ``critic_task``,
    ``actor_exploration`` and ``critic_exploration``, each with its
    config's clipping."""
    algo = cfg.algo
    return {
        "world": build_optimizer(agent.world_model.parameters(), algo.world_model.optimizer,
                                 algo.world_model.clip_gradients),
        "ensembles": build_optimizer(agent.ensembles.parameters(), algo.ensembles.optimizer,
                                     algo.ensembles.clip_gradients),
        "actor_task": build_optimizer(agent.actor_task.parameters(), algo.actor.optimizer, algo.actor.clip_gradients),
        "critic_task": build_optimizer(agent.critic_task.parameters(), algo.critic.optimizer,
                                       algo.critic.clip_gradients),
        "actor_exploration": build_optimizer(agent.actor_exploration.parameters(), algo.actor.optimizer,
                                             algo.actor.clip_gradients),
        "critic_exploration": build_optimizer(agent.critic_exploration.parameters(), algo.critic.optimizer,
                                              algo.critic.clip_gradients),
    }


def ensemble_loss(agent: P2EDV1Agent, posts: torch.Tensor, recs: torch.Tensor, actions: torch.Tensor,
                  embedded: torch.Tensor) -> torch.Tensor:
    """The members' summed negative log-likelihoods of the next embedded
    observation under unit-variance Normals of their predictions from the
    (stop-gradient) latent and the action; with one row, of that row's."""
    outs = agent.ensembles(torch.cat([posts, recs, actions], dim=-1))  # (N, T, B, E)
    pred, tgt = (outs[:, :-1], embedded[None, 1:]) if outs.shape[1] > 1 else (outs, embedded[None])
    return (-Independent(Normal(pred, 1.0), 1).log_prob(tgt).mean(dim=(1, 2))).sum()


def make_train_step(agent: P2EDV1Agent, optimizers: Dict[str, ClippedOptimizer], cfg: Any,
                    ring: Optional[Dict[str, Any]] = None) -> Callable:
    """The G-step update: ``train(data, generator=None, noise=None) ->
    metrics``. ``data`` holds ``(G, T, B, ...)`` float tensors on the
    modules' device (pixels in ``[0, 255]``); ``noise`` is a list of G
    :func:`draw_noise` dicts, else the draws come from ``generator``. The
    modules and optimizers are updated in place; ``metrics`` is ``(G, 14)``
    in :data:`METRIC_NAMES` order. With ``ring`` the step body becomes the
    ring's burst over the carry ``()``, each step's metrics a dict keyed by
    :data:`METRIC_NAMES`, as JAX's."""
    wm = agent.world_model
    intrinsic_mult = float(cfg.algo.intrinsic_reward_multiplier)

    def intrinsic_reward(traj: torch.Tensor, acts: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():  # the JAX loss reads the ensembles on a stop-gradient input
            pred = agent.ensembles(torch.cat([traj, acts], dim=-1).detach())
            return pred.var(dim=0, unbiased=False).mean(-1, keepdim=True) * intrinsic_mult

    def gradient_step(batch: Dict[str, torch.Tensor], noise: Dict[str, Any]) -> torch.Tensor:
        posts, recs, embedded, losses, (post_ent, prior_ent) = world_model_step(
            wm, optimizers["world"], cfg, batch, noise["posterior"], detach_heads=True)
        T, B = posts.shape[:2]
        ens_loss = ensemble_loss(agent, posts, recs, batch["actions"], embedded)
        optimizers["ensembles"].step(_grads(ens_loss, list(agent.ensembles.parameters())))

        prior0, rec0 = posts.reshape(T * B, -1), recs.reshape(T * B, -1)
        loss_expl, traj, lambda_values, discount, intrinsic = behaviour_step(
            wm, agent.actor_exploration, agent.critic_exploration, intrinsic_reward, prior0, rec0,
            noise["exploration"], cfg)
        optimizers["actor_exploration"].step(_grads(loss_expl, list(agent.actor_exploration.parameters())))
        value_expl = critic_step(agent.critic_exploration, optimizers["critic_exploration"], traj, lambda_values,
                                 discount)

        loss_task, traj, lambda_values, discount, _ = behaviour_step(
            wm, agent.actor_task, agent.critic_task, lambda traj, _: wm.reward_model(traj), prior0, rec0,
            noise["task"], cfg)
        optimizers["actor_task"].step(_grads(loss_task, list(agent.actor_task.parameters())))
        value_task = critic_step(agent.critic_task, optimizers["critic_task"], traj, lambda_values, discount)

        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        return torch.stack([rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, post_ent,
                            prior_ent, ens_loss, loss_expl, intrinsic.mean(), value_expl, loss_task,
                            value_task]).detach()

    if ring is not None:
        return burst_train_step(gradient_step, ring, lambda gen, T, B: draw_noise(cfg, T, B, agent, gen, gen.device),
                                counted=False, names=METRIC_NAMES)

    def train(data: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
              noise: Optional[List[Dict[str, Any]]] = None) -> torch.Tensor:
        n_steps, T, B = data["actions"].shape[:3]
        device = data["actions"].device
        rows = []
        for g in range(n_steps):
            step_noise = noise[g] if noise is not None else draw_noise(cfg, T, B, agent, generator, device)
            rows.append(gradient_step({k: v[g] for k, v in data.items()}, step_noise))
        return torch.stack(rows, dim=0)

    return train


class ExplorationLearner:
    """The exploration phase's modules and optimizers: the player acts with
    the exploration actor, after random actions until ``learning_starts``;
    the test episode is the task actor's. Each metric row ends in the
    player's ``expl_amount``."""

    random_prefill = True
    metric_names = METRIC_NAMES + ("Params/exploration_amount",)
    player_cls = PlayerDV1
    rows_with_is_first = False
    hybrid = True
    episode_rule = False  # the buffer is per-env sequential whatever buffer.type says
    exploration_metric = True
    burst_metric_names = None  # the burst steps name their metrics
    burst_carry = ()

    def __init__(self, cfg: Any, device: torch.device, state: Optional[Dict[str, Any]]) -> None:
        self.cfg = cfg
        self.agent = build_agent(cfg, device, state)
        self.world_model = self.agent.world_model
        self.test_actor = self.agent.actor_task
        self.optimizers = make_optimizers(cfg, self.agent)
        if state is not None:
            for name, opt in self.optimizers.items():
                opt.load_state_dict(state["optimizers"][name])
        self.expl_amount = float(cfg.algo.actor.get("expl_amount", 0.0) or 0.0)
        self._train = make_train_step(self.agent, self.optimizers, cfg)

    def player_actor(self, granted: bool) -> torch.nn.Module:
        return self.agent.actor_exploration

    def player_modules(self) -> torch.nn.Module:
        return player_subset(self.world_model, self.agent.actor_exploration)

    @property
    def train_modules(self) -> tuple:
        return (self.agent,)

    def burst(self, ring: Dict[str, Any]) -> Callable:
        return make_train_step(self.agent, self.optimizers, self.cfg, ring=ring)

    def train(self, data, cum, generator):
        return [row + [self.expl_amount] for row in self._train(data, generator).cpu().tolist()]

    def state(self) -> Dict[str, Any]:
        return {**self.agent.state(), "optimizers": {n: o.state_dict() for n, o in self.optimizers.items()}}


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The exploration run: the player on the exploration actor, every
    module trained each granted step (:func:`make_train_step`), the task
    actor's zero-shot test episode at the end. ``algo.player.actor_type`` is
    held at ``exploration``, as in JAX."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    cfg.algo.setdefault("player", {})["actor_type"] = "exploration"
    cfg.buffer["type"] = "sequential"  # the JAX V1 loops keep per-env sequential buffers
    log_dir, logger, envs = start_run(cfg)
    learner = ExplorationLearner(cfg, device, state)
    saved_rb = state.get("rb") if state is not None and cfg.buffer.get("checkpoint", False) else None
    return run_loop(cfg, device, state, log_dir, logger, envs, learner, saved_rb)
