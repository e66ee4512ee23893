"""Plan2Explore on Dreamer V2, the exploration phase (counterpart of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_exploration.py``, its host-buffer path).

Each gradient step, in the JAX package's order (Sekar et al.,
arXiv:2005.05960):

1. the hard copies of the task critic and of the exploration critic into
   their targets, on one ``cum % per_rank_target_network_update_freq`` gate;
2. the world-model update, Dreamer V2's reconstruction loss with the reward
   and continue heads fed stop-gradient latents;
3. the ensembles' update: each of the ``n`` members regresses the next
   posterior sample from the stop-gradient latent and the action taken, by
   a unit-variance Normal likelihood (on a one-step sequence, the only row);
4. the exploration actor through an H-step imagination on the updated world
   model, its reward the ensembles' disagreement (the population variance
   over members averaged over features, times
   ``algo.intrinsic_reward_multiplier``), its lambda-returns and baseline on
   the exploration target critic;
5. the exploration critic against those lambda-returns;
6. the task actor and critic, zero-shot, through a second imagination,
   exactly as Dreamer V2 trains them.

Every RSSM step runs ``gru_gates_ln`` on the card (its plain version on the
CPU): T + 2H launches a gradient step. The loop is Dreamer V2's
(:func:`~sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2.run_loop`, either
buffer type, the hybrid host player on the sequential one), unguarded as
the JAX loop is; the player acts with the exploration actor and the run's
test episode is the task actor's (zero-shot).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import (
    _grads,
    behaviour_step,
    burst_train_step,
    critic_step,
    draw_imagination_noise,
    hard_copy,
    run_loop,
    start_run,
    state_entropies,
    world_model_step,
)
from sheeprl_tpu_torch.algos.dreamer_v2.agent import PlayerDV2, _uniform, player_subset
from sheeprl_tpu_torch.algos.p2e_dv2.agent import P2EDV2Agent, build_agent
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
    "Loss/ensemble_loss",
    "Loss/policy_loss_exploration",
    "Rewards/intrinsic",
    "Loss/value_loss_exploration",
    "Loss/policy_loss_task",
    "Loss/value_loss_task",
    "State/post_entropy",
    "State/prior_entropy",
)


def draw_noise(cfg: Any, seq_len: int, batch: int, agent: P2EDV2Agent, generator: Optional[torch.Generator],
               device) -> Dict[str, Any]:
    """One gradient step's noise: ``posterior`` ``(T, B, S*D)`` and each
    imagination's (``exploration``, ``task``), as Dreamer V2's
    ``draw_imagination_noise`` shapes them."""
    wm_cfg = cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    rows = seq_len * batch
    return {
        "posterior": _uniform((seq_len, batch, stoch), generator, device),
        "exploration": draw_imagination_noise(cfg, rows, agent.actor_exploration, generator, device),
        "task": draw_imagination_noise(cfg, rows, agent.actor_task, generator, device),
    }


def make_optimizers(cfg: Any, agent: P2EDV2Agent) -> Dict[str, ClippedOptimizer]:
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


def make_train_step(agent: P2EDV2Agent, optimizers: Dict[str, ClippedOptimizer], cfg: Any,
                    ring: Optional[Dict[str, Any]] = None) -> Callable:
    """The G-step update: ``train(data, cum0, generator=None, noise=None) ->
    metrics``. ``data`` holds ``(G, T, B, ...)`` float tensors on the
    modules' device (pixels in ``[0, 255]``); ``cum0`` counts the run's
    gradient steps before (the target copies' phase); ``noise`` is a list of
    G :func:`draw_noise` dicts, else the draws come from ``generator``. The
    modules and optimizers are updated in place; ``metrics`` is ``(G, 14)``
    in :data:`METRIC_NAMES` order. With ``ring`` the step body becomes the
    ring's burst over the carry ``(cum,)`` (JAX's ``(params, opts, cum)``),
    each step's metrics a dict keyed by :data:`METRIC_NAMES`, as JAX's."""
    wm = agent.world_model
    freq = int(cfg.algo.critic.per_rank_target_network_update_freq)
    gamma = float(cfg.algo.gamma)
    intrinsic_mult = float(cfg.algo.intrinsic_reward_multiplier)
    pairs = [(list(agent.critic_task.parameters()), list(agent.target_critic_task.parameters())),
             (list(agent.critic_exploration.parameters()), list(agent.target_critic_exploration.parameters()))]

    def intrinsic_reward(traj: torch.Tensor, imagined: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():  # the JAX loss reads the ensembles on a stop-gradient input
            pred = agent.ensembles(torch.cat([traj, imagined], dim=-1).detach())
            return pred.var(dim=0, unbiased=False).mean(-1, keepdim=True) * intrinsic_mult

    def gradient_step(batch: Dict[str, torch.Tensor], cum: int, noise: Dict[str, Any]) -> torch.Tensor:
        hard_copy(pairs, cum, freq)
        posts, recs, post_logits, prior_logits, losses = world_model_step(
            wm, optimizers["world"], cfg, batch, noise["posterior"], detach_heads=True)
        T, B = posts.shape[:2]
        # the ensembles: the next posterior from (latent, action)
        outs = agent.ensembles(torch.cat([posts, recs, batch["actions"]], dim=-1))  # (N, T, B, S*D)
        pred, tgt = (outs[:, :-1], posts[None, 1:]) if T > 1 else (outs, posts[None])
        ens_loss = (-Independent(Normal(pred, 1.0), 1).log_prob(tgt).mean(dim=(1, 2))).sum()
        optimizers["ensembles"].step(_grads(ens_loss, list(agent.ensembles.parameters())))

        prior0, rec0 = posts.reshape(T * B, -1), recs.reshape(T * B, -1)
        true_continue = (1 - batch["terminated"]).reshape(1, T * B, 1) * gamma
        loss_expl, traj, lambda_values, discount, intrinsic = behaviour_step(
            wm, agent.actor_exploration, agent.target_critic_exploration, intrinsic_reward, prior0, rec0,
            true_continue, noise["exploration"], cfg)
        optimizers["actor_exploration"].step(_grads(loss_expl, list(agent.actor_exploration.parameters())))
        value_expl = critic_step(agent.critic_exploration, optimizers["critic_exploration"], traj, lambda_values,
                                 discount)

        loss_task, traj, lambda_values, discount, _ = behaviour_step(
            wm, agent.actor_task, agent.target_critic_task, lambda traj, _: wm.reward_model(traj), prior0, rec0,
            true_continue, noise["task"], cfg)
        optimizers["actor_task"].step(_grads(loss_task, list(agent.actor_task.parameters())))
        value_task = critic_step(agent.critic_task, optimizers["critic_task"], traj, lambda_values, discount)

        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        post_ent, prior_ent = state_entropies(cfg, post_logits, prior_logits)
        return torch.stack([rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, ens_loss,
                            loss_expl, intrinsic.mean(), value_expl, loss_task, value_task, post_ent,
                            prior_ent]).detach()

    if ring is not None:
        return burst_train_step(gradient_step, ring, lambda gen, T, B: draw_noise(cfg, T, B, agent, gen, gen.device),
                                counted=True, names=METRIC_NAMES)

    def train(data: Dict[str, torch.Tensor], cum0: int, generator: Optional[torch.Generator] = None,
              noise: Optional[List[Dict[str, Any]]] = None) -> torch.Tensor:
        n_steps, T, B = data["actions"].shape[:3]
        device = data["actions"].device
        rows = []
        for g in range(n_steps):
            step_noise = noise[g] if noise is not None else draw_noise(cfg, T, B, agent, generator, device)
            rows.append(gradient_step({k: v[g] for k, v in data.items()}, int(cum0) + g, step_noise))
        return torch.stack(rows, dim=0)

    return train


class ExplorationLearner:
    """The exploration phase's modules and optimizers: the player acts with
    the exploration actor, after random actions until ``learning_starts``;
    the test episode is the task actor's. The hybrid player's bursts carry
    ``(cum,)``, restore every module (both actor/critic pairs, their targets
    and the ensembles) and optimizer, and log the player's
    ``Params/exploration_amount``; they need ``buffer.type=sequential``, as
    JAX's do."""

    random_prefill = True
    metric_names = METRIC_NAMES
    player_cls = PlayerDV2
    rows_with_is_first = True
    hybrid = True
    episode_rule = False
    exploration_metric = True
    burst_metric_names = None  # the burst steps name their metrics
    burst_carry = (0,)

    def __init__(self, cfg: Any, device: torch.device, state: Optional[Dict[str, Any]]) -> None:
        self.cfg = cfg
        self.agent = build_agent(cfg, device, state)
        self.world_model = self.agent.world_model
        self.test_actor = self.agent.actor_task
        self.optimizers = make_optimizers(cfg, self.agent)
        if state is not None:
            for name, opt in self.optimizers.items():
                opt.load_state_dict(state["optimizers"][name])
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
        return self._train(data, cum, generator).cpu().tolist()

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
    log_dir, logger, envs = start_run(cfg)
    learner = ExplorationLearner(cfg, device, state)
    saved_rb = state.get("rb") if state is not None and cfg.buffer.get("checkpoint", False) else None
    return run_loop(cfg, device, state, log_dir, logger, envs, learner, saved_rb)
