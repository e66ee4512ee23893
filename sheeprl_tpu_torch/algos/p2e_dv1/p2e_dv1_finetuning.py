"""Plan2Explore on Dreamer V1, the finetuning phase (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_finetuning.py``).

Starts from the exploration run's checkpoint (``checkpoint.exploration_ckpt_path``)
and trains the world model and the task actor and critic on the real
rewards with Dreamer V1's gradient step
(:func:`sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1.make_train_step`). The
model keys, the encoder and decoder keys and ``env.clip_rewards`` are the
exploration run's (the CLI pins its env keys); with
``buffer.load_from_exploration`` (and an exploration checkpoint that holds
its buffer) the run starts on the exploration's replay and its
``env.num_envs``. The player acts with the exploration actor until the
first granted gradient step, then with the task actor; there is no random
prefill. A resume (``checkpoint.resume_from``) takes the finetuning
checkpoint's modules, optimizers, ``Ratio`` and buffer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import PlayerDV1
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import METRIC_NAMES, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_optimizers, run_loop, start_run
from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import exploration_config
from sheeprl_tpu_torch.fault import load_resume_state

__all__ = ["PINNED_ALGO_KEYS", "main"]

#: the ``algo`` keys the finetuning run takes from the exploration run (JAX :52-61)
PINNED_ALGO_KEYS = (
    "gamma", "lmbda", "horizon", "dense_units", "mlp_layers", "dense_act", "cnn_act", "world_model", "actor",
    "critic", "cnn_keys", "mlp_keys",
)


class FinetuningLearner:
    """The world model and the task actor and critic under Dreamer V1's
    step; the exploration actor plays until the first granted step. Each
    metric row ends in the player's ``expl_amount``."""

    random_prefill = False
    hybrid = False  # coupled whatever algo.hybrid_player says: JAX's finetuning loops never read it
    metric_names = METRIC_NAMES + ("Params/exploration_amount",)
    player_cls = PlayerDV1
    rows_with_is_first = False

    def __init__(self, cfg: Any, device: torch.device, state: Dict[str, Any], resumed: bool) -> None:
        self.agent = a = build_agent(cfg, device, state)
        self.world_model = a.world_model
        self.test_actor = a.actor_task
        self.optimizers = make_optimizers(cfg, a.world_model, a.actor_task, a.critic_task)
        saved = state.get("optimizers") or {}
        names = {"world": "world", "actor": "actor", "critic": "critic"} if resumed else {
            "world": "world", "actor": "actor_task", "critic": "critic_task"}
        for mine, theirs in names.items():
            if theirs in saved:
                self.optimizers[mine].load_state_dict(saved[theirs])
        self.expl_amount = float(cfg.algo.actor.get("expl_amount", 0.0) or 0.0)
        self._train = make_train_step(a.world_model, a.actor_task, a.critic_task, self.optimizers, cfg)
        self.switched = False

    def player_actor(self, granted: bool) -> torch.nn.Module:
        self.switched = self.switched or granted
        return self.agent.actor_task if self.switched else self.agent.actor_exploration

    def train(self, data, cum, generator):
        return [row + [self.expl_amount] for row in self._train(data, generator).cpu().tolist()]

    def state(self) -> Dict[str, Any]:
        a = self.agent
        return {
            "world_model": a.world_model.state_dict(),
            "actor_task": a.actor_task.state_dict(),
            "critic_task": a.critic_task.state_dict(),
            "actor_exploration": a.actor_exploration.state_dict(),
            "optimizers": {n: o.state_dict() for n, o in self.optimizers.items()},
        }


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The finetuning run (see the module docstring)."""
    device = torch.device(device)
    exploration_cfg = exploration_config(cfg)
    resume: Optional[str] = cfg.checkpoint.get("resume_from")
    state = load_resume_state(resume if resume else cfg.checkpoint.exploration_ckpt_path)
    for k in PINNED_ALGO_KEYS:
        if k in exploration_cfg.algo:
            cfg.algo[k] = exploration_cfg.algo[k]
    cfg.env["clip_rewards"] = exploration_cfg.env.get("clip_rewards", False)
    from_exploration = bool(cfg.buffer.get("load_from_exploration", False)) and bool(
        exploration_cfg.buffer.get("checkpoint", False))
    if from_exploration:
        cfg.env["num_envs"] = exploration_cfg.env.num_envs
    cfg.buffer["type"] = "sequential"  # the JAX V1 loops keep per-env sequential buffers
    log_dir, logger, envs = start_run(cfg)
    learner = FinetuningLearner(cfg, device, state, resumed=bool(resume))
    saved_rb = None
    if (resume and cfg.buffer.get("checkpoint", False)) or (not resume and from_exploration):
        saved_rb = state.get("rb")
    return run_loop(cfg, device, state if resume else None, log_dir, logger, envs, learner, saved_rb)
