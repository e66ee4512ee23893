"""Plan2Explore on DreamerV3, the finetuning phase (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_finetuning.py``).

Starts from the exploration run's checkpoint (``checkpoint.exploration_ckpt_path``)
and trains the world model and the task actor and critic on the real
rewards with DreamerV3's gradient step
(:func:`sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3.make_train_step`),
unguarded as in JAX. The model keys, the encoder and decoder keys and
``env.clip_rewards`` are the exploration run's (the CLI pins its env keys);
with ``buffer.load_from_exploration`` (and an exploration checkpoint that
holds its buffer) the run starts on the exploration's replay and its
``env.num_envs``. The player acts with the exploration actor until the
first granted gradient step, then with the task actor. A resume
(``checkpoint.resume_from``) takes the finetuning checkpoint's modules,
optimizers, ``Moments`` and buffer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers as dv3_optimizers
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_step as dv3_train_step
from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import check_keys, run_loop
from sheeprl_tpu_torch.algos.p2e_dv3.utils import init_moments
from sheeprl_tpu_torch.config import dotdict, load_config, plain
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import load_resume_state
from sheeprl_tpu_torch.utils.checkpoint import find_run_config, write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger

__all__ = ["PINNED_ALGO_KEYS", "exploration_config", "main"]

#: the ``algo`` keys the finetuning run takes from the exploration run (JAX :51-65)
PINNED_ALGO_KEYS = (
    "gamma", "lmbda", "horizon", "dense_units", "mlp_layers", "dense_act", "cnn_act", "unimix",
    "hafner_initialization", "world_model", "actor", "critic", "cnn_keys", "mlp_keys",
)


def exploration_config(cfg: Any) -> Any:
    """The exploration run's config, beside ``checkpoint.exploration_ckpt_path``."""
    path = (cfg.get("checkpoint") or {}).get("exploration_ckpt_path")
    if not path:
        raise ValueError(f"{cfg.algo.name} needs checkpoint.exploration_ckpt_path=<exploration checkpoint>")
    return load_config(find_run_config(path))


class FinetuningLearner:
    """The world model and the task actor and critic under DreamerV3's step;
    the exploration actor plays until the first granted step."""

    random_prefill = False
    hybrid = False  # coupled whatever algo.hybrid_player says: JAX's finetuning loops never read it
    metric_names = METRIC_NAMES

    def __init__(self, cfg: Any, device: torch.device, state: Dict[str, Any], resumed: bool) -> None:
        self.agent = build_agent(cfg, device, state)
        a = self.agent
        self.optimizers = dv3_optimizers(cfg, a.world_model, a.actor_task, a.critic_task)
        saved = state.get("optimizers") or {}
        names = {"world": "world", "actor": "actor", "critic": "critic"} if resumed else {
            "world": "world", "actor": "actor_task", "critic": "critic_task"}
        for mine, theirs in names.items():
            if theirs in saved:
                self.optimizers[mine].load_state_dict(saved[theirs])
        moments = state.get("moments")
        if moments is not None and not resumed:
            moments = moments["task"]
        self.moments = init_moments(device) if moments is None else {k: v.to(device) for k, v in moments.items()}
        self._train = dv3_train_step(a.world_model, a.actor_task, a.critic_task, a.target_critic_task,
                                     self.optimizers, cfg)
        self.switched = False

    def player_actor(self, granted: bool) -> torch.nn.Module:
        self.switched = self.switched or granted
        return self.agent.actor_task if self.switched else self.agent.actor_exploration

    def train(self, data, cum, generator):
        self.moments, metrics, _ = self._train(data, self.moments, cum, generator)
        return metrics.cpu().tolist()

    def state(self) -> Dict[str, Any]:
        a = self.agent
        return {
            "world_model": a.world_model.state_dict(),
            "actor_task": a.actor_task.state_dict(),
            "critic_task": a.critic_task.state_dict(),
            "target_critic_task": a.target_critic_task.state_dict(),
            "actor_exploration": a.actor_exploration.state_dict(),
            "optimizers": {n: o.state_dict() for n, o in self.optimizers.items()},
            "moments": self.moments,
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
    cfg.env["frame_stack"] = 1
    check_keys(cfg)
    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    envs = make_vector_env(cfg, int(cfg.seed), restart_on_exception=True)
    cfg["spaces"] = dotdict(envs.spaces)
    logger.log_hyperparams(cfg)
    write_run_config(log_dir, plain(cfg))
    learner = FinetuningLearner(cfg, device, state, resumed=bool(resume))
    saved_rb = None
    if (resume and cfg.buffer.get("checkpoint", False)) or (not resume and from_exploration):
        saved_rb = state.get("rb")
    return run_loop(cfg, device, state if resume else None, log_dir, logger, envs, learner, saved_rb,
                    dry_run_rows=4)
