"""Dreamer V1 evaluation (counterpart of ``sheeprl_tpu/algos/dreamer_v1/evaluate.py``):
one greedy test episode of a checkpoint's world model and actor. The JAX
package registers no serving policy for Dreamer V1."""

from __future__ import annotations

from typing import Any, Dict

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import PlayerDV1, build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.utils import test
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["evaluate_dreamer_v1", "evaluate_with"]


def evaluate_with(cfg: Any, state: Dict[str, Any], device: torch.device, actor_key: str) -> Dict[str, Any]:
    """One greedy test episode of ``state``'s world model and the actor saved
    under ``actor_key``, drawn as the run's own test episode is (a generator
    seeded with ``cfg.seed``), so on the run's device it is that episode."""
    world_model, actor, _ = build_agent(cfg, device, {"world_model": state["world_model"], "actor": state[actor_key]})
    world_model.requires_grad_(False)
    actor.requires_grad_(False)
    player = PlayerDV1(world_model, actor, 1, torch.Generator(device=device),
                       float(cfg.algo.actor.get("expl_amount", 0.0) or 0.0))
    reward, steps = test(player, cfg, device, greedy=True)
    return {"reward": reward, "steps": steps}


@register_evaluation(algorithms=["dreamer_v1"])
def evaluate_dreamer_v1(cfg: Any, state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """One greedy test episode of the checkpoint's world model and actor;
    its return and step count."""
    return evaluate_with(cfg, state, device, "actor")
