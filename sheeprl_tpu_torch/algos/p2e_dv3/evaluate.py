"""P2E-DV3 evaluation (counterpart of ``sheeprl_tpu/algos/p2e_dv3/evaluate.py``):
the task actor's episode, as the JAX package tests it (sampled, not
greedy). The JAX package registers no serving policy for P2E."""

from __future__ import annotations

from typing import Any, Dict

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import DreamerV3Agent
from sheeprl_tpu_torch.algos.p2e_dv3.utils import test
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["evaluate_p2e_dv3"]


@register_evaluation(algorithms=["p2e_dv3_exploration", "p2e_dv3_finetuning"])
def evaluate_p2e_dv3(cfg: Any, state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """One test episode of the checkpoint's world model and task actor; its
    return and step count."""
    world_model, actor = build_agent(cfg, device, {"world_model": state["world_model"], "actor": state["actor_task"]})
    reward, steps = test(DreamerV3Agent(world_model, actor).requires_grad_(False), cfg, device, greedy=False)
    return {"reward": reward, "steps": steps}
