"""P2E-DV1 evaluation (counterpart of ``sheeprl_tpu/algos/p2e_dv1/evaluate.py``):
one greedy test episode of the checkpoint's world model and TASK actor. The
JAX package registers no serving policy for P2E."""

from __future__ import annotations

from typing import Any, Dict

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.evaluate import evaluate_with
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["evaluate_p2e_dv1"]


@register_evaluation(algorithms=["p2e_dv1_exploration", "p2e_dv1_finetuning"])
def evaluate_p2e_dv1(cfg: Any, state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """One greedy test episode of the task actor; its return and step count."""
    return evaluate_with(cfg, state, device, "actor_task")
