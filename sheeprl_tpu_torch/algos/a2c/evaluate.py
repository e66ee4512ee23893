"""A2C evaluation (counterpart of ``sheeprl_tpu/algos/a2c/evaluate.py``,
``evaluate_a2c``). A2C has no serving builder, in the JAX package or here."""

from __future__ import annotations

from typing import Any, Dict

import torch

from sheeprl_tpu_torch.algos.a2c.agent import build_agent
from sheeprl_tpu_torch.algos.a2c.utils import action_spec, test
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["evaluate_a2c"]


@register_evaluation(algorithms=["a2c"])
def evaluate_a2c(cfg: Any, state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """One greedy test episode of the checkpoint's agent; its return and
    step count."""
    actions_dim, is_continuous = action_spec(cfg.spaces)
    _, player = build_agent(cfg, actions_dim, is_continuous, cfg.spaces.obs, device, state["agent"])
    reward, steps = test(player, cfg, device)
    return {"reward": reward, "steps": steps}
