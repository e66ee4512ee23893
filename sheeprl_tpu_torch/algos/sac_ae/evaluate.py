"""SAC-AE evaluation (counterpart of ``sheeprl_tpu/algos/sac_ae/evaluate.py``).
The JAX package registers no serving builder for SAC-AE, and neither does
the port."""

from __future__ import annotations

from typing import Any, Dict

import torch

from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
from sheeprl_tpu_torch.algos.sac_ae.utils import test
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["evaluate_sac_ae"]


@register_evaluation(algorithms=["sac_ae"])
def evaluate_sac_ae(cfg: Any, state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """One greedy test episode of the checkpoint's actor; its return and
    step count."""
    _, player = build_agent(cfg, device, state["agent"])
    reward, steps = test(player, cfg, device)
    return {"reward": reward, "steps": steps}
