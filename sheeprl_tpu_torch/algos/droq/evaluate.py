"""DroQ evaluation (counterpart of ``sheeprl_tpu/algos/droq/evaluate.py``).
The JAX package registers no serving builder for DroQ, and neither does the
port."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from sheeprl_tpu_torch.algos.droq.agent import build_agent
from sheeprl_tpu_torch.algos.droq.utils import test
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["evaluate_droq"]


@register_evaluation(algorithms=["droq"])
def evaluate_droq(cfg: Any, state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """One greedy test episode of the checkpoint's actor; its return and
    step count."""
    obs_dim = int(sum(np.prod(cfg.spaces.obs[k].shape) for k in cfg.algo.mlp_keys.encoder))
    _, player = build_agent(cfg, obs_dim, cfg.spaces.actions, device, state["agent"])
    reward, steps = test(player, cfg, device)
    return {"reward": reward, "steps": steps}
