"""Run helpers (counterpart of ``sheeprl_tpu/utils/utils.py``)."""

from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping, Optional

__all__ = ["Ratio", "polynomial_decay"]


def polynomial_decay(
    current_step: int, *, initial: float = 1.0, final: float = 0.0, max_decay_steps: int = 100, power: float = 1.0
) -> float:
    """Polynomial schedule from ``initial`` to ``final`` over
    ``max_decay_steps`` (PPO's ``anneal_lr``, ``anneal_clip_coef`` and
    ``anneal_ent_coef``)."""
    if current_step > max_decay_steps or initial == final:
        return final
    return (initial - final) * ((1 - current_step / max_decay_steps) ** power) + final


class Ratio:
    """Replay-ratio governor: how many gradient steps to take for the policy
    steps done so far (Hafner's DreamerV3 ``when.py``). ``_prev`` rides the
    checkpoint, so a resumed run keeps the ratio."""

    def __init__(self, ratio: float, pretrain_steps: int = 0):
        if pretrain_steps < 0:
            raise ValueError(f"'pretrain_steps' must be non-negative, got {pretrain_steps}")
        if ratio < 0:
            raise ValueError(f"'ratio' must be non-negative, got {ratio}")
        self._pretrain_steps = pretrain_steps
        self._ratio = ratio
        self._prev: Optional[float] = None

    def __call__(self, step: int) -> int:
        if self._ratio == 0:
            return 0
        if self._prev is None:
            self._prev = step
            repeats = int(step * self._ratio)
            if self._pretrain_steps > 0:
                if step < self._pretrain_steps:
                    warnings.warn(
                        "The number of pretrain steps is greater than the number of current steps. This could lead "
                        f"to a higher ratio than the one specified ({self._ratio}). Setting the 'pretrain_steps' "
                        "equal to the number of current steps."
                    )
                    self._pretrain_steps = step
                repeats = int(self._pretrain_steps * self._ratio)
            return repeats
        repeats = int((step - self._prev) * self._ratio)
        self._prev += repeats / self._ratio
        return repeats

    def state_dict(self) -> Dict[str, Any]:
        return {"_ratio": self._ratio, "_prev": self._prev, "_pretrain_steps": self._pretrain_steps}

    def load_state_dict(self, state_dict: Mapping[str, Any]) -> "Ratio":
        self._ratio = state_dict["_ratio"]
        self._prev = state_dict["_prev"]
        self._pretrain_steps = state_dict["_pretrain_steps"]
        return self
