"""Divergence sentinel: the host half of the finite guard (counterpart of
``sheeprl_tpu/fault/sentinel.py``).

The guarded train steps (``guard=True``) check their losses and gradients
with :func:`sheeprl_tpu_torch.ops.finite_guard` on the device and leave the
train state as it was when anything is NaN or Inf, counting the skipped
updates. This module reads that count once per iteration, tracks the
streak of bad iterations and acts when the run is diverging (a transient
blip heals itself; N bad iterations in a row do not):

- ``action: warn``: log and keep going (the guard already protected the
  parameters);
- ``action: rollback``: restore the train state from the last complete
  checkpoint and continue;
- ``action: abort``: raise :class:`DivergenceError`.

``rollback`` aborts when no complete checkpoint exists yet.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Callable, Dict, Optional

__all__ = ["DivergenceError", "DivergenceSentinel"]


class DivergenceError(RuntimeError):
    """Training diverged (non-finite loss/grads) beyond the tolerated streak."""


class DivergenceSentinel:
    """Track non-finite train steps and apply the skip/rollback/abort policy.

    ``observe(bad_count)`` is called once per training iteration with the
    number of updates the guard skipped; it returns ``True`` when the streak
    of bad iterations reached ``max_consecutive`` and the caller must call
    :meth:`recover`."""

    def __init__(self, cfg: Optional[Dict[str, Any]] = None) -> None:
        cfg = cfg or {}
        self.enabled = bool(cfg.get("enabled", True))
        self.max_consecutive = int(cfg.get("max_consecutive", 3))
        self.action = str(cfg.get("action", "rollback")).lower()
        if self.action not in ("rollback", "abort", "warn"):
            raise ValueError(f"Unknown fault.sentinel.action '{self.action}' (rollback|abort|warn)")
        self.consecutive = 0
        self.total_skipped = 0.0
        self.rollbacks = 0

    def observe(self, bad_count: Any) -> bool:
        """Record one iteration's skipped-update count (a number, or a 0-dim
        tensor read here, once); True == tripped."""
        bad = float(bad_count)
        self.total_skipped += bad
        if bad > 0:
            self.consecutive += 1
            warnings.warn(
                f"Non-finite loss/gradients: {bad:g} optimizer update(s) skipped "
                f"({self.consecutive} consecutive bad iteration(s))."
            )
        else:
            self.consecutive = 0
        return self.enabled and bad > 0 and self.consecutive >= self.max_consecutive

    def recover(self, ckpt_dir: "str | Path", restore_fn: Callable[[Dict[str, Any]], None]) -> None:
        """Apply the configured action after :meth:`observe` tripped.
        ``restore_fn(state)`` puts a loaded checkpoint's state back into the
        live training objects."""
        streak = self.consecutive
        if self.action == "warn":
            warnings.warn(
                f"Divergence sentinel tripped after {streak} consecutive non-finite iterations; "
                "fault.sentinel.action=warn — continuing with updates skipped."
            )
            self.consecutive = 0
            return
        state = None
        if self.action == "rollback":
            from sheeprl_tpu_torch.fault.manager import latest_complete, load_resume_state

            path = latest_complete(ckpt_dir)
            if path is not None:
                state = load_resume_state(path)
                warnings.warn(
                    f"Divergence sentinel: rolling back to last good checkpoint {path} "
                    f"after {streak} consecutive non-finite iterations."
                )
        if state is None:
            raise DivergenceError(
                f"Training diverged: {streak} consecutive iterations produced non-finite loss/gradients"
                + (
                    " and no complete checkpoint exists to roll back to"
                    if self.action == "rollback"
                    else " (fault.sentinel.action=abort)"
                )
                + f". Total skipped optimizer updates: {self.total_skipped:g}."
            )
        restore_fn(state)
        self.rollbacks += 1
        self.consecutive = 0
