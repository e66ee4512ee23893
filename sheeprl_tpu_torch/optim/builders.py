"""Optimizers (counterpart of ``sheeprl_tpu/optim/builders.py``, the part
DreamerV3 and PPO use): Adam behind optax-style global-norm clipping, with a
learning rate that can be set between steps (optax's ``inject_hyperparams``,
which PPO's ``anneal_lr`` writes)."""

from __future__ import annotations

from typing import Any, Iterable, List, Mapping, Optional, Sequence

import torch

__all__ = ["adam", "clip_by_global_norm_", "ClippedOptimizer", "build_optimizer"]


def adam(
    params: Iterable[torch.nn.Parameter],
    lr: float = 2e-4,
    eps: float = 1e-4,
    weight_decay: float = 0.0,
    betas: Sequence[float] = (0.9, 0.999),
    **_: Any,
) -> torch.optim.Optimizer:
    """``torch.optim.Adam`` with ``weight_decay=0`` is ``optax.adam``'s update:
    bias-corrected moments, eps outside the square root. A weight decay
    becomes ``AdamW``, as the JAX package maps it to ``optax.adamw``."""
    b1, b2 = (float(b) for b in betas)
    if weight_decay:
        return torch.optim.AdamW(params, lr=float(lr), betas=(b1, b2), eps=float(eps), weight_decay=float(weight_decay))
    return torch.optim.Adam(params, lr=float(lr), betas=(b1, b2), eps=float(eps))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: each gradient becomes
    ``g / norm * max_norm`` when the global norm is at least ``max_norm``,
    and stays as it is otherwise (``torch.nn.utils.clip_grad_norm_`` would
    divide by ``norm + 1e-6``). Returns the norm before clipping."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm  # stays on the device: no host sync
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


class ClippedOptimizer:
    """One module's optimizer: ``step(grads)`` clips the gradients of its
    parameters by global norm (where ``max_grad_norm`` is set) and applies
    the update."""

    def __init__(self, params: Sequence[torch.nn.Parameter], optimizer: torch.optim.Optimizer,
                 max_grad_norm: Optional[float]) -> None:
        self.params = list(params)
        self.optimizer = optimizer
        self.max_grad_norm = float(max_grad_norm) if max_grad_norm else None

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = [g.detach() for g in grads]
        if self.max_grad_norm is not None:  # clipped copies: the caller's gradients stay as they were
            grads = [g.clone() for g in grads]
            clip_by_global_norm_(grads, self.max_grad_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        for p in self.params:
            p.grad = None

    def set_lr(self, lr: float) -> None:
        """The learning rate of the next steps, in place."""
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state)


def build_optimizer(
    params: Sequence[torch.nn.Parameter], optim_cfg: Mapping[str, Any], max_grad_norm: Optional[float] = None
) -> ClippedOptimizer:
    """From a config node with ``_target_`` (only Adam is ported) and the
    optimizer's keyword arguments."""
    cfg = dict(optim_cfg)
    target = str(cfg.pop("_target_", "adam")).rsplit(".", 1)[-1].lower()
    if target not in ("adam", "adamw"):
        raise NotImplementedError(f"optimizer '{target}' is not ported yet; Adam only")
    params = list(params)
    return ClippedOptimizer(params, adam(params, **cfg), max_grad_norm if max_grad_norm and max_grad_norm > 0 else None)
