"""Optimizers (counterpart of ``sheeprl_tpu/optim/builders.py``, the part
DreamerV3, the PPO family and SAC use): Adam, and RMSprop in optax's form
(A2C), behind optax-style global-norm clipping, with a learning rate that
can be set between steps (optax's ``inject_hyperparams``, which PPO's
``anneal_lr`` writes).

On the card Adam is built ``fused`` and ``capturable``: its step count
lives on the card, as optax's count does, so a guarded step can select the
count back without reading it (:mod:`sheeprl_tpu_torch.ops.guard`), and the
whole update, bias corrections included, is one multi-tensor kernel per
parameter dtype: fewer launches than the ``foreach`` form, with a card-side
count or a host one (``tools/guard_cost.py`` counts them). The CPU
keeps torch's host step count and its ``foreach`` update (``capturable``
raises there). The state is created when the optimizer is, not at its
first step, so a guard can snapshot it before any update."""

from __future__ import annotations

from typing import Any, Iterable, List, Mapping, Optional, Sequence

import torch

__all__ = ["adam", "rmsprop", "RMSprop", "clip_by_global_norm_", "ClippedOptimizer", "build_optimizer"]


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
    params = list(params)
    on_card = bool(params) and params[0].is_cuda
    kwargs = dict(lr=float(lr), betas=(b1, b2), eps=float(eps), capturable=on_card, fused=True if on_card else None)
    if weight_decay:
        opt = torch.optim.AdamW(params, weight_decay=float(weight_decay), **kwargs)
    else:
        opt = torch.optim.Adam(params, **kwargs)
    _init_state(opt)
    return opt


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay=alpha, eps, eps_in_sqrt=False)`` in optax's
    op order, which ``torch.optim.RMSprop`` does not keep: ``nu = (1 - alpha)
    * g**2 + alpha * nu``, then ``u = g * (1 / (sqrt(nu) + eps))``, then the
    parameter plus ``-lr * u``. A weight decay adds ``weight_decay * p`` to
    the gradient first (optax's ``add_decayed_weights`` chained before it).
    ``nu`` starts at 0 (optax's ``initial_scale``) and is created with the
    optimizer. The update is one ``_foreach`` chain per step."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 1e-3, alpha: float = 0.99,
                 eps: float = 1e-8, weight_decay: float = 0.0) -> None:
        super().__init__(params, dict(lr=float(lr), alpha=float(alpha), eps=float(eps),
                                      weight_decay=float(weight_decay)))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            nus = [self.state[p]["nu"] for p in params]
            alpha = group["alpha"]
            new_nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - alpha)
            torch._foreach_add_(new_nu, torch._foreach_mul(nus, alpha))
            for nu, value in zip(nus, new_nu):
                nu.copy_(value)
            denom = torch._foreach_add(torch._foreach_sqrt(new_nu), group["eps"])
            updates = torch._foreach_mul(torch._foreach_reciprocal(denom), grads)
            torch._foreach_add_(params, torch._foreach_mul(updates, -group["lr"]))
        return None


def rmsprop(
    params: Iterable[torch.nn.Parameter],
    lr: float = 1e-3,
    alpha: float = 0.99,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    momentum: float = 0.0,
    centered: bool = False,
    **_: Any,
) -> RMSprop:
    """The JAX package's ``rmsprop`` (eps outside the square root, as
    torch places it, in optax's op order); momentum and the centered form
    are not ported."""
    if momentum or centered:
        raise NotImplementedError("RMSprop with momentum or centered=True is not ported yet")
    return RMSprop(params, lr=lr, alpha=alpha, eps=eps, weight_decay=weight_decay)


def _init_state(opt: torch.optim.Optimizer) -> None:
    """Adam's per-parameter state as its first step would create it: the
    step count (f32 on the parameter's device when fused or capturable) and
    zero moments."""
    for group in opt.param_groups:
        fused = bool(group["fused"])
        step_dtype = torch.float64 if torch.get_default_dtype() == torch.float64 and not fused else torch.float32
        for p in group["params"]:
            state = opt.state[p]
            if state:
                continue
            if group["capturable"] or fused:
                state["step"] = torch.zeros((), dtype=step_dtype, device=p.device)
            else:
                state["step"] = torch.tensor(0.0, dtype=step_dtype)
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            if group["amsgrad"]:
                state["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


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
        fused = bool(self.optimizer.param_groups[0].get("fused"))
        for p, g in zip(self.params, grads):
            # the fused update takes a gradient with its parameter's strides only
            # (a convolution's weight gradient comes channels-last)
            p.grad = g if not fused or g.stride() == p.stride() else torch.empty_like(p).copy_(g)
        self.optimizer.step()
        for p in self.params:
            p.grad = None

    def set_lr(self, lr: float) -> None:
        """The learning rate of the next steps, in place."""
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)

    @property
    def capturable(self) -> bool:
        return bool(self.optimizer.param_groups[0].get("capturable"))

    def state_tensors(self) -> List[torch.Tensor]:
        """Every state tensor (moments and step counts), parameter by
        parameter: what a guarded step must restore beside the parameters."""
        return [t for p in self.params for t in self.optimizer.state[p].values() if isinstance(t, torch.Tensor)]

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: dict) -> None:
        """Load a state saved on either device: the step counts go to the
        card when this optimizer is capturable and stay on the CPU when not,
        and the update keeps this optimizer's form, whatever the saved
        ``capturable`` and ``fused`` flags say."""
        if isinstance(self.optimizer, RMSprop):  # no step count and one form
            self.optimizer.load_state_dict(state)
            return
        own = self.optimizer.param_groups[0]
        groups = [{**g, "capturable": own["capturable"], "fused": own["fused"]} for g in state["param_groups"]]
        self.optimizer.load_state_dict({**state, "param_groups": groups})
        if not self.capturable:
            for st in self.optimizer.state.values():
                if isinstance(st.get("step"), torch.Tensor) and st["step"].device.type != "cpu":
                    st["step"] = st["step"].cpu()
        _init_state(self.optimizer)  # a state saved before the first step may lack some entries


def build_optimizer(
    params: Sequence[torch.nn.Parameter], optim_cfg: Mapping[str, Any], max_grad_norm: Optional[float] = None
) -> ClippedOptimizer:
    """From a config node with ``_target_`` (Adam and RMSprop are ported;
    the target names the builder by its last component) and the optimizer's
    keyword arguments."""
    cfg = dict(optim_cfg)
    target = str(cfg.pop("_target_", "adam")).rsplit(".", 1)[-1].lower()
    builders = {"adam": adam, "adamw": adam, "rmsprop": rmsprop}
    if target not in builders:
        raise NotImplementedError(f"optimizer '{target}' is not ported yet; {', '.join(builders)} only")
    params = list(params)
    clip = max_grad_norm if max_grad_norm and max_grad_norm > 0 else None
    return ClippedOptimizer(params, builders[target](params, **cfg), clip)
