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
first step, so a guard can snapshot it before any update.

A population's members train with :class:`StackedAdam`: Adam over the rows
of one ``(P, D)`` tensor, each member with its own learning rate, gradient
clipping and finite guard (optax's ``inject_hyperparams(adam)`` under
``vmap``)."""

from __future__ import annotations

from typing import Any, Iterable, List, Mapping, Optional, Sequence

import torch

__all__ = [
    "adam",
    "rmsprop",
    "RMSprop",
    "clip_by_global_norm_",
    "clip_by_member_norm_",
    "ClippedOptimizer",
    "StackedAdam",
    "build_optimizer",
    "build_stacked_optimizer",
]


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


def clip_by_member_norm_(grads: torch.Tensor, max_norm: float) -> torch.Tensor:
    """:func:`clip_by_global_norm_` for each member of a population apart:
    ``grads`` is ``(P, D)``, one member's whole gradient a row, and each row
    is scaled by its own norm (one global norm would mix the members).
    Returns the ``(P,)`` norms before clipping."""
    norm = torch.sqrt(torch.sum(grads * grads, dim=1, keepdim=True))
    grads.copy_(torch.where(norm < max_norm, grads, (grads / norm) * max_norm))
    return norm[:, 0]


class StackedAdam:
    """Adam for P members at once (optax ``inject_hyperparams(adam)`` under
    ``vmap``, as the JAX population builds it): the members' parameters are
    the rows of one ``(P, D)`` tensor, and so are both moments; each member
    has its own step count and its own learning rate, a ``(P,)`` tensor on
    the device given at every step. The update is optax's, in its op order:
    ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, the bias
    corrections ``1 - b^count``, ``u = mu_hat / (sqrt(nu_hat) + eps)`` (plus
    ``weight_decay * p``: ``adamw``), then ``p + (-lr * u)``. With
    ``max_grad_norm`` each member's gradient is first clipped by its own
    norm (:func:`clip_by_member_norm_`). ``ok`` (``(P,)`` bool) keeps a
    member's parameters, moments and count as they were where it is False:
    the population's finite guard, with no host read."""

    def __init__(self, params: torch.Tensor, lr: float = 1e-3, eps: float = 1e-8, weight_decay: float = 0.0,
                 betas: Sequence[float] = (0.9, 0.999), max_grad_norm: Optional[float] = None) -> None:
        if params.dim() != 2:
            raise ValueError(f"StackedAdam wants the members' parameters as one (P, D) tensor, got {tuple(params.shape)}")
        self.params = params
        self.lr = float(lr)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.b1, self.b2 = (float(b) for b in betas)
        self.max_grad_norm = float(max_grad_norm) if max_grad_norm else None
        self.exp_avg = torch.zeros_like(params)
        self.exp_avg_sq = torch.zeros_like(params)
        self.step_count = torch.zeros(params.shape[0], dtype=torch.float32, device=params.device)

    @torch.no_grad()
    def step(self, grads: torch.Tensor, lr: torch.Tensor, ok: Optional[torch.Tensor] = None) -> None:
        grads = grads.detach()
        if self.max_grad_norm is not None:
            grads = grads.clone()
            clip_by_member_norm_(grads, self.max_grad_norm)
        count = self.step_count + 1.0
        mu = (1.0 - self.b1) * grads + self.b1 * self.exp_avg
        nu = (1.0 - self.b2) * (grads * grads) + self.b2 * self.exp_avg_sq
        mu_hat = mu / (1.0 - torch.pow(self.b1, count))[:, None]  # float32 powers, as optax's decay**count
        nu_hat = nu / (1.0 - torch.pow(self.b2, count))[:, None]
        update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if self.weight_decay:
            update = update + self.weight_decay * self.params
        new_params = self.params + (-lr.to(torch.float32)[:, None]) * update
        if ok is not None:
            keep = ok[:, None]
            new_params = torch.where(keep, new_params, self.params)
            mu = torch.where(keep, mu, self.exp_avg)
            nu = torch.where(keep, nu, self.exp_avg_sq)
            count = torch.where(ok, count, self.step_count)
        self.params.copy_(new_params)
        self.exp_avg.copy_(mu)
        self.exp_avg_sq.copy_(nu)
        self.step_count.copy_(count)

    def gather_(self, member_map: torch.Tensor) -> None:
        """Member ``i``'s moments and count become member ``member_map[i]``'s
        (a population-based-training copy; the parameters are the caller's)."""
        for t in (self.exp_avg, self.exp_avg_sq, self.step_count):
            t.copy_(t.index_select(0, member_map))

    def state_dict(self) -> dict:
        return {"exp_avg": self.exp_avg, "exp_avg_sq": self.exp_avg_sq, "step": self.step_count}

    def load_state_dict(self, state: dict) -> None:
        for name, t in (("exp_avg", self.exp_avg), ("exp_avg_sq", self.exp_avg_sq), ("step", self.step_count)):
            t.copy_(torch.as_tensor(state[name]).to(device=t.device, dtype=t.dtype))


def build_stacked_optimizer(params: torch.Tensor, optim_cfg: Mapping[str, Any],
                            max_grad_norm: Optional[float] = None) -> StackedAdam:
    """The population's optimizer from the run's optimizer node: Adam (AdamW
    with a weight decay) over the ``(P, D)`` member rows; ``lr`` is the base
    the per-member rates replace at each step."""
    cfg = dict(optim_cfg)
    target = str(cfg.pop("_target_", "adam")).rsplit(".", 1)[-1].lower()
    if target not in ("adam", "adamw"):
        raise NotImplementedError(f"a population trains with Adam only; the optimizer '{target}' is not ported for it")
    clip = max_grad_norm if max_grad_norm and max_grad_norm > 0 else None
    return StackedAdam(params, lr=cfg.get("lr", 1e-3), eps=cfg.get("eps", 1e-8),
                       weight_decay=cfg.get("weight_decay", 0.0) or 0.0, betas=cfg.get("betas", (0.9, 0.999)),
                       max_grad_norm=clip)
