"""Generalized advantage estimation over a time-major rollout: ``(T, N[, 1])``
rewards, values and dones and an ``(N[, 1])`` bootstrap value -> float32
``(returns, advantages)`` shaped like the rewards (counterpart of
``sheeprl_tpu/ops/kernels/gae.py``).

:func:`gae_reference` is the plain version, a copy of the JAX package's
``ops.core.gae`` in its op order with float32 accumulation whatever the
input dtype. On CPU tensors :func:`gae` runs it. On CUDA tensors it launches
the hand-written kernel ``csrc/gae.cu`` (built at first use, see
:mod:`._build`) or raises; nothing substitutes the plain version on the
card. The gradient is the plain recurrence re-derived, as the JAX package's
``custom_vjp`` does: neither package has a backward kernel, and PPO never
differentiates through GAE.

:func:`gae_factors` is the population's entry (``ppo_anakin_population``):
the rollout is ``(T, P, ...)``, member ``p``'s columns under ``[:, p]``, and
``gamma`` and ``gae_lambda`` are ``(P,)`` float32 tensors, one pair per
member. ``gamma * lambda`` is their float32 product, as the JAX population
rounds its traced factors (the scalar entry rounds the double product once,
as the JAX single run does; the two agree at the recipes' 0.99 and 0.95).
Its plain version is :func:`gae_factors_reference`; on CUDA tensors it is one
launch of the same kernel, ``gae_launch_factors``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.ops.kernels import _build, count_launch

__all__ = ["gae", "gae_reference", "gae_factors", "gae_factors_reference"]

_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DONE_CODES = {torch.uint8: 0, torch.bool: 1, torch.float32: 2}


def gae_reference(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dones[t]`` marks the state after step ``t`` as terminal and masks
    that step's bootstrap; ``next_value`` is the value of the state after the
    last step. Returns ``(returns, advantages)``, float32."""
    rewards = rewards.to(torch.float32)
    values = values.to(torch.float32)
    next_value = next_value.to(torch.float32)
    not_dones = 1.0 - dones.to(torch.float32)
    next_values = torch.cat([values[1:], next_value[None]], dim=0)
    last = torch.zeros_like(next_value)
    advantages = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * next_values[t] * not_dones[t] - values[t]
        last = delta + gamma * gae_lambda * not_dones[t] * last
        advantages[t] = last
    advantages = torch.stack(advantages, dim=0) if advantages else torch.zeros_like(rewards)
    return advantages + values, advantages


def _member_shape(rewards: torch.Tensor, gamma: torch.Tensor) -> Tuple[int, ...]:
    """``(P, 1, ...)``: the members' factors broadcast over their columns."""
    if gamma.dim() != 1 or rewards.dim() < 2 or rewards.shape[1] != gamma.shape[0]:
        raise ValueError(f"gae_factors wants (P,) factors and a (T, P, ...) rollout, got {tuple(gamma.shape)} and "
                         f"{tuple(rewards.shape)}")
    return (gamma.shape[0],) + (1,) * (rewards.dim() - 2)


def gae_factors_reference(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    gamma: torch.Tensor,
    gae_lambda: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gae_reference` with member ``p``'s ``gamma[p]`` and
    ``gamma[p] * gae_lambda[p]`` (a float32 product) on its columns
    ``[:, p]``, in the same op order."""
    shape = _member_shape(rewards, gamma)
    g = gamma.to(torch.float32)
    gl = (g * gae_lambda.to(torch.float32)).reshape(shape)
    g = g.reshape(shape)
    rewards = rewards.to(torch.float32)
    values = values.to(torch.float32)
    next_value = next_value.to(torch.float32)
    not_dones = 1.0 - dones.to(torch.float32)
    next_values = torch.cat([values[1:], next_value[None]], dim=0)
    last = torch.zeros_like(next_value)
    advantages = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + g * next_values[t] * not_dones[t] - values[t]
        last = delta + gl * not_dones[t] * last
        advantages[t] = last
    advantages = torch.stack(advantages, dim=0) if advantages else torch.zeros_like(rewards)
    return advantages + values, advantages


def _library() -> ctypes.CDLL:
    lib = _build.load("gae")
    if lib.gae_launch.argtypes is None:  # ctypes would pass each pointer as a 32-bit int
        ptr, i64, f32, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
        lib.gae_launch_factors.argtypes = [ptr] * 6 + [i64, i64, i64, ptr, ptr] + [i32] * 4 + [ptr]
        lib.gae_launch_factors.restype = ctypes.c_int
        lib.gae_launch.restype = ctypes.c_int
        # set last: a second thread that sees it set finds both entries typed
        lib.gae_launch.argtypes = [ptr] * 6 + [i64, i64, f32, f32] + [i32] * 4 + [ptr]
    return lib


def _check(rewards, values, dones, next_value) -> None:
    named = {"rewards": rewards, "values": values, "dones": dones, "next_value": next_value}
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != rewards.device:
            raise ValueError(f"gae kernel needs every input on one CUDA device, got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"gae kernel needs contiguous inputs; {name} is not")
    for name in ("rewards", "values", "next_value"):
        if named[name].dtype not in _VALUE_CODES:
            raise TypeError(f"gae kernel takes float32, bfloat16 or float16 {name}, got {named[name].dtype}")
    if dones.dtype not in _DONE_CODES:
        raise TypeError(f"gae kernel takes uint8, bool or float32 dones, got {dones.dtype}")
    if rewards.ndim < 1 or values.shape != rewards.shape or dones.shape != rewards.shape:
        raise ValueError(
            f"gae kernel wants rewards, values and dones of one (T, ...) shape, got "
            f"{tuple(rewards.shape)}, {tuple(values.shape)}, {tuple(dones.shape)}"
        )
    if next_value.shape != rewards.shape[1:]:
        raise ValueError(f"gae kernel wants next_value {tuple(rewards.shape[1:])}, got {tuple(next_value.shape)}")


def _launch_factors(rewards, values, dones, next_value, gamma: torch.Tensor, gae_lambda: torch.Tensor):
    _check(rewards, values, dones, next_value)
    _member_shape(rewards, gamma)
    for name, t in (("gamma", gamma), ("gae_lambda", gae_lambda)):
        if t.device != rewards.device or t.shape != gamma.shape:
            raise ValueError(f"gae_factors kernel wants (P,) {name} on {rewards.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    g = gamma.to(torch.float32).contiguous()  # the kernel forms each member's float32 gamma * lambda
    lam = gae_lambda.to(torch.float32).contiguous()
    returns = torch.empty(rewards.shape, dtype=torch.float32, device=rewards.device)
    advantages = torch.empty_like(returns)
    T = rewards.shape[0]
    N = int(np.prod(rewards.shape[1:], dtype=np.int64))
    stream = torch.cuda.current_stream(rewards.device).cuda_stream
    err = _library().gae_launch_factors(
        rewards.data_ptr(), values.data_ptr(), dones.data_ptr(), next_value.data_ptr(),
        returns.data_ptr(), advantages.data_ptr(), T, N, N // g.shape[0], g.data_ptr(), lam.data_ptr(),
        _VALUE_CODES[rewards.dtype], _VALUE_CODES[values.dtype], _DONE_CODES[dones.dtype],
        _VALUE_CODES[next_value.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"gae kernel launch failed with cudaError {err}")
    count_launch("gae")
    return returns, advantages


def _launch(rewards, values, dones, next_value, gamma: float, gae_lambda: float):
    _check(rewards, values, dones, next_value)
    returns = torch.empty(rewards.shape, dtype=torch.float32, device=rewards.device)
    advantages = torch.empty_like(returns)
    T = rewards.shape[0]
    N = int(np.prod(rewards.shape[1:], dtype=np.int64))
    stream = torch.cuda.current_stream(rewards.device).cuda_stream
    err = _library().gae_launch(
        rewards.data_ptr(), values.data_ptr(), dones.data_ptr(), next_value.data_ptr(),
        returns.data_ptr(), advantages.data_ptr(), T, N,
        # gamma * lambda in double, then one rounding: the JAX package's weak-typed product
        float(np.float32(gamma)), float(np.float32(float(gamma) * float(gae_lambda))),
        _VALUE_CODES[rewards.dtype], _VALUE_CODES[values.dtype], _DONE_CODES[dones.dtype],
        _VALUE_CODES[next_value.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"gae kernel launch failed with cudaError {err}")
    count_launch("gae")
    return returns, advantages


class _Gae(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rewards, values, dones, next_value, gamma: float, gae_lambda: float):
        ctx.save_for_backward(rewards, values, dones, next_value)
        ctx.factors = (gamma, gae_lambda)
        return _launch(rewards, values, dones, next_value, gamma, gae_lambda)

    @staticmethod
    def backward(ctx, grad_returns, grad_advantages):
        rewards, values, dones, next_value = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0], ctx.needs_input_grad[1], ctx.needs_input_grad[3])
        with torch.enable_grad():
            r, v, nv = (t.detach().requires_grad_(n) for t, n in zip((rewards, values, next_value), needs))
            outs = gae_reference(r, v, dones, nv, *ctx.factors)
            wanted = [t for t in (r, v, nv) if t.requires_grad]
            grads = iter(torch.autograd.grad(outs, wanted, (grad_returns, grad_advantages)) if wanted else ())
        g_r, g_v, g_nv = (next(grads) if n else None for n in needs)
        return g_r, g_v, None, g_nv, None, None


class _GaeFactors(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rewards, values, dones, next_value, gamma, gae_lambda):
        ctx.save_for_backward(rewards, values, dones, next_value, gamma, gae_lambda)
        return _launch_factors(rewards, values, dones, next_value, gamma, gae_lambda)

    @staticmethod
    def backward(ctx, grad_returns, grad_advantages):
        rewards, values, dones, next_value, gamma, gae_lambda = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0], ctx.needs_input_grad[1], ctx.needs_input_grad[3])
        with torch.enable_grad():
            r, v, nv = (t.detach().requires_grad_(n) for t, n in zip((rewards, values, next_value), needs))
            outs = gae_factors_reference(r, v, dones, nv, gamma, gae_lambda)
            wanted = [t for t in (r, v, nv) if t.requires_grad]
            grads = iter(torch.autograd.grad(outs, wanted, (grad_returns, grad_advantages)) if wanted else ())
        g_r, g_v, g_nv = (next(grads) if n else None for n in needs)
        return g_r, g_v, None, g_nv, None, None


def gae_factors(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    gamma: torch.Tensor,
    gae_lambda: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over a ``(T, P, ...)`` rollout with ``(P,)`` per-member factors
    ``-> (returns, advantages)``, float32: the plain version for CPU tensors,
    one launch of the CUDA kernel for CUDA tensors; anything else raises."""
    tensors = (rewards, values, dones, next_value, gamma, gae_lambda)
    if all(t.device.type == "cpu" for t in tensors):
        return gae_factors_reference(*tensors)
    return _GaeFactors.apply(*tensors)


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE ``-> (returns, advantages)``, float32: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors; anything else raises."""
    if all(t.device.type == "cpu" for t in (rewards, values, dones, next_value)):
        return gae_reference(rewards, values, dones, next_value, gamma, gae_lambda)
    return _Gae.apply(rewards, values, dones, next_value, float(gamma), float(gae_lambda))
