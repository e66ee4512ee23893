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
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.ops.kernels import LAUNCHES, _build

__all__ = ["gae", "gae_reference"]

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


def _library() -> ctypes.CDLL:
    lib = _build.load("gae")
    fn = lib.gae_launch
    if fn.argtypes is None:  # ctypes would pass each pointer as a 32-bit int
        ptr, i64, f32, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
        fn.argtypes = [ptr] * 6 + [i64, i64, f32, f32] + [i32] * 4 + [ptr]
        fn.restype = ctypes.c_int
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
    LAUNCHES["gae"] += 1
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
