"""Elementwise RL math (counterpart of ``sheeprl_tpu/ops/core.py``) and the
counter-based random numbers that stand in for JAX's per-session keys."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["symlog", "symexp", "counter_uniform", "counter_normal", "layer_norm"]


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    # (x * c) mod 2**32 for x in [0, 2**32), split so no int64 product overflows
    return ((((x * (c >> 16)) & 0xFFFF) << 16) + x * (c & 0xFFFF)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    # a 32-bit integer finaliser (xor-shift-multiply); every step is exact
    # integer arithmetic, so CPU and CUDA produce the same bits
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_uniform(seed: torch.Tensor, counter: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """``(B, n)`` float32 uniforms in ``(0, 1)``; row ``i`` depends only on
    ``seed[i]``, ``counter[i]``, ``stream`` and the column, never on the
    batch it was drawn in. ``seed`` and ``counter`` are int64 ``(B,)``; every
    value is an exact multiple of ``2**-24`` offset by half a step."""
    key = _mix32(_mix32(_mix32(seed & _M32) ^ _mix32((seed >> 32) & _M32)) ^ (counter & _M32))
    key = _mix32(key ^ _mix32(torch.full_like(key, stream & _M32)))
    cols = _mix32(torch.arange(n, dtype=torch.int64, device=seed.device) + 0x9E3779B9)
    bits = _mix32(key[:, None] ^ cols[None, :])
    return ((bits >> 8).to(torch.float32) + 0.5) * (2.0**-24)


def counter_normal(seed: torch.Tensor, counter: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """``(B, n)`` standard normals, the inverse normal CDF of
    :func:`counter_uniform` (whose values lie strictly inside (0, 1), so
    every one is finite); row ``i`` depends only on row ``i`` of ``seed``
    and ``counter``."""
    return torch.special.ndtri(counter_uniform(seed, counter, stream, n))


def layer_norm(
    x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], eps: float, dtype: torch.dtype
) -> torch.Tensor:
    """LayerNorm over the last axis as flax's ``LayerNorm(dtype=dtype)``
    computes it below float32: the statistics, the normalisation and the
    float32 affine in float32, then one rounding to ``dtype``. torch's
    two-pass statistics stand for flax's ``E[x^2] - E[x]^2``: the two agree
    to float32 rounding, which the one rounding to bfloat16 hides (the
    module tests hold them bit-equal on 99 % of the elements). ``weight``
    and ``bias`` broadcast against ``x`` (a stack of members' affines
    too)."""
    shape = (x.shape[-1],)
    if weight is not None and weight.shape == shape and (bias is None or bias.shape == shape):
        return F.layer_norm(x.float(), shape, weight.float(), None if bias is None else bias.float(), eps).to(dtype)
    y = F.layer_norm(x.float(), shape, None, None, eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)
