"""Two-hot symlog loss and symexp decode: ``TwoHotEncodingDistribution``'s
``log_prob`` and ``mean`` under the default symlog/symexp transforms
(counterpart of ``sheeprl_tpu/ops/kernels/twohot.py``).

- :func:`two_hot_symlog_loss`: ``(..., K) x (..., 1) -> (...,)``, the
  two-hot target of ``symlog(value)`` over ``linspace(low, high, K)`` dotted
  with the (log-normalised) logits;
- :func:`two_hot_symexp_decode`: ``(..., K) -> (..., 1)``, the softmax
  expectation over the bins, symexp'd back.

On CPU tensors each wrapper runs its plain version (``*_reference``, a
literal copy of the JAX package's). On CUDA tensors it launches the
hand-written kernel ``csrc/two_hot.cu`` (built at first use, see
:mod:`._build`) or raises; nothing substitutes the plain version on the
card. The gradient is the plain chain re-derived, as the JAX package's
``custom_vjp``s do: neither package has a backward kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.ops.core import symexp, symlog
from sheeprl_tpu_torch.ops.kernels import LAUNCHES, _build

__all__ = [
    "two_hot_symlog_loss",
    "two_hot_symlog_loss_reference",
    "two_hot_symexp_decode",
    "two_hot_symexp_decode_reference",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def two_hot_symlog_loss_reference(
    logits: torch.Tensor, value: torch.Tensor, low: float = -20.0, high: float = 20.0
) -> torch.Tensor:
    """``TwoHotEncodingDistribution.log_prob`` for the default transforms:
    ``logits`` are the log-normalised logits ``(..., K)``, ``value`` the
    raw-space target ``(..., 1)``."""
    x = symlog(value)
    num_buckets = logits.shape[-1]
    bins = torch.linspace(low, high, num_buckets, dtype=logits.dtype, device=logits.device)
    below = torch.sum((bins <= x).to(torch.int64), dim=-1, keepdim=True) - 1
    above = num_buckets - torch.sum((bins > x).to(torch.int64), dim=-1, keepdim=True)
    below = torch.clip(below, 0, num_buckets - 1)
    above = torch.clip(above, 0, num_buckets - 1)
    equal = below == above
    dist_to_below = torch.where(equal, 1.0, torch.abs(bins[below] - x))
    dist_to_above = torch.where(equal, 1.0, torch.abs(bins[above] - x))
    total = dist_to_below + dist_to_above
    weight_below = dist_to_above / total
    weight_above = dist_to_below / total
    target = (
        F.one_hot(below[..., 0], num_buckets).to(logits.dtype) * weight_below
        + F.one_hot(above[..., 0], num_buckets).to(logits.dtype) * weight_above
    )
    return torch.sum(target * logits, dim=-1)


def two_hot_symexp_decode_reference(logits: torch.Tensor, low: float = -20.0, high: float = 20.0) -> torch.Tensor:
    """``TwoHotEncodingDistribution.mean`` for the default transforms:
    softmax expectation over the bin support, symexp'd back, ``(..., 1)``."""
    probs = torch.softmax(logits, dim=-1)
    bins = torch.linspace(low, high, logits.shape[-1], dtype=logits.dtype, device=logits.device)
    return symexp(torch.sum(probs * bins, dim=-1, keepdim=True))


def _library() -> ctypes.CDLL:
    lib = _build.load("two_hot")
    loss, decode = lib.two_hot_symlog_loss_launch, lib.two_hot_symexp_decode_launch
    if loss.argtypes is None:  # ctypes would pass each pointer as a 32-bit int
        i64, ptr, f32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_float
        loss.argtypes = [ptr, ptr, ptr, i64, i64, f32, f32, ctypes.c_int, ptr]
        loss.restype = ctypes.c_int
        decode.argtypes = [ptr, ptr, i64, i64, f32, f32, ctypes.c_int, ptr]
        decode.restype = ctypes.c_int
        lib.two_hot_symexp_decode_max_bins.argtypes = []
        lib.two_hot_symexp_decode_max_bins.restype = ctypes.c_int
    return lib


def _check_logits(name: str, logits: torch.Tensor) -> None:
    if logits.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {logits.device}")
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 logits, got {logits.dtype}")
    if logits.ndim < 1 or logits.shape[-1] < 1:
        raise ValueError(f"{name} kernel wants logits (..., K) with K >= 1, got {tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError(f"{name} kernel needs contiguous logits")


def _launch_loss(logits: torch.Tensor, value: torch.Tensor, low: float, high: float) -> torch.Tensor:
    _check_logits("two_hot_symlog_loss", logits)
    if value.device != logits.device:
        raise ValueError(f"two_hot_symlog_loss kernel needs value on {logits.device}, got {value.device}")
    lead, k = tuple(logits.shape[:-1]), logits.shape[-1]
    try:
        target = value.expand(*lead, 1)
    except RuntimeError as e:
        raise ValueError(f"value {tuple(value.shape)} does not broadcast to {lead + (1,)}") from e
    # the main path hands in contiguous float32 (..., 1) targets: both calls are no-ops there
    target = target.to(torch.float32).contiguous()
    out = torch.empty(lead, dtype=logits.dtype, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = _library().two_hot_symlog_loss_launch(
        logits.data_ptr(), target.data_ptr(), out.data_ptr(), out.numel(), k, float(low), float(high),
        _DTYPE_CODES[logits.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"two_hot_symlog_loss kernel launch failed with cudaError {err}")
    LAUNCHES["two_hot_symlog_loss"] += 1
    return out


def _launch_decode(logits: torch.Tensor, low: float, high: float) -> torch.Tensor:
    _check_logits("two_hot_symexp_decode", logits)
    k, lib = logits.shape[-1], _library()
    max_bins = lib.two_hot_symexp_decode_max_bins()  # the kernel keeps a row in registers
    if k > max_bins:
        raise ValueError(f"two_hot_symexp_decode kernel takes at most {max_bins} bins, got {k}")
    out = torch.empty((*logits.shape[:-1], 1), dtype=logits.dtype, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = lib.two_hot_symexp_decode_launch(
        logits.data_ptr(), out.data_ptr(), out.numel(), k, float(low), float(high), _DTYPE_CODES[logits.dtype], stream
    )
    if err != 0:
        raise RuntimeError(f"two_hot_symexp_decode kernel launch failed with cudaError {err}")
    LAUNCHES["two_hot_symexp_decode"] += 1
    return out


def _plain_grads(fn, inputs: Tuple[torch.Tensor, ...], grad: torch.Tensor, needs) -> Tuple:
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_(n) for t, n in zip(inputs, needs))
        out = fn(*leaves)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
    return tuple(next(grads) if n else None for n in needs)


class _TwoHotSymlogLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits: torch.Tensor, value: torch.Tensor, low: float, high: float) -> torch.Tensor:
        ctx.save_for_backward(logits, value)
        ctx.bounds = (low, high)
        return _launch_loss(logits, value, low, high)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        low, high = ctx.bounds
        fn = lambda lg, v: two_hot_symlog_loss_reference(lg, v, low, high)  # noqa: E731
        return (*_plain_grads(fn, ctx.saved_tensors, grad, ctx.needs_input_grad[:2]), None, None)


class _TwoHotSymexpDecode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits: torch.Tensor, low: float, high: float) -> torch.Tensor:
        ctx.save_for_backward(logits)
        ctx.bounds = (low, high)
        return _launch_decode(logits, low, high)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        low, high = ctx.bounds
        fn = lambda lg: two_hot_symexp_decode_reference(lg, low, high)  # noqa: E731
        return (*_plain_grads(fn, ctx.saved_tensors, grad, ctx.needs_input_grad[:1]), None, None)


def two_hot_symlog_loss(
    logits: torch.Tensor, value: torch.Tensor, low: float = -20.0, high: float = 20.0
) -> torch.Tensor:
    """Two-hot/symlog log-probability ``(..., K) x (..., 1) -> (...,)``
    (``logits`` log-normalised): the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors; anything else raises."""
    if logits.device.type == "cpu" and value.device.type == "cpu":
        return two_hot_symlog_loss_reference(logits, value, low, high)
    return _TwoHotSymlogLoss.apply(logits, value, float(low), float(high))


def two_hot_symexp_decode(logits: torch.Tensor, low: float = -20.0, high: float = 20.0) -> torch.Tensor:
    """Two-hot mean decode ``(..., K) -> (..., 1)``: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors; anything else raises."""
    if logits.device.type == "cpu":
        return two_hot_symexp_decode_reference(logits, low, high)
    return _TwoHotSymexpDecode.apply(logits, float(low), float(high))
