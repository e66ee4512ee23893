"""Two-hot symlog loss and symexp decode: ``TwoHotEncodingDistribution``'s
``log_prob`` and ``mean`` under the default symlog/symexp transforms
(counterpart of ``sheeprl_tpu/ops/kernels/twohot.py``).

- :func:`two_hot_symlog_loss`: ``(..., K) x (..., 1) -> (...,)``, the
  two-hot target of ``symlog(value)`` over ``linspace(low, high, K)`` dotted
  with the (log-normalised) logits, the Pallas function's signature;
- :func:`two_hot_symlog_loss_lse`: the same over the head's raw logits, the
  log-normalisation fused in: what the distribution's ``log_prob`` calls;
- :func:`two_hot_symexp_decode`: ``(..., K) -> (..., 1)``, the softmax
  expectation over the bins, symexp'd back; :func:`two_hot_mean` calls it on
  the head's raw logits (the distribution's ``mean``).

On CPU tensors each wrapper runs its plain version (``*_reference``, a
literal copy of the JAX package's ops, the log-normalisation included). On
CUDA tensors it launches the hand-written kernel ``csrc/two_hot.cu`` (built
at first use, see :mod:`._build`) or raises; nothing substitutes the plain
version on the card. :func:`two_hot_symlog_loss_lse` has a backward kernel
too (``LAUNCHES["two_hot_symlog_loss_lse_bwd"]``), one pass over the logits
with the forward's row log-sum-exps saved; its plain version is
:func:`two_hot_symlog_loss_lse_grad_reference`. The other two re-derive the
plain chain for their gradients, as the JAX package's ``custom_vjp``s do.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.ops.core import symexp, symlog
from sheeprl_tpu_torch.ops.kernels import _build, count_launch

__all__ = [
    "two_hot_symlog_loss",
    "two_hot_symlog_loss_reference",
    "two_hot_symlog_loss_lse",
    "two_hot_symlog_loss_lse_reference",
    "two_hot_symlog_loss_lse_grad_reference",
    "two_hot_symexp_decode",
    "two_hot_symexp_decode_reference",
    "two_hot_mean",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _two_hot_target(logits: torch.Tensor, value: torch.Tensor, low: float, high: float):
    """The two-hot target ``(..., K)`` of ``symlog(value)`` and its two
    weights ``(..., 1)``: the JAX package's ops, in its order."""
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
    return target, weight_below, weight_above


def two_hot_symlog_loss_reference(
    logits: torch.Tensor, value: torch.Tensor, low: float = -20.0, high: float = 20.0
) -> torch.Tensor:
    """``TwoHotEncodingDistribution.log_prob`` for the default transforms:
    ``logits`` are the log-normalised logits ``(..., K)``, ``value`` the
    raw-space target ``(..., 1)``."""
    target, _, _ = _two_hot_target(logits, value, low, high)
    return torch.sum(target * logits, dim=-1)


def two_hot_symlog_loss_lse_reference(
    logits: torch.Tensor, value: torch.Tensor, low: float = -20.0, high: float = 20.0
) -> torch.Tensor:
    """:func:`two_hot_symlog_loss_reference` over the head's raw logits: the
    log-normalisation first, as the JAX distribution's constructor takes it."""
    return two_hot_symlog_loss_reference(logits - torch.logsumexp(logits, dim=-1, keepdim=True), value, low, high)


def two_hot_symlog_loss_lse_grad_reference(
    logits: torch.Tensor, value: torch.Tensor, lse: torch.Tensor, grad: torch.Tensor,
    low: float = -20.0, high: float = 20.0,
) -> torch.Tensor:
    """The gradient of :func:`two_hot_symlog_loss_lse_reference` for the raw
    logits, given the rows' log-sum-exps ``lse`` and the upstream gradient
    ``grad`` (both ``(...,)``): ``grad * (t - exp(logits - lse) * (w_below +
    w_above))``, ``t`` the two-hot target. What autograd of the plain chain
    gives, through the subtraction of ``lse``."""
    target, weight_below, weight_above = _two_hot_target(logits, value, low, high)
    probs = torch.exp(logits - lse[..., None].to(logits.dtype))
    return (grad[..., None] * (target - probs * (weight_below + weight_above))).to(logits.dtype)


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
        i64, ptr, f32, i32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        loss.argtypes = [ptr, ptr, ptr, i64, i64, f32, f32, i32, ptr]
        lib.two_hot_symlog_loss_lse_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i64, f32, f32, i32, ptr]
        lib.two_hot_symlog_loss_lse_bwd_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, f32, f32, i32, ptr]
        decode.argtypes = [ptr, ptr, i64, i64, f32, f32, i32, ptr]
        for fn in (loss, lib.two_hot_symlog_loss_lse_launch, lib.two_hot_symlog_loss_lse_bwd_launch, decode):
            fn.restype = i32
        lib.two_hot_symexp_decode_max_bins.argtypes = []
        lib.two_hot_symexp_decode_max_bins.restype = i32
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


def _targets(name: str, logits: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` as the kernels read it: one contiguous float32 target per row."""
    _check_logits(name, logits)
    if value.device != logits.device:
        raise ValueError(f"{name} kernel needs value on {logits.device}, got {value.device}")
    lead = tuple(logits.shape[:-1])
    try:
        target = value.expand(*lead, 1)
    except RuntimeError as e:
        raise ValueError(f"value {tuple(value.shape)} does not broadcast to {lead + (1,)}") from e
    # the main path hands in contiguous float32 (..., 1) targets: both calls are no-ops there
    return target.to(torch.float32).contiguous()


def _check_bins(name: str, lib: ctypes.CDLL, logits: torch.Tensor) -> None:
    max_bins = lib.two_hot_symexp_decode_max_bins()  # the kernels keep a row in registers
    if logits.shape[-1] > max_bins:
        raise ValueError(f"{name} kernel takes at most {max_bins} bins, got {logits.shape[-1]}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")


def _launch_loss(logits: torch.Tensor, value: torch.Tensor, low: float, high: float) -> torch.Tensor:
    target = _targets("two_hot_symlog_loss", logits, value)
    out = torch.empty(logits.shape[:-1], dtype=logits.dtype, device=logits.device)
    err = _library().two_hot_symlog_loss_launch(
        logits.data_ptr(), target.data_ptr(), out.data_ptr(), out.numel(), logits.shape[-1], float(low), float(high),
        _DTYPE_CODES[logits.dtype], _stream(logits),
    )
    _raise_on(err, "two_hot_symlog_loss")
    count_launch("two_hot_symlog_loss")
    return out


def _launch_loss_lse(
    logits: torch.Tensor, value: torch.Tensor, low: float, high: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch: the log-probs ``(...,)`` in the logits' dtype and the rows'
    float32 log-sum-exps ``(...,)``, which the backward takes."""
    target = _targets("two_hot_symlog_loss_lse", logits, value)
    lib = _library()
    _check_bins("two_hot_symlog_loss_lse", lib, logits)
    out = torch.empty(logits.shape[:-1], dtype=logits.dtype, device=logits.device)
    lse = torch.empty(logits.shape[:-1], dtype=torch.float32, device=logits.device)
    err = lib.two_hot_symlog_loss_lse_launch(
        logits.data_ptr(), target.data_ptr(), out.data_ptr(), lse.data_ptr(), out.numel(), logits.shape[-1],
        float(low), float(high), _DTYPE_CODES[logits.dtype], _stream(logits),
    )
    _raise_on(err, "two_hot_symlog_loss_lse")
    count_launch("two_hot_symlog_loss_lse")
    return out, lse


def _launch_loss_lse_bwd(
    logits: torch.Tensor, value: torch.Tensor, lse: torch.Tensor, grad: torch.Tensor, low: float, high: float
) -> torch.Tensor:
    """One launch: the gradient for the logits, ``(..., K)`` in their dtype."""
    target = _targets("two_hot_symlog_loss_lse_bwd", logits, value)
    lib = _library()
    _check_bins("two_hot_symlog_loss_lse_bwd", lib, logits)
    lead = tuple(logits.shape[:-1])
    if tuple(lse.shape) != lead or lse.dtype != torch.float32 or lse.device != logits.device:
        raise ValueError(f"two_hot_symlog_loss_lse_bwd kernel wants a float32 lse {lead} on {logits.device}, "
                         f"got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if tuple(grad.shape) != lead or grad.device != logits.device:
        raise ValueError(f"two_hot_symlog_loss_lse_bwd kernel wants a gradient {lead} on {logits.device}, "
                         f"got {tuple(grad.shape)} on {grad.device}")
    # autograd hands in a gradient of the output's dtype, often expanded from a reduction's
    grad = grad.to(logits.dtype).contiguous()
    lse = lse.contiguous()
    out = torch.empty_like(logits)
    err = lib.two_hot_symlog_loss_lse_bwd_launch(
        logits.data_ptr(), target.data_ptr(), lse.data_ptr(), grad.data_ptr(), out.data_ptr(), lse.numel(),
        logits.shape[-1], float(low), float(high), _DTYPE_CODES[logits.dtype], _stream(logits),
    )
    _raise_on(err, "two_hot_symlog_loss_lse_bwd")
    count_launch("two_hot_symlog_loss_lse_bwd")
    return out


def _launch_decode(logits: torch.Tensor, low: float, high: float) -> torch.Tensor:
    _check_logits("two_hot_symexp_decode", logits)
    k, lib = logits.shape[-1], _library()
    _check_bins("two_hot_symexp_decode", lib, logits)
    out = torch.empty((*logits.shape[:-1], 1), dtype=logits.dtype, device=logits.device)
    err = lib.two_hot_symexp_decode_launch(
        logits.data_ptr(), out.data_ptr(), out.numel(), k, float(low), float(high), _DTYPE_CODES[logits.dtype],
        _stream(logits),
    )
    _raise_on(err, "two_hot_symexp_decode")
    count_launch("two_hot_symexp_decode")
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
        logits, value = ctx.saved_tensors
        low, high = ctx.bounds
        fn = lambda lg, v: two_hot_symlog_loss_reference(lg, v, low, high)  # noqa: E731
        return (*_plain_grads(fn, (logits, value), grad, ctx.needs_input_grad[:2]), None, None)


class _TwoHotSymlogLossLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits: torch.Tensor, value: torch.Tensor, low: float, high: float) -> torch.Tensor:
        out, lse = _launch_loss_lse(logits, value, low, high)
        ctx.save_for_backward(logits, value, lse)
        ctx.bounds = (low, high)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        logits, value, lse = ctx.saved_tensors
        low, high = ctx.bounds
        grad_logits = grad_value = None
        if ctx.needs_input_grad[0]:
            grad_logits = _launch_loss_lse_bwd(logits, value, lse, grad, low, high)
        if ctx.needs_input_grad[1]:  # no call of the main path asks for it: the plain chain's, as in the JAX bwd
            fn = lambda v: two_hot_symlog_loss_lse_reference(logits, v, low, high)  # noqa: E731
            (grad_value,) = _plain_grads(fn, (value,), grad, (True,))
        return grad_logits, grad_value, None, None


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


def two_hot_symlog_loss_lse(
    logits: torch.Tensor, value: torch.Tensor, low: float = -20.0, high: float = 20.0
) -> torch.Tensor:
    """Two-hot/symlog log-probability ``(..., K) x (..., 1) -> (...,)`` over
    the head's raw logits, their log-normalisation fused in: the plain
    version for CPU tensors, the CUDA kernel (and its backward kernel) for
    CUDA tensors; anything else raises."""
    if logits.device.type == "cpu" and value.device.type == "cpu":
        return two_hot_symlog_loss_lse_reference(logits, value, low, high)
    return _TwoHotSymlogLossLse.apply(logits, value, float(low), float(high))


def two_hot_symexp_decode(logits: torch.Tensor, low: float = -20.0, high: float = 20.0) -> torch.Tensor:
    """Two-hot mean decode ``(..., K) -> (..., 1)``: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors; anything else raises."""
    if logits.device.type == "cpu":
        return two_hot_symexp_decode_reference(logits, low, high)
    return _TwoHotSymexpDecode.apply(logits, float(low), float(high))


def two_hot_mean(logits: torch.Tensor, low: float = -20.0, high: float = 20.0) -> torch.Tensor:
    """The two-hot distribution's mean ``(..., K) -> (..., 1)`` from the
    head's raw logits: on CPU tensors the plain decode of the log-normalised
    logits (the JAX package's ops); on CUDA tensors the decode kernel on the
    raw logits, whose softmax takes the row max out itself, so the
    normalisation would change nothing but rounding."""
    if logits.device.type == "cpu":
        return two_hot_symexp_decode_reference(logits - torch.logsumexp(logits, dim=-1, keepdim=True), low, high)
    return _TwoHotSymexpDecode.apply(logits, float(low), float(high))
