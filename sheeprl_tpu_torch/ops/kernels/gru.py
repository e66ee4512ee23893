"""The Hafner-GRU gate chain: ``(B, 3H) x (B, H) -> (B, H)``, the pointwise
tail of every RSSM step (counterpart of ``sheeprl_tpu/ops/kernels/gru.py``).

On CPU tensors :func:`gru_gates` runs :func:`gru_gates_reference`. On CUDA
tensors it launches the hand-written kernel ``csrc/gru_gates.cu`` (built at
first use, see :mod:`._build`) or raises; nothing substitutes the plain
version on the card. The gradient is the reference chain re-derived, as the
JAX package's ``custom_vjp`` does: neither package has a backward kernel.
"""

from __future__ import annotations

import ctypes

import torch

from sheeprl_tpu_torch.ops.kernels import LAUNCHES, _build

__all__ = ["gru_gates", "gru_gates_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def gru_gates_reference(fused: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The plain gate chain, in the input dtype (ground truth and backward body)."""
    reset, cand, update = torch.chunk(fused, 3, dim=-1)
    reset = torch.sigmoid(reset)
    cand = torch.tanh(reset * cand)
    update = torch.sigmoid(update - 1)
    return update * cand + (1 - update) * h


def _library() -> ctypes.CDLL:
    lib = _build.load("gru_gates")
    fn = lib.gru_gates_launch
    if fn.argtypes is None:  # ctypes would pass each pointer as a 32-bit int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(fused: torch.Tensor, h: torch.Tensor) -> None:
    if fused.device != h.device or fused.device.type != "cuda":
        raise ValueError(f"gru_gates kernel needs both inputs on one CUDA device, got {fused.device} and {h.device}")
    if h.dtype not in _DTYPE_CODES or fused.dtype != h.dtype:
        raise TypeError(f"gru_gates kernel takes float32 or bfloat16 inputs of one dtype, got {fused.dtype}, {h.dtype}")
    if h.ndim != 2 or fused.shape != (h.shape[0], 3 * h.shape[1]):
        raise ValueError(f"gru_gates kernel wants fused (B, 3H) and h (B, H), got {tuple(fused.shape)}, {tuple(h.shape)}")
    if not (fused.is_contiguous() and h.is_contiguous()):
        raise ValueError("gru_gates kernel needs contiguous inputs")


def _launch(fused: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    _check(fused, h)
    B, H = h.shape
    out = torch.empty_like(h)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = _library().gru_gates_launch(
        fused.data_ptr(), h.data_ptr(), out.data_ptr(), B, H, 3 * H, _DTYPE_CODES[h.dtype], stream
    )
    if err != 0:
        raise RuntimeError(f"gru_gates kernel launch failed with cudaError {err}")
    LAUNCHES["gru_gates"] += 1
    return out


class _GruGates(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fused: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(fused, h)
        return _launch(fused, h)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        fused, h = ctx.saved_tensors
        with torch.enable_grad():
            f = fused.detach().requires_grad_(True)
            hh = h.detach().requires_grad_(True)
            out = gru_gates_reference(f, hh)
        return torch.autograd.grad(out, (f, hh), grad)


def gru_gates(fused: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Fused GRU gate chain: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors; anything else raises."""
    if fused.device.type == "cpu" and h.device.type == "cpu":
        return gru_gates_reference(fused, h)
    return _GruGates.apply(fused, h)
