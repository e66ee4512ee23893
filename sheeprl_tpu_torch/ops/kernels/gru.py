"""The Hafner-GRU gate chain: ``(B, 3H) x (B, H) -> (B, H)``, the pointwise
tail of every RSSM step (counterpart of ``sheeprl_tpu/ops/kernels/gru.py``).

- :func:`gru_gates`: the gate chain on an already normalised projection
  (``LayerNormGRUCell(layer_norm=False)``);
- :func:`gru_gates_ln`: the projection's LayerNorm over the 3H axis, with
  its ``(3H,)`` affine, and then the gate chain, in one kernel: the whole
  epilogue of the cell's GEMM, as the RSSM's cell runs it.

Both take float32 or bfloat16 inputs of one dtype and return that dtype.
The gate math is float32 either way and the output is rounded once, as the
Pallas kernel computes. :func:`gru_gates_ln` takes the LayerNorm's affine in
float32 (the parameter dtype) under both: in bfloat16 the normalised
projection is computed in float32 with float32 statistics and rounded to
bfloat16 before the gates, as flax's ``LayerNorm(dtype=bfloat16)`` hands the
Pallas kernel its input. It also takes a bfloat16 projection over a float32
carry and then returns float32, as the Pallas kernel writes the carry's
dtype: a player's or a serving session's carry starts from the float32
initial state and stays float32, in both packages.

On CPU tensors each wrapper runs its plain version (``*_reference``). On
CUDA tensors it launches the hand-written kernel ``csrc/gru_gates.cu``
(built at first use, see :mod:`._build`) or raises; nothing substitutes the
plain version on the card, and a dtype mix the kernel does not take raises
on both devices. The gradient is the plain chain re-derived in the input
dtype, as the JAX package's ``custom_vjp`` differentiates its jnp chain:
neither package has a backward kernel. :func:`gru_gates_ln`'s forward saves
only its inputs, so its backward recomputes the LayerNorm before it
differentiates. Both count their launches under ``LAUNCHES["gru_gates"]``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.ops.core import layer_norm
from sheeprl_tpu_torch.ops.kernels import _build, count_launch

__all__ = ["gru_gates", "gru_gates_reference", "gru_gates_ln", "gru_gates_ln_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: (projection, carry) dtypes :func:`gru_gates_ln` takes
_LN_DTYPE_CODES = {
    (torch.float32, torch.float32): (0, 0),
    (torch.bfloat16, torch.bfloat16): (1, 1),
    (torch.bfloat16, torch.float32): (1, 0),
}


def _gate_chain(fused: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The gate chain, one op at a time in the input dtype (the backward's
    body, as the JAX package's ``_bwd`` differentiates its jnp chain)."""
    reset, cand, update = torch.chunk(fused, 3, dim=-1)
    reset = torch.sigmoid(reset)
    cand = torch.tanh(reset * cand)
    update = torch.sigmoid(update - 1)
    return update * cand + (1 - update) * h


def _check_dtypes(fused: torch.Tensor, h: torch.Tensor) -> None:
    if h.dtype not in _DTYPE_CODES or fused.dtype != h.dtype:
        raise TypeError(f"gru_gates takes float32 or bfloat16 inputs of one dtype, got {fused.dtype}, {h.dtype}")


def _check_ln_dtypes(proj: torch.Tensor, h: torch.Tensor) -> None:
    if (proj.dtype, h.dtype) not in _LN_DTYPE_CODES:
        raise TypeError(
            "gru_gates_ln takes a float32 or bfloat16 projection and carry of one dtype, or a bfloat16 "
            f"projection over a float32 carry, got {proj.dtype}, {h.dtype}"
        )


def _check_affine(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"gru_gates_ln takes a float32 {name} (the parameter dtype), got {t.dtype}")


def gru_gates_reference(fused: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The kernel's result in plain ops: the gate chain in float32, rounded
    once to the inputs' dtype (ground truth)."""
    _check_dtypes(fused, h)
    if h.dtype == torch.float32:
        return _gate_chain(fused, h)
    return _gate_chain(fused.float(), h.float()).to(h.dtype)


def _ln_chain(proj: torch.Tensor, h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The LayerNorm, then :func:`_gate_chain` in the input dtype (the
    backward's body)."""
    if proj.dtype == torch.float32:
        return _gate_chain(F.layer_norm(proj, (proj.shape[-1],), weight, bias, eps), h)
    return _gate_chain(layer_norm(proj, weight, bias, eps, proj.dtype), h)


def gru_gates_ln_reference(
    proj: torch.Tensor, h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """The kernel's result in plain ops (ground truth): in float32 the plain
    LayerNorm over the 3H axis, then the gate chain; with a bfloat16
    projection the normalised projection of
    :func:`~sheeprl_tpu_torch.ops.core.layer_norm` (float32 statistics and
    affine, rounded to bfloat16), then the gate chain in float32, rounded
    once to the carry's dtype."""
    _check_ln_dtypes(proj, h)
    _check_affine(h, weight, bias)
    if proj.dtype == torch.float32:
        return _ln_chain(proj, h, weight, bias, eps)
    y = layer_norm(proj, weight, bias, eps, proj.dtype)
    return _gate_chain(y.float(), h.float()).to(h.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("gru_gates")
    fn = lib.gru_gates_launch
    if fn.argtypes is None:  # ctypes would pass each pointer as a 32-bit int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    fn = lib.gru_gates_ln_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(fused: torch.Tensor, h: torch.Tensor) -> None:
    if fused.device != h.device or fused.device.type != "cuda":
        raise ValueError(f"gru_gates kernel needs both inputs on one CUDA device, got {fused.device} and {h.device}")
    _check_dtypes(fused, h)
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
    count_launch("gru_gates")
    return out


class _GruGates(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fused: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(fused, h)
        if fused.device.type == "cpu" and h.device.type == "cpu":
            return gru_gates_reference(fused, h)
        return _launch(fused, h)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        fused, h = ctx.saved_tensors
        with torch.enable_grad():
            f = fused.detach().requires_grad_(True)
            hh = h.detach().requires_grad_(True)
            out = _gate_chain(f, hh)
        return torch.autograd.grad(out, (f, hh), grad)


def gru_gates(fused: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Fused GRU gate chain: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors; anything else raises. Below float32 the
    gradient is the chain's in the input dtype on both devices."""
    if fused.device.type == "cpu" and h.device.type == "cpu" and h.dtype == torch.float32:
        return gru_gates_reference(fused, h)
    return _GruGates.apply(fused, h)


def _check_ln(proj: torch.Tensor, h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    if proj.device != h.device or proj.device.type != "cuda":
        raise ValueError(f"gru_gates_ln kernel needs every input on one CUDA device, got {proj.device} and {h.device}")
    _check_ln_dtypes(proj, h)
    if h.ndim != 2 or proj.shape != (h.shape[0], 3 * h.shape[1]):
        raise ValueError(f"gru_gates_ln kernel wants proj (B, 3H) and h (B, H), got {tuple(proj.shape)}, {tuple(h.shape)}")
    if not (proj.is_contiguous() and h.is_contiguous()):
        raise ValueError("gru_gates_ln kernel needs contiguous inputs")
    _check_affine(h, weight, bias)
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != h.device:
            raise ValueError(f"gru_gates_ln kernel needs every input on one CUDA device, got {name} on {t.device}")
        if t.shape != (proj.shape[1],) or not t.is_contiguous():
            raise ValueError(f"gru_gates_ln kernel wants a contiguous ({proj.shape[1]},) {name}, got {tuple(t.shape)}")


def _launch_ln(proj: torch.Tensor, h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    _check_ln(proj, h, weight, bias)
    B, H = h.shape
    out = torch.empty_like(h)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = _library().gru_gates_ln_launch(
        proj.data_ptr(), h.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, float(eps),
        *_LN_DTYPE_CODES[(proj.dtype, h.dtype)], stream,
    )
    if err != 0:
        raise RuntimeError(f"gru_gates_ln kernel launch failed with cudaError {err}")
    count_launch("gru_gates")
    return out


class _GruGatesLn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, proj, h, weight, bias, eps: float) -> torch.Tensor:
        ctx.save_for_backward(proj, h, weight, bias)
        ctx.eps = eps
        if all(t.device.type == "cpu" for t in (proj, h, weight, bias)):
            return gru_gates_ln_reference(proj, h, weight, bias, eps)
        return _launch_ln(proj, h, weight, bias, eps)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        needs = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = _ln_chain(*leaves, ctx.eps)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
        return (*(next(grads) if n else None for n in needs), None)


def gru_gates_ln(
    proj: torch.Tensor, h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """LayerNorm of the ``(B, 3H)`` projection (``weight``, ``bias``: its
    float32 ``(3H,)`` affine), then the GRU gate chain with the carry ``h``
    (``proj`` and ``h`` float32, both bfloat16, or a bfloat16 ``proj`` over
    a float32 ``h``; the output has ``h``'s dtype): the plain version for CPU
    tensors, one CUDA kernel for CUDA tensors; anything else raises. Below
    float32 the gradient is the LayerNorm's and the chain's in the input
    dtype on both devices."""
    if all(t.device.type == "cpu" for t in (proj, h, weight, bias)) and proj.dtype == torch.float32:
        return gru_gates_ln_reference(proj, h, weight, bias, eps)
    return _GruGatesLn.apply(proj, h, weight, bias, float(eps))
