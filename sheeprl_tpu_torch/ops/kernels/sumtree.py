"""Fused prioritized-replay draw: a ``(2P,)`` float32 sum-tree and ``(B,)``
uniforms -> ``(leaf (B,) int32, unnormalized IS weights (B,) float32)``
(counterpart of ``sheeprl_tpu/ops/kernels/sumtree.py``).

:func:`sumtree_sample_reference` is the plain version, the JAX package's
two-pass chain: :func:`~sheeprl_tpu_torch.replay.sumtree.sample`, then
:func:`~sheeprl_tpu_torch.replay.sumtree.importance_weights`. On CPU tensors
:func:`sumtree_sample` runs it. On CUDA tensors it launches the hand-written
kernel ``csrc/sumtree.cu`` (built at first use, see :mod:`._build`) or
raises; nothing substitutes the plain version on the card. ``n_valid`` and
``beta`` are host numbers, passed to the kernel by value. The kernel runs a
warp per draw and settles :data:`HOP_LEVELS` levels of the tree per
dependent read (see the source's header); the tree must start 16-byte
aligned, as every tensor PyTorch allocates does.

The gradient is the plain chain's, as the JAX package's ``custom_vjp``
re-derives it from its lax reference: the leaves are integers and carry
none; the weights differentiate with respect to the tree. ``n_valid`` and
``beta`` are not tensors here, so they carry none. SAC never differentiates
the weights.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.ops.kernels import _build, count_launch
from sheeprl_tpu_torch.replay import sumtree as st

__all__ = ["sumtree_sample", "sumtree_sample_reference", "HOP_LEVELS"]

#: tree levels the kernel settles per dependent read (k in 1..10): the best
#: of chip_smoke.py's sweep at the SAC shape (2^20 leaves, 256 draws) on an
#: H100, recorded in PERF.md
HOP_LEVELS = 7


def sumtree_sample_reference(
    tree: torch.Tensor, u: torch.Tensor, n_valid: float, beta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Proportional descent, then the unnormalized PER importance weights of
    the drawn leaves."""
    leaf = st.sample(tree, u)
    return leaf, st.importance_weights(tree, leaf, n_valid, beta)


def _library() -> ctypes.CDLL:
    lib = _build.load("sumtree")
    fn = lib.sumtree_sample_launch
    if fn.argtypes is None:  # ctypes would pass each pointer as a 32-bit int
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    return lib


def _check(tree: torch.Tensor, u: torch.Tensor) -> None:
    for name, t in (("tree", tree), ("u", u)):
        if t.device.type != "cuda" or t.device != tree.device:
            raise ValueError(f"sumtree_sample kernel needs tree and u on one CUDA device, got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"sumtree_sample kernel takes float32 {name}, got {t.dtype}")
        if t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"sumtree_sample kernel needs a contiguous 1-D {name}, got shape {tuple(t.shape)}")
    nodes = tree.shape[0]
    if nodes < 2 or nodes & (nodes - 1):
        raise ValueError(f"sumtree_sample kernel wants a (2P,) tree with P a power of two, got {nodes} nodes")
    if tree.data_ptr() % 16:
        raise ValueError("sumtree_sample kernel reads the tree in 16-byte pieces: it must start 16-byte aligned")


def _launch(
    tree: torch.Tensor, u: torch.Tensor, n_valid: float, beta: float, hop_levels: int = HOP_LEVELS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch; ``hop_levels`` other than :data:`HOP_LEVELS` only for
    chip_smoke.py's sweep."""
    _check(tree, u)
    leaves = tree.shape[0] // 2
    leaf = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    weights = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = _library().sumtree_sample_launch(
        tree.data_ptr(), u.data_ptr(), leaf.data_ptr(), weights.data_ptr(), u.shape[0], leaves,
        leaves.bit_length() - 1, float(np.float32(n_valid)), float(np.float32(beta)), int(hop_levels), stream,
    )
    if err != 0:
        raise RuntimeError(f"sumtree_sample kernel launch failed with cudaError {err}")
    count_launch("sumtree_sample")
    return leaf, weights


class _SumtreeSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tree, u, n_valid: float, beta: float):
        leaf, weights = _launch(tree, u, n_valid, beta)
        ctx.save_for_backward(tree, leaf)
        ctx.scalars = (n_valid, beta)
        ctx.mark_non_differentiable(leaf)
        return leaf, weights

    @staticmethod
    def backward(ctx, _grad_leaf, grad_weights):
        tree, leaf = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        with torch.enable_grad():
            t = tree.detach().requires_grad_(True)
            weights = st.importance_weights(t, leaf, *ctx.scalars)
            (g_tree,) = torch.autograd.grad(weights, (t,), grad_weights)
        return g_tree, None, None, None


def sumtree_sample(
    tree: torch.Tensor, u: torch.Tensor, n_valid: float, beta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(leaf, weights)``: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors; anything else raises."""
    if tree.device.type == "cpu" and u.device.type == "cpu":
        return sumtree_sample_reference(tree, u, n_valid, beta)
    return _SumtreeSample.apply(tree, u, float(n_valid), float(beta))
