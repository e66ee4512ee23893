"""Ragged multi-head ring scatter: the device sequence ring's per-env-head
append (counterpart of ``sheeprl_tpu/ops/kernels/scatter.py``).

Slot ``(s, j)`` of a staged ``(S, e, ...)`` block lands at
``storage[row[s, j], col_offset + j]``, where ``row`` is the per-env ragged
pack of :func:`sheeprl_tpu_torch.data.ring.ring_append_rows` and dropped or
padded slots carry ``row == capacity``. The ring is updated in place and
returned, as the Pallas version aliases it.

:func:`ragged_ring_scatter_reference` is the plain version, the JAX
package's lax reference: the literal masked scatter. On CPU tensors
:func:`ragged_ring_scatter` runs it. On CUDA tensors it launches the
hand-written kernel ``csrc/ring_scatter.cu`` (built at first use, see
:mod:`._build`) or raises; nothing substitutes the plain version on the
card. The wrapper reads nothing back from the card, so a CUDA graph can
capture it. ``pos`` (the heads before the append) is in the signature for
parity: only the Pallas version needs it, to park dropped slots.

Preconditions, checked on the card path: ``staged.dtype == storage.dtype``,
``capacity == storage.shape[0]`` (the drop marker), ``col_offset + e`` within
the ring's env columns, contiguous tensors on one device.

The gradient is the plain scatter's, as the JAX package's ``custom_vjp``
re-derives it from its lax reference (float dtypes only; the ring's uint8
pixels are never differentiated): ``d_storage`` is the incoming gradient
with the written slots zeroed, ``d_staged`` the incoming gradient read back
at the written slots and 0 at dropped ones.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sheeprl_tpu_torch.ops.kernels import LAUNCHES, _build

__all__ = ["ragged_ring_scatter", "ragged_ring_scatter_reference"]


def _slots(storage: torch.Tensor, row: torch.Tensor, col_offset: int):
    """The written slots' mask, and each slot's ring column."""
    S, e = row.shape
    cols = col_offset + torch.arange(e, device=row.device).expand(S, e)
    return row < storage.shape[0], cols


def ragged_ring_scatter_reference(
    storage: torch.Tensor, staged: torch.Tensor, row: torch.Tensor, pos: torch.Tensor, col_offset: int = 0
) -> torch.Tensor:
    """The literal masked scatter ``storage[row[m], cols[m]] = staged[m]``
    with ``m = row < capacity``, in place; returns ``storage``."""
    del pos
    m, cols = _slots(storage, row, int(col_offset))
    storage[row[m].long(), cols[m]] = staged[m]
    return storage


def _scatter_vjp(g: torch.Tensor, row: torch.Tensor, col_offset: int, staged_shape) -> tuple:
    m, cols = _slots(g, row, col_offset)
    r, c = row[m].long(), cols[m]
    d_storage = g.clone()
    d_storage[r, c] = 0
    d_staged = g.new_zeros(staged_shape)
    d_staged[m] = g[r, c]
    return d_storage, d_staged


def _library() -> ctypes.CDLL:
    lib = _build.load("ring_scatter")
    fn = lib.ragged_ring_scatter_launch
    if fn.argtypes is None:  # ctypes would pass each pointer as a 32-bit int
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, ptr]
        fn.restype = ctypes.c_int
    return lib


def _check(storage: torch.Tensor, staged: torch.Tensor, row: torch.Tensor, col_offset: int) -> None:
    for name, t in (("storage", storage), ("staged", staged), ("row", row)):
        if t.device.type != "cuda" or t.device != storage.device:
            raise ValueError(f"ragged_ring_scatter kernel needs every tensor on one CUDA device, got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ragged_ring_scatter kernel needs a contiguous {name}")
    if staged.dtype != storage.dtype:
        raise TypeError(f"ragged_ring_scatter kernel: staged is {staged.dtype}, the ring {storage.dtype}")
    if row.dtype != torch.int32 or row.ndim != 2:
        raise TypeError(f"ragged_ring_scatter kernel takes (S, e) int32 rows, got {row.dtype} {tuple(row.shape)}")
    if storage.ndim < 2 or tuple(staged.shape) != tuple(row.shape) + tuple(storage.shape[2:]):
        raise ValueError(
            f"ragged_ring_scatter kernel: staged {tuple(staged.shape)} is not rows {tuple(row.shape)} of the "
            f"ring's {tuple(storage.shape[2:])} slots"
        )
    if col_offset < 0 or col_offset + row.shape[1] > storage.shape[1]:
        raise ValueError(
            f"ragged_ring_scatter kernel: columns {col_offset}..{col_offset + row.shape[1]} outside the ring's "
            f"{storage.shape[1]}"
        )
    if storage.shape[0] >= 2**31:
        raise ValueError(f"ragged_ring_scatter kernel: a capacity of {storage.shape[0]} rows does not fit int32 rows")


def _launch(storage: torch.Tensor, staged: torch.Tensor, row: torch.Tensor, col_offset: int) -> None:
    _check(storage, staged, row, col_offset)
    slot_bytes = int(np.prod(storage.shape[2:])) * storage.element_size()
    stream = torch.cuda.current_stream(storage.device).cuda_stream
    err = _library().ragged_ring_scatter_launch(
        storage.data_ptr(), staged.data_ptr(), row.data_ptr(), storage.shape[0], storage.shape[1],
        row.shape[0], row.shape[1], col_offset, slot_bytes, stream,
    )
    if err != 0:
        raise RuntimeError(f"ragged_ring_scatter kernel launch failed with cudaError {err}")
    LAUNCHES["ragged_ring_scatter"] += 1


class _RaggedRingScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, storage, staged, row, pos, col_offset: int):
        _launch(storage, staged, row, col_offset)
        ctx.mark_dirty(storage)
        ctx.save_for_backward(row)
        ctx.col_offset, ctx.staged_shape = col_offset, staged.shape
        return storage

    @staticmethod
    def backward(ctx, g):
        (row,) = ctx.saved_tensors
        d_storage, d_staged = _scatter_vjp(g, row, ctx.col_offset, ctx.staged_shape)
        return (
            d_storage if ctx.needs_input_grad[0] else None,
            d_staged if ctx.needs_input_grad[1] else None,
            None,
            None,
            None,
        )


def ragged_ring_scatter(
    storage: torch.Tensor, staged: torch.Tensor, row: torch.Tensor, pos: torch.Tensor, col_offset: int = 0
) -> torch.Tensor:
    """``(C, E, ...) x (S, e, ...) x (S, e) rows -> (C, E, ...)`` in place
    (``row == C`` slots are dropped): the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors; anything else raises."""
    if storage.device.type == "cpu" and staged.device.type == "cpu" and row.device.type == "cpu":
        return ragged_ring_scatter_reference(storage, staged, row, pos, col_offset)
    return _RaggedRingScatter.apply(storage, staged, row, pos, int(col_offset))
